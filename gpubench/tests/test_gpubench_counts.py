"""The count functions against the bounds the repository's kernel table
gives (H100 peaks: 989 TFLOP/s bf16, 67 TFLOP/s f32) and against the
program's own model-FLOP arithmetic."""

import pytest

from gpubench import counts


@pytest.mark.parametrize("what,shape,want_ms", [
    ("K1 bf16 B16 S1800 W768", counts.attention_fwd(16, 1800, 768, "bf16"), 0.1610),
    ("K3 bf16 B16 S4000 W768", counts.attention_fwd(16, 4000, 768, "bf16"), 0.7952),
    ("K5 bf16 B128 S600 W768", counts.attention_bwd(128, 600, 768, "bf16"), 0.3578),
])
def test_attention_bounds(what, shape, want_ms):
    ops, nbytes = shape
    assert round(counts.bound_s(ops, nbytes, "bf16") * 1e3, 4) == want_ms, what


def test_chamfer_repeat_bound():
    ops, nbytes = counts.chamfer(3000, 1000, 2000)
    assert round(counts.bound_s(ops, nbytes, "f32") * 1e3, 2) == 1432.84


@pytest.mark.parametrize("batch,seq,streams,out", [
    (16, 60, (6,), 6), (16, 1800, (12, 6, 6, 6, 48), 18), (16, 960, (12, 6, 6, 6, 48), 18),
    (16, 4000, (6, 6, 48), 6), (128, 600, (12, 6, 6, 6, 48), 18)])
def test_model_flops_equal_the_programs(batch, seq, streams, out):
    from brepgen_tpu_torch.bench import denoiser_flops_per_eval

    assert counts.denoiser_flops_per_eval(batch, seq, streams, out) == \
        denoiser_flops_per_eval(batch, seq, streams, out)


def test_counter_counts_products():
    import torch

    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 16), device="meta")
    assert counts.model_flops(lambda: a @ b) == 2 * 4 * 8 * 16
