"""Two-rank work of the port's multi-GPU tests, over gloo (CPU, or one shared card).

Run as ``python tests/torch_port_dist.py --rank R --world 2 --init
file://PATH --out PREFIX [--device cuda]`` (the tests start both ranks);
each rank writes ``PREFIX.<rank>.pkl``. With ``--device cuda`` both ranks
share card 0 (still over gloo) and take the train steps only, at a head
width the kernels take. Imports torch and the port only. The same functions
give the tests their single-process references.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch
import torch.distributed as dist

from brepgen_tpu_torch import nn as tnn
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.parallel import make_mesh, replicate, sharding_rules
from brepgen_tpu_torch.parallel.distributed import RowSplit
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise, RowNoise
from brepgen_tpu_torch.train import ldm_train
from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer

SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=1)
CARD = dict(width=64, num_heads=2, ffn_width=128, num_layers=1)  # head width 32 on the card
STREAMS = ("surfpos", "surfz", "edgepos", "edgez")
B, NF, NE = 8, 5, 4
TP = dict(width=64, num_heads=4, ffn_width=128, num_layers=2)  # JAX's TP test size
TP_BATCH = (4, 6)
CASCADES = {  # name -> CascadeConfig fields (global batch 4)
    "ddim": dict(batch_size=4, num_surfaces=4, num_edges=3, fast_steps=4),
    "cf": dict(batch_size=4, num_surfaces=4, num_edges=3, fast_steps=4, use_cf=True,
               class_label=3),
    "compact": dict(batch_size=4, num_surfaces=4, num_edges=3, pndm_steps=10,
                    pos_pndm_calls=8, ddpm_tail=5, bbox_threshold=5.0, compact=True,
                    compact_granularity=2),
}


def step_batch(stage: str) -> dict:
    """A global batch whose halves hold different numbers of valid edges and
    faces (rows 0-3: few, rows 4-7: many)."""
    rng = np.random.default_rng(11)
    faces = np.array([1, 2, 1, 2, 5, 4, 5, 5])
    surf_mask = np.arange(NF)[None, :] >= faces[:, None]
    edges = rng.integers(1, NE + 1, size=(B, NF))
    edges[:4] = 1
    edge_mask = (np.arange(NE)[None, None, :] >= edges[:, :, None]) | surf_mask[:, :, None]
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    if stage == "surfpos":
        return {"surfpos": f(B, NF, 6)}
    return {"surfpos": f(B, NF, 6), "surfz": f(B, NF, 48), "edgepos": f(B, NF, NE, 6),
            "edgez": f(B, NF, NE, 12), "vertpos": f(B, NF, NE, 6),
            "surf_mask": torch.from_numpy(surf_mask), "edge_mask": torch.from_numpy(edge_mask)}


def train_step(stage: str, row_split=None, device: str = "cpu"):
    """One step of ``stage`` at the small width, dropout on, the edge stages
    through the kernels' entries (the plain versions on the CPU): (metrics,
    parameters after the step, clipped gradients read back from AdamW's
    first moment), on the CPU. Under a ``row_split`` this rank's rows of the
    batch go through DistributedDataParallel."""
    arch = SMALL if device == "cpu" else CARD
    attn = "kernel" if stage.startswith("edge") else "plain"
    model = seed_weights(getattr(tnn, f"make_{stage}_net")(attn_impl=attn, **arch),
                         torch.Generator().manual_seed(1)).to(device)
    state = TrainState(model, make_ldm_optimizer(model.parameters()))
    batch, net = {k: v.to(device) for k, v in step_batch(stage).items()}, model
    if row_split is not None:
        batch = {k: row_split.take(v) for k, v in batch.items()}
        model.encoder.row_split = row_split
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[0] if device == "cuda" else None, find_unused_parameters=False)
    step = ldm_train.make_step(stage, net, make_ddpm_tables(), row_split=row_split)
    metrics = step(state, batch, torch.Generator().manual_seed(7))
    moments = state.optimizer.adamw.state
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            {k: (moments[p]["exp_avg"] / (1 - 0.95)).cpu() for k, p in model.named_parameters()})


def tiny_port_models(use_cf: bool):
    """The tiny seeded cascade models of the sampling tests."""
    gen = torch.Generator().manual_seed(0)
    nets = {s: seed_weights(getattr(tnn, f"make_{s}_net")(
        use_cf=use_cf, attn_impl="kernel" if s.startswith("edge") else "plain", **SMALL),
        gen).eval() for s in STREAMS}
    return (nets, seed_weights(tnn.SurfVAE((4, 4, 4, 4)), gen).eval(),
            seed_weights(tnn.EdgeVAE((4, 4, 4)), gen).eval())


def run_cascade(name: str, row_split=None):
    """(outputs, bucket) of the tiny cascade ``name``; with a ``row_split``
    this rank's share of the batch."""
    fields = dict(CASCADES[name])
    if row_split is not None:
        fields["batch_size"] //= row_split.world
    c = Cascade(*tiny_port_models(fields.get("use_cf", False)), CascadeConfig(**fields),
                row_split=row_split)
    noise = GeneratorNoise(torch.Generator().manual_seed(5))
    out = c(noise if row_split is None else RowNoise(noise, row_split))
    return {k: v.numpy() for k, v in out.items()}, c.last_bucket


def run_sample_loop(row_split=None):
    """The sample CLI's batch loop on the tiny DDIM cascade until 6 samples
    (no postprocess): (the batches, seen from this rank, batches run)."""
    from brepgen_tpu_torch.cli.sample_main import sample_loop

    fields = dict(CASCADES["ddim"])
    if row_split is not None:
        fields["batch_size"] //= row_split.world
    c = Cascade(*tiny_port_models(False), CascadeConfig(**fields), row_split=row_split)
    run = sample_loop(c, num_samples=6, seed=9, postprocess=False)
    return run.batches


def tp_inputs():
    gen = torch.Generator().manual_seed(3)
    Bt, S = TP_BATCH
    x = torch.randn((Bt, S, 6), generator=gen)
    mask = torch.zeros((Bt, S), dtype=torch.bool)
    mask[1, 4:] = True
    return x, torch.tensor([0, 10, 500, 999]), mask


def tp_model():
    return seed_weights(tnn.make_surfpos_net(attn_impl="kernel", **TP),
                        torch.Generator().manual_seed(4)).eval()


def tensor_parallel(contiguous: bool = False):
    """The replicated forward and the forward split over the ``model`` axis
    of a (1, world) mesh; ``contiguous`` splits qkv's rows contiguously, as
    a plain column split of the flax kernel would."""
    mesh = make_mesh((1, dist.get_world_size()), device_type="cpu")
    model = replicate(tp_model(), mesh)
    x, t, mask = tp_inputs()
    with torch.no_grad():
        want = model((x,), t, mask)
        rows = sharding_rules.head_rows
        if contiguous:
            def rows(width, num_heads, rank, parts):
                n = 3 * width // parts
                return torch.arange(rank * n, (rank + 1) * n)
        saved, sharding_rules.head_rows = sharding_rules.head_rows, rows
        try:
            sharding_rules.shard_denoiser(model, mesh)
        finally:
            sharding_rules.head_rows = saved
        got = model((x,), t, mask)
    layer = model.encoder.layer_0
    return want.numpy(), got.numpy(), (layer.attn.qkv.weight.shape, layer.attn.num_heads,
                                       layer.fc1.weight.shape)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cpu")
    args = p.parse_args()
    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.world)
    split = RowSplit.of_group()
    if args.device == "cuda":
        out = {"train": {s: train_step(s, split, "cuda") for s in ("surfpos", "edgez")}}
    else:
        out = {
            "train": {stage: train_step(stage, split) for stage in ("surfpos", "edgez")},
            "cascade": {name: run_cascade(name, split) for name in CASCADES},
            "sample_loop": run_sample_loop(split),
            "tp": tensor_parallel(),
            "tp_contiguous": tensor_parallel(contiguous=True),
        }
    with open(f"{args.out}.{args.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
