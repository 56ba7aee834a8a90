"""Operations and bytes of the work each cell does, from its shapes, and the
published peaks of one NVIDIA H100 SXM (dense, 700 W) that shares of a
roofline or of the peak are taken against."""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bf16": 2, "f32": 4, "tf32": 4}

# streams (input widths) and output width of each denoiser
STAGE_STREAMS = {"surfpos": (6,), "surfz": (48, 6), "edgepos": (6, 6, 48),
                 "edgez": (12, 6, 6, 6, 48)}
STAGE_OUT = {"surfpos": 6, "surfz": 48, "edgepos": 6, "edgez": 18}


def denoiser_flops_per_eval(batch, seq, stream_dims: Sequence[int], out_dim, width=768,
                            ffn=1024, layers=12):
    """Matmul FLOPs of one denoiser forward. Per token per encoder layer: qkv
    6d^2 + proj 2d^2 + attention 4*S*d + FFN 4*d*f; each stream embedder and
    the head are Linear -> LN -> SiLU -> Linear (2*s*d + 2*d^2, head 2*d^2 +
    2*d*o); the time embedder and norms are left out. The arithmetic of
    ``brepgen_tpu_torch/bench.py:denoiser_flops_per_eval``."""
    enc = layers * (8 * width ** 2 + 4 * seq * width + 4 * width * ffn)
    emb = sum(2 * s * width + 2 * width ** 2 for s in stream_dims)
    head = 2 * width ** 2 + 2 * width * out_dim
    return batch * seq * (enc + emb + head)


def attention_fwd(B, S, W, dtype="bf16"):
    """(ops, bytes) of one attention forward over packed qkv [B, S, 3W]:
    Q K^T and P V, 2 * 2 * B * S^2 * W; qkv read once, the output written
    once, the key mask read once."""
    b = BYTES[dtype]
    return 4 * B * S * S * W, B * S * 4 * W * b + B * S


def attention_bwd(B, S, W, dtype="bf16"):
    """(ops, bytes) of one attention backward: Q K^T again, dO V^T, P^T dO,
    dS K and dS^T Q, 5 * 2 * B * S^2 * W; qkv, the output and its gradient
    read, the qkv gradient written."""
    b = BYTES[dtype]
    return 10 * B * S * S * W, B * S * 8 * W * b + B * S


def chamfer(S, R, P):
    """(ops, bytes) of an [S x R] Chamfer matrix of P-point clouds: each of
    the S * R * P^2 point-pair distances once, 3 subtractions, 3 products and
    2 sums; clouds read once, the matrix written once (f32)."""
    return 8 * S * R * P * P, (S + R) * P * 3 * 4 + S * R * 4


def bound_s(ops, nbytes, dtype="bf16"):
    """The least time the chip could take: operations over the peak rate or
    bytes over the memory bandwidth, the larger."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def model_flops(fn, *args) -> int:
    """Matmul and convolution FLOPs of ``fn(*args)``, counted by PyTorch's
    FLOP counter; run it on meta tensors to count without computing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def window_percent_of_peak(window: dict, flops_key: str) -> float | None:
    """The window's share of the chip's dense peak in its type, in percent:
    ``window[flops_key]`` operations over ``window["window_s"]``."""
    if not window.get("window_s") or flops_key not in window:
        return None
    return window[flops_key] / window["window_s"] / PEAK_FLOPS[window["dtype"]] * 100.0
