"""Port: packed attention (kernel K1's plain version and wrapper) against the
JAX package's ``_packed_reference`` and its Pallas kernel in interpret mode.

CPU, f32, tolerance 1e-5 (same math, summation order apart). The CUDA kernel
itself is held against the plain version on the card in
``test_torch_port_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.kernels.attention import _packed_reference, fused_set_attention_packed
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels.attention import packed_attention, packed_attention_reference


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    mask = rng.random((B, S)) < np.linspace(0.1, 0.9, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    if B > 1:
        mask[1, 1:] = True  # only slot 0 unmasked
    return qkv, mask


@pytest.mark.parametrize("W,H", [(64, 2), (128, 2), (256, 8)])
@pytest.mark.parametrize("S", [37, 64])
def test_reference_matches_jax(W, H, S):
    qkv, mask = _inputs(3, S, W, seed=S + W)
    want = np.asarray(_packed_reference(jnp.asarray(qkv), H, jnp.asarray(mask)))
    got = packed_attention_reference(torch.from_numpy(qkv), H, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("W,H", [(64, 2), (128, 2)])
def test_reference_matches_pallas_interpret(W, H):
    qkv, mask = _inputs(2, 45, W, seed=W)
    want = np.asarray(fused_set_attention_packed(jnp.asarray(qkv), H, jnp.asarray(mask), 16, True))
    got = packed_attention_reference(torch.from_numpy(qkv), H, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_reference_without_mask_matches_jax():
    qkv, _ = _inputs(2, 20, 64, seed=3)
    want = np.asarray(_packed_reference(jnp.asarray(qkv), 2, None))
    got = packed_attention_reference(torch.from_numpy(qkv), 2, None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_all_masked_row_is_mean_of_values():
    qkv, mask = _inputs(2, 30, 64, seed=4)
    mask[1] = True
    got = packed_attention_reference(torch.from_numpy(qkv), 2, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[1], np.broadcast_to(qkv[1, :, 128:].mean(0), (30, 64)),
                               atol=1e-5, rtol=0)


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    qkv, mask = _inputs(2, 30, 64, seed=5)
    before = LAUNCH_COUNTS["packed_attention"]
    got = packed_attention(torch.from_numpy(qkv), 2, torch.from_numpy(mask))
    want = packed_attention_reference(torch.from_numpy(qkv), 2, torch.from_numpy(mask))
    assert torch.equal(got, want)
    assert LAUNCH_COUNTS["packed_attention"] == before
