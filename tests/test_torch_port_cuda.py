"""Port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a card. This file imports no JAX, so it
also runs on a machine without it (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels.attention import packed_attention, packed_attention_reference


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    mask = rng.random((B, S)) < np.linspace(0.1, 0.9, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1, 1:] = True  # only slot 0 unmasked
    mask[2] = True      # every key masked
    return qkv, mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("S,W,H", [(1800, 768, 12), (1800, 256, 8), (65, 64, 2)])
def test_kernel_matches_plain_on_card(cuda, dtype, rel, S, W, H):
    # against the plain version in f32 on the same inputs: the kernel works in
    # f32 and rounds its output once to the input type
    qkv, mask = _inputs(4, S, W, seed=S)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    before = LAUNCH_COUNTS["packed_attention"]
    got = packed_attention(qkv, H, mask).float()
    want = packed_attention_reference(qkv.float(), H, mask)
    assert LAUNCH_COUNTS["packed_attention"] == before + 1
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()


@pytest.mark.cuda
def test_kernel_rejects_unsupported_input(cuda):
    with pytest.raises(ValueError):
        packed_attention(torch.zeros((1, 8, 3 * 48), device=cuda), 3)  # D = 16
    with pytest.raises(TypeError):
        packed_attention(torch.zeros((1, 8, 3 * 64), device=cuda, dtype=torch.float16), 2)
