"""Port: DDPM, PNDM and DDIM plans and loops against the JAX package.

Plans must be equal exactly (same values, same types). Loops run a fixed
eps function from the same start; the stochastic ones get JAX's own draws
injected. CPU, f32, tolerance 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu import diffusion as jd
from brepgen_tpu_torch import diffusion as td


def _assert_plans_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("steps", [5, 250, 260])
def test_ddpm_plan_equal(steps):
    _assert_plans_equal(td.make_ddpm_plan(num_steps=steps), jd.make_ddpm_plan(num_steps=steps))


@pytest.mark.parametrize("steps,max_calls", [(200, None), (200, 158), (10, 8), (50, None)])
def test_pndm_plan_equal(steps, max_calls):
    _assert_plans_equal(td.make_pndm_plan(steps, max_calls), jd.make_pndm_plan(steps, max_calls))


@pytest.mark.parametrize("steps,eta", [(4, 0.0), (50, 0.0), (10, 0.5)])
def test_ddim_plan_equal(steps, eta):
    _assert_plans_equal(td.make_ddim_plan(steps, eta), jd.make_ddim_plan(steps, eta))


def test_pndm_plan_lengths():
    assert len(td.make_pndm_plan(200).t_model) == 209
    assert len(td.make_pndm_plan(200, max_calls=158).t_model) == 158


SHAPE = (2, 5, 6)


def _x0():
    return np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)


def _eps_jax(x, t):
    return jnp.tanh(0.7 * x + t.astype(jnp.float32) / 1000.0) * 1.3


def _eps_torch(x, t):
    return torch.tanh(0.7 * x + float(np.float32(t)) / 1000.0) * 1.3


def _jax_draws(key, n):
    keys = jax.random.split(key, n)
    return [np.array(jax.random.normal(k, SHAPE, dtype=jnp.float32)) for k in keys]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("steps", [5, 40])
def test_ddpm_loop_with_injected_noise(steps):
    key = jax.random.PRNGKey(steps)
    want = jd.ddpm_scan(_eps_jax, jnp.asarray(_x0()), jd.make_ddpm_plan(num_steps=steps), key, 3.0)
    draws = _jax_draws(key, steps)
    got = td.ddpm_loop(_eps_torch, torch.from_numpy(_x0()), td.make_ddpm_plan(num_steps=steps),
                       lambda i, shape: torch.from_numpy(draws[i]), 3.0)
    _close(got, want)


@pytest.mark.parametrize("steps,max_calls", [(10, 8), (10, None), (50, None)])
def test_pndm_loop(steps, max_calls):
    want = jd.pndm_scan(_eps_jax, jnp.asarray(_x0()), jd.make_pndm_plan(steps, max_calls))
    got = td.pndm_loop(_eps_torch, torch.from_numpy(_x0()), td.make_pndm_plan(steps, max_calls))
    _close(got, want)


def test_pndm_carry_splits_exactly():
    plan = td.make_pndm_plan(10)
    whole = td.pndm_loop(_eps_torch, torch.from_numpy(_x0()), plan)
    carry = td.pndm_init_carry(torch.from_numpy(_x0()))
    carry = td.pndm_loop_carry(_eps_torch, carry, type(plan)(*(a[:5] for a in plan)))
    carry = td.pndm_loop_carry(_eps_torch, carry, type(plan)(*(a[5:] for a in plan)))
    assert torch.equal(carry[0], whole)


@pytest.mark.parametrize("clip", [None, 3.0])
def test_ddim_loop_deterministic(clip):
    want = jd.ddim_scan(_eps_jax, jnp.asarray(_x0()), jd.make_ddim_plan(10), clip_range=clip)
    got = td.ddim_loop(_eps_torch, torch.from_numpy(_x0()), td.make_ddim_plan(10), clip_range=clip)
    _close(got, want)


def test_ddim_loop_with_injected_noise():
    key = jax.random.PRNGKey(7)
    want = jd.ddim_scan(_eps_jax, jnp.asarray(_x0()), jd.make_ddim_plan(10, eta=0.5), key)
    draws = _jax_draws(key, 10)
    got = td.ddim_loop(_eps_torch, torch.from_numpy(_x0()), td.make_ddim_plan(10, eta=0.5),
                       lambda i, shape: torch.from_numpy(draws[i]))
    _close(got, want)
