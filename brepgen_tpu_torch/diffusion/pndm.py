"""PNDM (pseudo numerical methods) with a static plan.

Port of ``brepgen_tpu/diffusion/pndm.py``: diffusers' ``PNDMScheduler``
semantics with PRK warm-up (3 Runge-Kutta steps = 12 calls) followed by
4th-order pseudo linear multistep updates, compiled into per-step transfer
coefficients

    x_prev = sc * base - dc * eps_eff

and mixing weights. ``max_calls`` truncates the schedule (158 calls of the
200-step plan for the position stages). The plan arrays equal the JAX ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brepgen_tpu_torch.diffusion.ddpm import ModelFn, make_betas_linear, plan_step
from brepgen_tpu_torch.utils import profiling


class PNDMPlan(NamedTuple):
    t_model: np.ndarray      # [S] timestep fed to the model at this call
    sc: np.ndarray           # [S] sample coefficient of the transfer fn
    dc: np.ndarray           # [S] epsilon coefficient of the transfer fn
    ets_w: np.ndarray        # [S, 4] weights over the eps history (post-append)
    mo_w: np.ndarray         # [S] weight of the fresh model output in eps_eff
    cur_w: np.ndarray        # [S] weight of the RK accumulator in eps_eff
    cur_mo_add: np.ndarray   # [S] fraction of model output added to accumulator
    reset_cur_mo: np.ndarray     # [S] bool: zero the accumulator after use
    append_ets: np.ndarray       # [S] bool: shift model output into history
    set_cur_sample: np.ndarray   # [S] bool: latch incoming x as RK base point
    use_cur_sample: np.ndarray   # [S] bool: transfer from latched base point


def _transfer_coeffs(acp: np.ndarray, t: int, t_prev: int, final_acp: float):
    a_t = acp[t]
    a_prev = acp[t_prev] if t_prev >= 0 else final_acp
    sc = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(1.0 - a_prev) + np.sqrt(a_t * (1.0 - a_t) * a_prev)
    dc = (a_prev - a_t) / denom
    return sc, dc


_AB_WEIGHTS = {
    # history length (post-append) -> weights over ets[-4:], newest last
    1: np.array([0.0, 0.0, 0.0, 1.0]),
    2: np.array([0.0, 0.0, -1.0 / 2.0, 3.0 / 2.0]),
    3: np.array([0.0, 5.0 / 12.0, -16.0 / 12.0, 23.0 / 12.0]),
    4: np.array([-9.0 / 24.0, 37.0 / 24.0, -59.0 / 24.0, 55.0 / 24.0]),
}


def make_pndm_plan(num_inference_steps: int, max_calls: int | None = None,
                   num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                   beta_end: float = 0.02) -> PNDMPlan:
    betas = make_betas_linear(num_train_timesteps, beta_start, beta_end)
    acp = np.cumprod(1.0 - betas)
    final_acp = acp[0]  # set_alpha_to_one=False

    step_ratio = num_train_timesteps // num_inference_steps
    base_ts = (np.arange(num_inference_steps) * step_ratio).round().astype(np.int64)
    prk_raw = np.repeat(base_ts[-4:], 2) + np.tile(np.array([0, step_ratio // 2]), 4)
    prk_ts = (np.repeat(prk_raw[:-1], 2)[1:-1])[::-1].copy()
    plms_ts = base_ts[:-3][::-1].copy()
    all_ts = np.concatenate([prk_ts, plms_ts])

    n_prk = len(prk_ts)  # 12
    S = len(all_ts) if max_calls is None else min(max_calls, len(all_ts))

    t_model = np.zeros(S, np.int64)
    sc, dc = np.zeros(S), np.zeros(S)
    ets_w = np.zeros((S, 4))
    mo_w, cur_w, cur_mo_add = np.zeros(S), np.zeros(S), np.zeros(S)
    reset_cur_mo, append_ets = np.zeros(S, bool), np.zeros(S, bool)
    set_cur, use_cur = np.zeros(S, bool), np.zeros(S, bool)

    ets_len = 0
    for s in range(S):
        t = int(all_ts[s])
        t_model[s] = t
        if s < n_prk:
            sub = s % 4
            t_prev = t - (0 if s % 2 else step_ratio // 2)
            t_eff = int(prk_ts[(s // 4) * 4])
            sc[s], dc[s] = _transfer_coeffs(acp, t_eff, t_prev, final_acp)
            use_cur[s] = True
            if sub == 0:
                set_cur[s] = True
                append_ets[s] = True
                ets_len = min(ets_len + 1, 4)
                mo_w[s] = 1.0
                cur_mo_add[s] = 1.0 / 6.0
            elif sub in (1, 2):
                mo_w[s] = 1.0
                cur_mo_add[s] = 1.0 / 3.0
            else:
                mo_w[s] = 1.0 / 6.0
                cur_w[s] = 1.0
                reset_cur_mo[s] = True
        else:
            sc[s], dc[s] = _transfer_coeffs(acp, t, t - step_ratio, final_acp)
            append_ets[s] = True
            ets_len = min(ets_len + 1, 4)
            ets_w[s] = _AB_WEIGHTS[ets_len]

    f32 = lambda a: np.asarray(a, np.float32)
    return PNDMPlan(
        t_model=np.asarray(t_model, np.int32), sc=f32(sc), dc=f32(dc), ets_w=f32(ets_w),
        mo_w=f32(mo_w), cur_w=f32(cur_w), cur_mo_add=f32(cur_mo_add),
        reset_cur_mo=reset_cur_mo, append_ets=append_ets,
        set_cur_sample=set_cur, use_cur_sample=use_cur,
    )


def pndm_init_carry(x: torch.Tensor):
    """(x, eps history of 4, RK accumulator, latched RK base point)."""
    z = torch.zeros_like(x)
    return x, [z] * 4, z, z


def pndm_loop_carry(model_fn: ModelFn, carry, plan: PNDMPlan):
    """Advance a PNDM state through ``plan`` (or a contiguous slice of one)."""
    x, ets, cur_mo, cur_s = carry
    for i in range(len(plan.t_model)):
        c = plan_step(plan, i)
        eps = model_fn(x, c.t_model)
        with profiling.span("brepgen.cascade.update"):
            if c.append_ets:
                ets = ets[1:] + [eps]
            eps_eff = c.mo_w * eps
            for w, e in zip(c.ets_w.tolist(), ets):
                if w:
                    eps_eff = eps_eff + w * e
            if c.cur_w:
                eps_eff = eps_eff + c.cur_w * cur_mo
            cur_mo = torch.zeros_like(cur_mo) if c.reset_cur_mo else cur_mo + c.cur_mo_add * eps
            if c.set_cur_sample:
                cur_s = x
            base = cur_s if c.use_cur_sample else x
            x = c.sc * base - c.dc * eps_eff
    return x, ets, cur_mo, cur_s


def pndm_loop(model_fn: ModelFn, x: torch.Tensor, plan: PNDMPlan) -> torch.Tensor:
    """Run a whole PNDM schedule (deterministic: no noise)."""
    return pndm_loop_carry(model_fn, pndm_init_carry(x), plan)[0]
