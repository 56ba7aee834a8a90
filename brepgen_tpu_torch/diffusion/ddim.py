"""DDIM for fast sampling (``--fast_steps``), with a static plan.

Port of ``brepgen_tpu/diffusion/ddim.py``. The cascade runs it with eta 0 and
no noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from brepgen_tpu_torch.diffusion.ddpm import ModelFn, NoiseFn, make_betas_linear, plan_step
from brepgen_tpu_torch.utils import profiling


class DDIMStepCoeffs(NamedTuple):
    t: np.ndarray           # [S] model timestep
    sqrt_acp: np.ndarray
    sqrt_one_minus_acp: np.ndarray
    sqrt_acp_prev: np.ndarray
    dir_coeff: np.ndarray   # sqrt(1 - acp_prev - sigma^2)
    sigma: np.ndarray


def make_ddim_plan(num_inference_steps: int, eta: float = 0.0,
                   num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                   beta_end: float = 0.02) -> DDIMStepCoeffs:
    betas = make_betas_linear(num_train_timesteps, beta_start, beta_end)
    acp = np.cumprod(1.0 - betas)

    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round().astype(np.int64)[::-1]
    prev_ts = ts - step_ratio

    acp_t = acp[ts]
    acp_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], 1.0)
    variance = (1 - acp_prev) / (1 - acp_t) * (1 - acp_t / acp_prev)
    sigma = eta * np.sqrt(np.clip(variance, 0, None))

    f32 = lambda a: np.asarray(a, np.float32)
    return DDIMStepCoeffs(
        t=np.asarray(ts, np.int32),
        sqrt_acp=f32(np.sqrt(acp_t)),
        sqrt_one_minus_acp=f32(np.sqrt(1 - acp_t)),
        sqrt_acp_prev=f32(np.sqrt(acp_prev)),
        dir_coeff=f32(np.sqrt(np.clip(1 - acp_prev - sigma**2, 0, None))),
        sigma=f32(sigma),
    )


def slice_plan(plan: NamedTuple, stop: int) -> NamedTuple:
    return type(plan)(*(a[:stop] for a in plan))


def ddim_loop(model_fn: ModelFn, x: torch.Tensor, plan: DDIMStepCoeffs,
              noise_fn: Optional[NoiseFn] = None,
              clip_range: Optional[float] = None) -> torch.Tensor:
    for i in range(len(plan.t)):
        c = plan_step(plan, i)
        eps = model_fn(x, c.t)
        with profiling.span("brepgen.cascade.update"):
            x0 = (x - c.sqrt_one_minus_acp * eps) / c.sqrt_acp
            if clip_range is not None:
                x0 = x0.clamp(-clip_range, clip_range)
            x_new = c.sqrt_acp_prev * x0 + c.dir_coeff * eps
            if noise_fn is not None:
                x_new = x_new + c.sigma * noise_fn(i, tuple(x.shape))
            x = x_new
    return x
