"""DDPM ancestral sampling with a static per-step plan.

Port of ``brepgen_tpu/diffusion/ddpm.py``: 1000 train timesteps, linear betas
1e-4 -> 0.02, epsilon prediction, "fixed_small" posterior variance and the
predicted x0 clipped to +/-3 while sampling. Plans are numpy arrays equal to
the JAX plans; the loop takes its noise from the caller.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

ModelFn = Callable[[torch.Tensor, int], torch.Tensor]
NoiseFn = Callable[[int, tuple], torch.Tensor]  # (step, shape) -> N(0, 1) draw


def make_betas_linear(num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                      beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)


class DDPMStepCoeffs(NamedTuple):
    """Per-step scalars of the ancestral update (all shape [steps])."""

    t: np.ndarray                   # model conditioning timestep (int32)
    sqrt_acp: np.ndarray
    sqrt_one_minus_acp: np.ndarray
    coef_x0: np.ndarray
    coef_xt: np.ndarray
    sigma: np.ndarray               # sqrt of the posterior variance (0 at t=0)


def make_ddpm_plan(num_steps: int = 250, num_train_timesteps: int = 1000,
                   beta_start: float = 1e-4, beta_end: float = 0.02) -> DDPMStepCoeffs:
    """The static plan for the last ``num_steps`` of ancestral DDPM (t = num_steps-1 .. 0)."""
    betas = make_betas_linear(num_train_timesteps, beta_start, beta_end)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)

    ts = np.arange(num_steps - 1, -1, -1)
    acp_t = acp[ts]
    acp_prev = np.where(ts > 0, acp[np.maximum(ts - 1, 0)], 1.0)
    beta_t = betas[ts]
    alpha_t = alphas[ts]

    coef_x0 = np.sqrt(acp_prev) * beta_t / (1.0 - acp_t)
    coef_xt = np.sqrt(alpha_t) * (1.0 - acp_prev) / (1.0 - acp_t)
    variance = np.clip((1.0 - acp_prev) / (1.0 - acp_t) * beta_t, 1e-20, None)
    sigma = np.where(ts > 0, np.sqrt(variance), 0.0)

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DDPMStepCoeffs(
        t=np.asarray(ts, dtype=np.int32),
        sqrt_acp=f32(np.sqrt(acp_t)),
        sqrt_one_minus_acp=f32(np.sqrt(1.0 - acp_t)),
        coef_x0=f32(coef_x0),
        coef_xt=f32(coef_xt),
        sigma=f32(sigma),
    )


def plan_step(plan: NamedTuple, i: int) -> NamedTuple:
    """Step ``i`` of a plan: Python scalars (rows stay arrays)."""
    return type(plan)(*(a[i].item() if a.ndim == 1 else a[i] for a in plan))


def ddpm_step(c: DDPMStepCoeffs, x: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor,
              clip_range: Optional[float] = None) -> torch.Tensor:
    """One ancestral step x_t -> x_{t-1}; ``c`` holds one step's scalars."""
    pred_x0 = (x - c.sqrt_one_minus_acp * eps) / c.sqrt_acp
    if clip_range is not None:
        pred_x0 = pred_x0.clamp(-clip_range, clip_range)
    mean = c.coef_x0 * pred_x0 + c.coef_xt * x
    return mean + c.sigma * noise


def ddpm_loop(model_fn: ModelFn, x: torch.Tensor, plan: DDPMStepCoeffs, noise_fn: NoiseFn,
              clip_range: Optional[float] = 3.0) -> torch.Tensor:
    """Run the DDPM tail; ``noise_fn(step, shape)`` gives each step's draw."""
    for i in range(len(plan.t)):
        c = plan_step(plan, i)
        eps = model_fn(x, c.t)
        x = ddpm_step(c, x, eps, noise_fn(i, tuple(x.shape)), clip_range)
    return x
