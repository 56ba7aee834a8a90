"""The samplers of the published protocol, as diffusers runs them: 1000
training steps with linear betas 1e-4 -> 0.02, epsilon prediction.

* PNDM (``PNDMScheduler``, ``set_alpha_to_one=False``, ``skip_prk_steps=False``):
  three Runge-Kutta warm-up steps (12 model calls), then 4th-order pseudo
  linear multistep; the position stages stop after 158 calls of the
  200-step schedule.
* DDPM ancestral sampling over the last N steps, "fixed_small" variance,
  the predicted x0 clipped to +/-3.
* DDIM with eta 0 (``--fast_steps``).

Each sampler is written as a loop over model calls ``eps_fn(x, t)`` that
returns its final state; the benchmark hands it the program's recorded
model outputs to replay the program's trajectory, or a denoiser. The state
is float32, as diffusers keeps it; ``state`` rounds it after every update
(the control keeps it in bfloat16).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

T_TRAIN = 1000


def _acp() -> np.ndarray:
    betas = np.linspace(1e-4, 0.02, T_TRAIN, dtype=np.float64)
    return betas, np.cumprod(1.0 - betas)


def _f32(a) -> float:
    return float(np.float32(a))


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def pndm(eps_fn: Callable, x: torch.Tensor, steps: int = 200,
         max_calls: Optional[int] = None, state: Callable = _same) -> torch.Tensor:
    betas, acp = _acp()
    ratio = T_TRAIN // steps
    base = (np.arange(steps) * ratio).round().astype(np.int64)
    prk_raw = np.repeat(base[-4:], 2) + np.tile(np.array([0, ratio // 2]), 4)
    prk = (np.repeat(prk_raw[:-1], 2)[1:-1])[::-1]
    plms = base[:-3][::-1]
    ts = np.concatenate([prk, plms])
    calls = len(ts) if max_calls is None else min(max_calls, len(ts))

    def transfer(t, t_prev):
        a_t = acp[t]
        a_prev = acp[t_prev] if t_prev >= 0 else acp[0]
        denom = a_t * np.sqrt(1.0 - a_prev) + np.sqrt(a_t * (1.0 - a_t) * a_prev)
        return _f32(np.sqrt(a_prev / a_t)), _f32((a_prev - a_t) / denom)

    ets = []
    cur_model, cur_sample = None, None
    for s in range(calls):
        t = int(ts[s])
        eps = eps_fn(x, t)
        if s < len(prk):  # Runge-Kutta warm-up
            sub = s % 4
            t_eff = int(prk[(s // 4) * 4])
            sc, dc = transfer(t_eff, t - (0 if s % 2 else ratio // 2))
            if sub == 0:
                ets.append(eps)
                cur_model = eps * _f32(1.0 / 6.0)
                cur_sample = x
                eff = eps
            elif sub in (1, 2):
                cur_model = cur_model + eps * _f32(1.0 / 3.0)
                eff = eps
            else:
                eff = cur_model + eps * _f32(1.0 / 6.0)
                cur_model = None
            x = state(sc * cur_sample - dc * eff)
        else:  # linear multistep
            sc, dc = transfer(t, t - ratio)
            ets.append(eps)
            h = ets[-4:]
            if len(h) == 1:
                eff = h[-1]
            elif len(h) == 2:
                eff = (3 * h[-1] - h[-2]) / 2
            elif len(h) == 3:
                eff = (23 * h[-1] - 16 * h[-2] + 5 * h[-3]) / 12
            else:
                eff = (55 * h[-1] - 59 * h[-2] + 37 * h[-3] - 9 * h[-4]) / 24
            x = state(sc * x - dc * eff)
    return x


def ddpm(eps_fn: Callable, x: torch.Tensor, steps: int, noise_fn: Callable,
         clip: Optional[float] = 3.0, state: Callable = _same) -> torch.Tensor:
    """The last ``steps`` ancestral steps (t = steps-1 .. 0); ``noise_fn(i,
    shape)`` gives step i's N(0, 1) draw."""
    betas, acp = _acp()
    alphas = 1.0 - betas
    for i, t in enumerate(range(steps - 1, -1, -1)):
        acp_prev = acp[t - 1] if t > 0 else 1.0
        eps = eps_fn(x, t)
        x0 = (x - _f32(np.sqrt(1.0 - acp[t])) * eps) / _f32(np.sqrt(acp[t]))
        if clip is not None:
            x0 = x0.clamp(-clip, clip)
        mean = (_f32(np.sqrt(acp_prev) * betas[t] / (1.0 - acp[t])) * x0
                + _f32(np.sqrt(alphas[t]) * (1.0 - acp_prev) / (1.0 - acp[t])) * x)
        var = max((1.0 - acp_prev) / (1.0 - acp[t]) * betas[t], 1e-20)
        sigma = _f32(np.sqrt(var)) if t > 0 else 0.0
        x = state(mean + sigma * noise_fn(i, tuple(x.shape)))
    return x


def ddim_timesteps(steps: int) -> np.ndarray:
    ratio = T_TRAIN // steps
    return (np.arange(steps) * ratio).round().astype(np.int64)[::-1]


def ddim(eps_fn: Callable, x: torch.Tensor, steps: int, calls: Optional[int] = None,
         clip: Optional[float] = None, state: Callable = _same) -> torch.Tensor:
    """Deterministic DDIM (eta 0) over a ``steps``-step schedule, stopping
    after ``calls`` model calls where given."""
    _, acp = _acp()
    ratio = T_TRAIN // steps
    ts = ddim_timesteps(steps)
    for t in ts[:calls]:
        t = int(t)
        acp_prev = acp[t - ratio] if t - ratio >= 0 else 1.0
        eps = eps_fn(x, t)
        x0 = (x - _f32(np.sqrt(1 - acp[t])) * eps) / _f32(np.sqrt(acp[t]))
        if clip is not None:
            x0 = x0.clamp(-clip, clip)
        x = state(_f32(np.sqrt(acp_prev)) * x0 + _f32(np.sqrt(1 - acp_prev)) * eps)
    return x


def add_noise(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) at integer timesteps ``t`` [B]."""
    _, acp = _acp()
    a = torch.as_tensor(acp.astype(np.float32), device=x0.device)[t.to(x0.device)]
    shape = (x0.shape[0],) + (1,) * (x0.dim() - 1)
    return torch.sqrt(a).reshape(shape) * x0 + torch.sqrt(1.0 - a).reshape(shape) * noise
