"""Batched state sampling with per-dimension goal bias (port of
lqrrt_tpu/core/sampling.py), driven by an explicit ``torch.Generator`` on
the planner's device."""
from __future__ import annotations

import torch


def sample_batch(gen: torch.Generator, batch: int, sample_space, goal_bias,
                 bias_target) -> torch.Tensor:
    """Draw (batch, n) candidates: uniform in sample_space (n, 2), and per
    dim i the bias target's value with probability goal_bias[i].

    Leading axes of sample_space (..., n, 2) and bias_target (..., n) draw
    that many batches at once, (..., batch, n): a fleet's (S, B, n) in one
    draw from ``gen``, each scenario in its own space toward its own
    target (JAX draws each from its own key: the streams differ)."""
    n = sample_space.shape[-2]
    lead = tuple(sample_space.shape[:-2])
    dev = sample_space.device
    lo = sample_space[..., None, :, 0]
    hi = sample_space[..., None, :, 1]
    shape = lead + (batch, n)
    xr = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo
    take_goal = torch.rand(shape, generator=gen, device=dev) < goal_bias
    return torch.where(take_goal, bias_target[..., None, :], xr)


def normalize_goal_bias(goal_bias, nstates: int, device) -> torch.Tensor:
    """Accept a scalar or per-dim goal_bias; return (n,) f32 on device."""
    gb = torch.as_tensor(goal_bias, dtype=torch.float32)
    if gb.ndim == 0:
        gb = gb.expand(nstates)
    if gb.shape != (nstates,):
        raise ValueError(
            f"goal_bias must be scalar or ({nstates},), got {tuple(gb.shape)}")
    return gb.to(device).contiguous()
