"""Noise schedules, computed in float32 step for step as the JAX package does.

``alpha_t`` is the polynomial schedule value and ``sigma_t = sqrt(1 -
alpha_t^2)``. The arithmetic order follows ``jnp.linspace`` and the JAX
schedule (float32, x64 off), so the two tables agree to float32 rounding.
"""

from __future__ import annotations

import torch


def linspace_f32(start, stop, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` for the grids the port builds.

    ``start * (1 - k/div) + stop * (k/div)`` evaluated in float64 from the
    float32 endpoints and rounded once, endpoint appended: on grids that
    start at 0 (the schedule's t grid, the strided sampler's) this gives
    JAX's values exactly, integers included, where ``torch.linspace`` is
    off in the last place.
    """
    if num < 2:
        raise ValueError(f"linspace_f32 needs num >= 2, got {num}")
    f32, f64 = torch.float32, torch.float64
    div = num - 1
    step = torch.arange(div, dtype=f64, device=device) / div
    start_t = torch.as_tensor(start, device=device).to(f32)
    stop_t = torch.as_tensor(stop, device=device).to(f32)
    out = start_t.to(f64) * (1 - step) + stop_t.to(f64) * step
    return torch.cat([out.to(f32), stop_t.reshape(1)])


def _cumprod_in_jax_order(v: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive product scan of a 1-D tensor, rounded as ``jnp.cumprod``.

    XLA scans in blocks of 16: a running product inside each block, the
    scan of the block totals (recursively), then each block times the
    product of all blocks before it. ``torch.cumprod`` accumulates in
    double on the CPU and rounds otherwise, which over 1000 steps moves
    the schedule by more than 1e-6 relative.
    """
    n = v.shape[0]
    rows = -(-n // block)
    pad = torch.ones(rows * block - n, dtype=v.dtype, device=v.device)
    tiles = torch.cat([v, pad]).reshape(rows, block)
    cols = [tiles[:, 0]]
    for c in range(1, block):
        cols.append(cols[-1] * tiles[:, c])
    within = torch.stack(cols, dim=1)
    if rows == 1:
        return within.reshape(-1)[:n]
    totals = _cumprod_in_jax_order(within[:, -1], block)
    before = torch.cat([torch.ones(1, dtype=v.dtype, device=v.device),
                        totals[:-1]])
    return (within * before[:, None]).reshape(-1)[:n]


def clip_noise_schedule(alphas2: torch.Tensor,
                        clip_value: float = 0.001) -> torch.Tensor:
    """Clamp per-step alpha^2 ratios to ``[clip_value, 1]`` and re-cumprod."""
    ones = torch.ones(1, dtype=alphas2.dtype, device=alphas2.device)
    alphas2 = torch.cat([ones, alphas2])
    alphas_step = (alphas2[1:] / alphas2[:-1]).clamp(clip_value, 1.0)
    return _cumprod_in_jax_order(alphas_step)


def polynomial_alpha_schedule(timesteps: int, s: float = 1e-4,
                              power: float = 3.0,
                              device=None) -> torch.Tensor:
    """Polynomial alpha schedule over t = 0..T (length T+1), float32."""
    x = linspace_f32(0.0, float(timesteps), timesteps + 1, device=device)
    # the power in float64, rounded once: XLA's pow is about that close,
    # where float32 pow (or x*x*x) is off in the last place
    frac_pow = ((x / timesteps).double() ** power).to(torch.float32)
    alphas2 = (1.0 - frac_pow) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1.0 - 2.0 * s
    return precision * alphas2 + s


def beta_schedule(kind: str, initial_beta: float, final_beta: float,
                  timesteps: int, device=None) -> torch.Tensor:
    """Legacy DDPM-style beta schedules over t = 0..T (length T+1), float32:
    "sigmoid" (a sigmoid over ``linspace(-6, 6)``, scaled into
    ``[initial_beta, final_beta]``) or "linear"."""
    if kind == "sigmoid":
        base = torch.sigmoid(linspace_f32(-6.0, 6.0, timesteps + 1,
                                          device=device))
        return base * (final_beta - initial_beta) + initial_beta
    if kind == "linear":
        return linspace_f32(initial_beta, final_beta, timesteps + 1,
                            device=device)
    raise ValueError(f"unknown beta schedule {kind!r}")


def ddpm_alpha_bar(betas: torch.Tensor) -> torch.Tensor:
    """Cumulative product ``alpha_bar_t = prod(1 - beta)``, rounded as
    ``jnp.cumprod``."""
    return _cumprod_in_jax_order(1.0 - betas)
