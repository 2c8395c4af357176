"""Forward noising and reverse steps of the joint (x, h) diffusion process
on padded batches.

``alphas[t]`` for t = 0..T is alpha_t and sigma_t = sqrt(1 - alpha_t^2),
from the polynomial schedule or from a learned gamma network (where
sigma_t = sqrt(sigmoid(gamma)) is the same sqrt(1 - alpha_t^2)).
The posterior mean of the t -> s = t-1 step is
``mu = z/alpha_ts - sigma2_ts * eps / (alpha_ts * sigma_t)`` with
``alpha_ts = alpha_t/alpha_s``, and the ancestral step adds
``sqrt(sigma2_ts * sigma2_s / sigma2_t)`` times fresh noise, CoM-free for
positions. The forward process noises clean data to per-graph timesteps
``t [B]`` (``diffuse_zero_to_t``, the training target). Noise is a
standard-normal tensor handed in by the caller (the sampler and the trainer
draw it from explicit ``torch.Generator`` objects), so the same draws can be fed
to the JAX package and to the port. Timesteps are Python ints or integer
tensors; per-graph coefficients broadcast over the node and feature axes
(``_bcast``).

The coordinate head may be read as epsilon (the default), as the clean
structure's displacement ("x0") or as the velocity ("v");
``head_out_to_eps`` turns the last two into the epsilon every step reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.nn.gamma import GammaNetwork
from diffusion_model_tpu_torch.ops.com import remove_mean
from diffusion_model_tpu_torch.ops.schedules import (
    linspace_f32,
    polynomial_alpha_schedule,
)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Noise schedule table: ``alphas[t]`` for t = 0..T (length T+1)."""

    alphas: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.alphas.shape[0] - 1

    def alpha(self, t):
        return self.alphas[t]

    def sigma(self, t):
        return torch.sqrt(1.0 - self.alphas[t] ** 2)


def predefined_schedule(cfg: Config, device=None) -> Schedule:
    """Polynomial schedule from config."""
    return Schedule(alphas=polynomial_alpha_schedule(
        cfg.num_diffusion_timestep, s=cfg.noise_precision,
        power=cfg.noise_schedule_power, device=device))


def learned_schedule(gamma: GammaNetwork, num_timesteps: int,
                     device=None) -> Schedule:
    """Schedule from a gamma network: ``alpha_t = sqrt(sigmoid(-gamma(t/T)))``
    over JAX's ``linspace(0, 1, T+1)`` grid, float32, computed where
    ``gamma``'s parameters are and returned on ``device`` (default there).
    The table keeps its graph to the gamma parameters where autograd
    records, so the gamma network trains through the loss.
    """
    where = gamma.gamma_0.device
    t_grid = linspace_f32(0.0, 1.0, num_timesteps + 1, device=where)[:, None]
    alphas = torch.sqrt(torch.sigmoid(-gamma(t_grid)[:, 0]))
    return Schedule(alphas=alphas.to(where if device is None else device))


def _bcast(coef: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-graph coefficients ``[B]`` (or a scalar) shaped to broadcast
    over ``z``'s node and feature axes, in ``z``'s dtype."""
    coef = torch.as_tensor(coef, device=z.device)
    return coef.reshape(coef.shape + (1,) * (z.dim() - coef.dim())).to(
        z.dtype)


def x_param_is_x0(cfg: Config) -> bool:
    """True iff the coordinate head needs an eps-space conversion (the
    name predates "v": it answers "non-eps?"). ``Config`` refuses any
    value but "eps", "x0" and "v" when it is built."""
    return cfg.x_parameterization != "eps"


def x0_out_to_eps(schedule: Schedule, t, z: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """An x0-parameterised coordinate head read as an epsilon prediction:
    ``x0_hat = z_t + out``, so

        eps_hat = ((1 - alpha_t)/sigma_t) z_t - (alpha_t/sigma_t) out

    The coefficients are formed in the schedule's float32 before they meet
    ``out``: in bfloat16 ``1 - alpha_t`` is 0 at low t (alpha ~ 1 - 1e-5).
    Padded rows stay zero and the result stays CoM-free (a combination of
    two masked CoM-free fields). The oracle ``out = x0 - z_t`` gives back
    the exact forward noise."""
    alpha_t = schedule.alpha(t)
    sigma_t = schedule.sigma(t)
    coef_z = (1.0 - alpha_t) / sigma_t
    coef_out = alpha_t / sigma_t
    return _bcast(coef_z, z) * z - _bcast(coef_out, out) * out


def v_out_to_eps(schedule: Schedule, t, z: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """A v-parameterised coordinate head (``v = alpha_t eps - sigma_t x0``)
    read as an epsilon prediction: ``eps_hat = alpha_t out + sigma_t z_t``
    (with alpha^2 + sigma^2 = 1). The oracle ``out = alpha eps - sigma x0``
    gives back the exact forward noise."""
    alpha_t = schedule.alpha(t)
    sigma_t = schedule.sigma(t)
    return _bcast(alpha_t, out) * out + _bcast(sigma_t, z) * z


def head_out_to_eps(cfg, schedule: Schedule, t, z: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """The coordinate head's conversion for ``cfg.x_parameterization``
    "x0" or "v"; raises for any other value."""
    if cfg.x_parameterization == "x0":
        return x0_out_to_eps(schedule, t, z, out)
    if cfg.x_parameterization == "v":
        return v_out_to_eps(schedule, t, z, out)
    raise ValueError(
        f"no conversion for x_parameterization={cfg.x_parameterization!r}")


def diffuse_zero_to_t(schedule: Schedule, noise: torch.Tensor,
                      z: torch.Tensor, t, mode: str = "pos",
                      mask: Optional[torch.Tensor] = None):
    """Forward-noise clean ``z [B, N, D]`` to timestep ``t`` (an int or
    ``[B]``): ``(alpha_t z + sigma_t eps, eps)``, eps the raw draw ``noise``
    made CoM-free ("pos") or masked ("h"): the training target."""
    eps = shape_noise(noise, mode, mask)
    return (_bcast(schedule.alpha(t), z) * z
            + _bcast(schedule.sigma(t), z) * eps, eps)


def shape_noise(noise: torch.Tensor, mode: str,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Standard-normal draws made CoM-free ("pos") or masked ("h")."""
    if mode == "pos":
        return remove_mean(noise, mask)
    if mask is not None:
        return noise * mask.to(noise.dtype).unsqueeze(-1)
    return noise


def _mask_rows(out: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return out
    return out * mask.to(out.dtype).unsqueeze(-1)


def calculate_mu(schedule: Schedule, z: torch.Tensor, eps: torch.Tensor,
                 t: int) -> torch.Tensor:
    """Posterior mean for the t -> t-1 step."""
    alpha_t = schedule.alpha(t)
    alpha_s = schedule.alpha(t - 1)
    sq_sigma_t = 1.0 - alpha_t ** 2
    sigma_t = torch.sqrt(sq_sigma_t)
    sq_sigma_s = 1.0 - alpha_s ** 2
    alpha_ts = alpha_t / alpha_s
    sq_sigma_ts = sq_sigma_t - alpha_ts ** 2 * sq_sigma_s
    return z / _bcast(alpha_ts, z) - _bcast(
        sq_sigma_ts / (alpha_ts * sigma_t), z) * eps


def reverse_diffuse_one_step(schedule: Schedule, noise: Optional[torch.Tensor],
                             z: torch.Tensor, eps: torch.Tensor, t: int,
                             mode: str = "pos",
                             mask: Optional[torch.Tensor] = None,
                             deterministic: bool = False,
                             noise_scale: float = 1.0) -> torch.Tensor:
    """One ancestral reverse step z_t -> z_{t-1}.

    ``noise`` is a raw standard-normal tensor shaped like ``z`` (it is made
    CoM-free or masked here); it is not read when the step is deterministic
    (``deterministic`` or ``noise_scale == 0``) and may then be None.
    """
    mu = calculate_mu(schedule, z, eps, t)
    if deterministic or noise_scale == 0.0:
        out = mu
    else:
        alpha_t = schedule.alpha(t)
        alpha_s = schedule.alpha(t - 1)
        sq_sigma_t = 1.0 - alpha_t ** 2
        sq_sigma_s = 1.0 - alpha_s ** 2
        alpha_ts = alpha_t / alpha_s
        sq_sigma_ts = sq_sigma_t - alpha_ts ** 2 * sq_sigma_s
        # a flat stretch of a schedule can round sq_sigma_ts below zero
        std = torch.sqrt(sq_sigma_ts.clamp_min(0.0) * sq_sigma_s / sq_sigma_t)
        out = mu + noise_scale * std * shape_noise(noise, mode, mask)
    return _mask_rows(out, mask)


def final_denoise_step(schedule: Schedule, noise: Optional[torch.Tensor],
                       z: torch.Tensor, eps: torch.Tensor, mode: str = "pos",
                       mask: Optional[torch.Tensor] = None,
                       deterministic: bool = False,
                       noise_scale: float = 1.0) -> torch.Tensor:
    """The explicit t=0 epilogue:

        mu = z/alpha_0 - sigma_0 * eps / alpha_0
        z' = mu + (sigma_0/alpha_0) * noise  (dropped when deterministic)
    """
    alpha_0 = schedule.alpha(0)
    sigma_0 = schedule.sigma(0)
    mu = z / alpha_0 - (sigma_0 / alpha_0) * eps
    if deterministic or noise_scale == 0.0:
        out = mu
    else:
        out = mu + noise_scale * (sigma_0 / alpha_0) * shape_noise(
            noise, mode, mask)
    return _mask_rows(out, mask)
