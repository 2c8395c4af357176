"""The learned monotone noise schedule's gamma network, and its fit to a
schedule table.

As ``diffusion_model_tpu.nn.gamma``: ``gamma_tilde(t) = l1(t) +
l3(sigmoid(l2(l1(t))))`` with softplus-positive weights (monotone in t),
normalised to [0, 1] over the unit interval and mapped onto the endpoints
``gamma_0``, ``gamma_1``. The endpoints are stored divided by
``ENDPOINT_SCALE`` (25), as the JAX package trains and saves them.

The stored weights are ``[out, in]`` already (the reference's own layout,
not a flax ``Dense`` kernel) and are softplus-ed where they are used. l1 is
``[1, 1]``, l2 ``[1024, 1]`` and l3 ``[1, 1024]``: every product has an
inner width of 1 or is a sum over 1024, so they are written as broadcast
products and sums, so no TF32 matmul can touch the table.

A fresh network is drawn as flax draws it (``PositiveLinear``: kaiming
uniform over ``fan_in``, then the offset -2; the distribution, not the
bits). ``fit_gamma_to_schedule`` regresses it onto a schedule table, the
``gamma_init="polynomial"`` start of the learned recipe.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_model_tpu_torch.ops.schedules import linspace_f32
from diffusion_model_tpu_torch.train import optim

ENDPOINT_SCALE = 25.0
PARAM_INIT_OFFSET = -2.0


class PositiveLinear(nn.Module):
    """``x @ softplus(weight).T`` with ``weight`` ``[out, in]`` and no
    bias, as a broadcast product summed over ``in``."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        # kaiming_uniform(a=sqrt(5)) over fan_in, then the offset
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / in_features)
        w = torch.empty(out_features, in_features, device=device)
        with torch.no_grad():
            nn.init.uniform_(w, -bound, bound).add_(PARAM_INIT_OFFSET)
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.unsqueeze(-2) * F.softplus(self.weight)).sum(dim=-1)


class GammaNetwork(nn.Module):
    """Monotone ``gamma(t)`` for ``t`` in [0, 1], shape ``[..., 1]``."""

    def __init__(self, hidden: int = 1024, device=None):
        super().__init__()
        self.l1 = PositiveLinear(1, 1, device=device)
        self.l2 = PositiveLinear(1, hidden, device=device)
        self.l3 = PositiveLinear(hidden, 1, device=device)
        self.gamma_0 = nn.Parameter(
            torch.full((1,), -5.0 / ENDPOINT_SCALE, device=device))
        self.gamma_1 = nn.Parameter(
            torch.full((1,), 10.0 / ENDPOINT_SCALE, device=device))

    def gamma_tilde(self, t: torch.Tensor) -> torch.Tensor:
        l1_t = self.l1(t)
        return l1_t + self.l3(torch.sigmoid(self.l2(l1_t)))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        g0 = self.gamma_tilde(torch.zeros_like(t))
        g1 = self.gamma_tilde(torch.ones_like(t))
        normalized = (self.gamma_tilde(t) - g0) / (g1 - g0)
        gamma_0 = self.gamma_0 * ENDPOINT_SCALE
        gamma_1 = self.gamma_1 * ENDPOINT_SCALE
        return gamma_0 + (gamma_1 - gamma_0) * normalized


def fit_gamma_to_schedule(gamma: GammaNetwork, alphas: torch.Tensor,
                          steps: int = 6000, lr: float = 1e-2) -> float:
    """Regress ``gamma``, in place from its current parameters, onto the
    alpha table ``alphas`` in alpha^2 space, as the JAX package's
    ``fit_gamma_to_schedule``: ``steps`` Adam steps (optax's rule, in
    ``train.optim``) under ``cosine_decay_schedule(lr, steps)`` on
    ``mean(err^2) + 50 mean(err^4)``, err = ``sigmoid(-gamma(t)) - alpha^2``
    over ``linspace(0, 1, T+1)``. Returns the largest |err| after the fit.
    """
    where = gamma.gamma_0.device
    a2_target = alphas.to(where, torch.float32) ** 2
    t_grid = linspace_f32(0.0, 1.0, alphas.shape[0], device=where)[:, None]
    params = dict(gamma.named_parameters())
    opt = optim.chain(optim.scale_by_adam(),
                      optim.scale_by_schedule(
                          lambda k: -optim.cosine_decay(lr, steps, k)))
    state = opt.init(params)

    def error():
        return torch.sigmoid(-gamma(t_grid)[:, 0]) - a2_target

    for _ in range(steps):
        err = error()
        loss = (err ** 2).mean() + 50.0 * (err ** 4).mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))
        updates, state = opt.update(grads, state, params)
        optim.apply_updates(params, updates)
    with torch.no_grad():
        return float(error().abs().max())
