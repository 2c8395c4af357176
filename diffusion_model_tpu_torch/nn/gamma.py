"""The learned monotone noise schedule's gamma network, for sampling.

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

ENDPOINT_SCALE = 25.0


class PositiveLinear(nn.Module):
    """``x @ softplus(weight).T`` with ``weight`` ``[out, in]`` and no
    bias, as a broadcast product summed over ``in``."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_features, in_features, device=device))

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
