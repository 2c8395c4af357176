"""Masked centre-of-mass projections over padded ``[..., N, D]`` graphs."""

from __future__ import annotations

from typing import Optional

import torch


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                dim: int = -2) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only masked-in nodes (keepdim)."""
    if mask is None:
        return x.mean(dim=dim, keepdim=True)
    m = mask.to(x.dtype).unsqueeze(-1)
    total = (x * m).sum(dim=dim, keepdim=True)
    count = m.sum(dim=dim, keepdim=True)
    return total / count.clamp_min(1.0)


def remove_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                dim: int = -2) -> torch.Tensor:
    """Project ``x`` onto the zero-CoM subspace per graph; padded rows -> 0."""
    centred = x - masked_mean(x, mask, dim=dim)
    if mask is not None:
        centred = centred * mask.to(x.dtype).unsqueeze(-1)
    return centred
