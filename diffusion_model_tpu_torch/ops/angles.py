"""Pairwise geometry on padded coordinates."""

from __future__ import annotations

import torch


def pairwise_sq_dist(pos: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances ``[..., N, N]`` from ``[..., N, 3]``."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    return (diff * diff).sum(dim=-1)
