"""Pairwise geometry on padded coordinates, and the CN2 angle and bonds.

Node 0 is the excited oxygen (exO); for a CN2 graph nodes 1 and 2 are its
two Si neighbours. Norms are float32 ``sqrt`` of the sum of squares, summed
in a fixed order.
"""

from __future__ import annotations

import math

import torch


def pairwise_sq_dist(pos: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances ``[..., N, N]`` from ``[..., N, 3]``."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    return (diff * diff).sum(dim=-1)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (of size 3), ``(x² + y²) + z²``
    then ``sqrt``, the same rounding on every device."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def cn2_angle_deg(pos: torch.Tensor) -> torch.Tensor:
    """Si-exO-Si angle in degrees at node 0 between the bonds to nodes 1
    and 2, for ``[..., >=3, 3]`` positions."""
    v1 = pos[..., 1, :] - pos[..., 0, :]
    v2 = pos[..., 2, :] - pos[..., 0, :]
    cos = (v1 * v2).sum(dim=-1) / (norm3(v1) * norm3(v2))
    return torch.arccos(cos.clamp(-1.0, 1.0)) * (180.0 / math.pi)


def cn2_bond_lengths(pos: torch.Tensor):
    """Bond lengths exO-node 1 and exO-node 2."""
    return (norm3(pos[..., 1, :] - pos[..., 0, :]),
            norm3(pos[..., 2, :] - pos[..., 0, :]))
