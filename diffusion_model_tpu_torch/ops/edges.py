"""Topology of padded graphs (the dense pair grid of the real atoms, or
fixed-degree k-nearest-neighbour lists for large cells), and the radial
basis of an edge's length."""

from __future__ import annotations

import torch

from diffusion_model_tpu_torch.ops.angles import pairwise_sq_dist
from diffusion_model_tpu_torch.ops.schedules import linspace_f32


def dense_pair_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """``[..., N, N]`` float32 mask: both endpoints real and i != j."""
    m = node_mask.to(torch.float32)
    pair = m[..., :, None] * m[..., None, :]
    n = node_mask.shape[-1]
    eye = torch.eye(n, dtype=pair.dtype, device=pair.device)
    return pair * (1.0 - eye)


def knn_edges(pos: torch.Tensor, node_mask: torch.Tensor, k: int):
    """The ``k`` nearest real neighbours of every node.

    Args:
      pos: ``[..., N, 3]`` positions; node_mask: ``[..., N]``.

    Returns:
      (idx ``[..., N, K]`` int32 neighbour indices, nearest first,
       edge_mask ``[..., N, K]`` float32). Self and padded nodes are never
      neighbours; slots past a node's real neighbours are masked, and a
      padded node's row is all masked (its indices are arbitrary).
    """
    n = pos.shape[-2]
    d2 = pairwise_sq_dist(pos)
    m = node_mask.to(torch.float32)
    pair_ok = m[..., :, None] * m[..., None, :]
    eye = torch.eye(n, dtype=torch.float32, device=pos.device)
    invalid = (1.0 - pair_ok) + eye
    big = torch.finfo(d2.dtype).max
    d2_masked = torch.where(invalid > 0, torch.full_like(d2, big), d2)
    _, idx = torch.topk(-d2_masked, k, dim=-1)
    edge_mask = (torch.gather(invalid, -1, idx) == 0).to(torch.float32)
    edge_mask = edge_mask * m[..., :, None]
    return idx.to(torch.int32), edge_mask


def rbf_features(d2: torch.Tensor, valid: torch.Tensor, num: int,
                 rmax: float) -> torch.Tensor:
    """Gaussian radial basis of the edge distance, ``[..., num]`` float32,
    as ``diffusion_model_tpu/nn/egnn.py`` ``_rbf_features``.

    ``d2 [..., 1]`` is the squared distance, ``valid [..., 1]`` a boolean
    mask of real edges. The sqrt is taken of 1 off the mask (its gradient at
    d2 = 0 is infinite, and 0 * inf would poison the backward), and the
    distance is 0 there. Centres at ``linspace(0, rmax, num)``, width the
    centre spacing ``rmax / (num - 1)``; the value ``exp(-z^2 / 2)``."""
    f32 = torch.float32
    d2 = d2.to(f32)
    d = torch.sqrt(torch.where(valid, d2.clamp_min(1e-12),
                               torch.ones_like(d2)))
    d = torch.where(valid, d, torch.zeros_like(d))
    centres = linspace_f32(0.0, rmax, num, device=d.device)
    z = (d - centres) / (rmax / (num - 1))
    return torch.exp(-0.5 * z * z)
