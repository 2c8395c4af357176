"""Dense topology of padded graphs: every ordered pair of real atoms."""

from __future__ import annotations

import torch


def dense_pair_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """``[..., N, N]`` float32 mask: both endpoints real and i != j."""
    m = node_mask.to(torch.float32)
    pair = m[..., :, None] * m[..., None, :]
    n = node_mask.shape[-1]
    eye = torch.eye(n, dtype=pair.dtype, device=pair.device)
    return pair * (1.0 - eye)
