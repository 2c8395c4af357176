"""Batched Kabsch alignment and RMSD, as ``diffusion_model_tpu/ops/kabsch.py``:
the optimal rotation and translation between two point sets, with the
determinant's sign fix for a proper rotation, masked for padded sets.

float32 throughout. The 3 x 3 SVD is ``torch.linalg.svd`` (not a Pallas
kernel in the JAX package either); the small products are broadcast sums,
so no TF32 matmul can touch the geometry.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffusion_model_tpu_torch.ops.com import masked_mean


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes as a broadcast sum."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def kabsch(p: torch.Tensor, q: torch.Tensor,
           mask: Optional[torch.Tensor] = None):
    """Optimal rigid alignment of ``p`` onto ``q`` (``[..., N, 3]``; mask
    ``[..., N]``).

    Returns ``(rotation [..., 3, 3], translation [..., 1, 3], aligned_p)``
    with ``aligned_p = p_centred @ R^T + q_mean``.
    """
    p_mean = masked_mean(p, mask)
    q_mean = masked_mean(q, mask)
    p_c = p - p_mean
    q_c = q - q_mean
    if mask is not None:
        m = mask.to(p.dtype).unsqueeze(-1)
        p_c = p_c * m
        q_c = q_c * m
    h = _mm(p_c.transpose(-1, -2), q_c)
    # a set that is not finite aligns to NaN, as in the JAX package and on
    # the card: the CPU's SVD raises on such a matrix, so it gets zeros and
    # its factors are NaN
    bad = ~torch.isfinite(h).all(dim=-1, keepdim=True).all(dim=-2,
                                                            keepdim=True)
    u, _, vt = torch.linalg.svd(torch.where(bad, torch.zeros_like(h), h),
                                full_matrices=False)
    u = torch.where(bad, torch.full_like(u, float("nan")), u)
    vt = torch.where(bad, torch.full_like(vt, float("nan")), vt)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(_mm(v, ut)))
    one = torch.ones_like(d)
    flip = torch.stack([one, one, d], dim=-1).unsqueeze(-2)
    r = _mm(v * flip, ut)
    aligned = _mm(p_c, r.transpose(-1, -2)) + q_mean
    return r, q_mean, aligned


def kabsch_rmsd(p: torch.Tensor, q: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSD between ``p`` and ``q`` after optimal rigid alignment, over the
    masked-in points."""
    _, _, aligned = kabsch(p, q, mask)
    sq = ((aligned - q) ** 2).sum(dim=-1)
    if mask is not None:
        m = mask.to(p.dtype)
        return torch.sqrt((sq * m).sum(dim=-1)
                          / m.sum(dim=-1).clamp_min(1.0))
    return torch.sqrt(sq.mean(dim=-1))
