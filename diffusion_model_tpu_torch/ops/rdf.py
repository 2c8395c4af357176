"""Radial distribution function (RDF) from the excited oxygen, batched.

``rdf_from_exo`` takes ``[G, N, 3]`` and gives ``[G, nbins]``, as
``diffusion_model_tpu.ops.rdf.rdf_from_exo`` under ``vmap``:

  * distances from node 0 in float32 (``ops.angles.norm3``); a distance
    ``d`` falls in bin ``floor(d / dr) - 1``, so ``d / dr`` is a true
    division by a float32 tensor (PyTorch's CUDA kernels multiply by the
    reciprocal of a Python scalar, which moves a count at a bin's edge);
  * counts by ``index_add_`` of 0/1 weights, exact in float32, normalised
    by the ideal-gas shell density ``4 pi rho r² dr`` with
    ``rho = N / (4/3 pi R³)``;
  * Gaussian smoothing as scipy's ``gaussian_filter1d`` (truncate 4,
    reflect boundary): a gather of the reflect-padded windows and a sum.
    Not ``F.conv1d``: cuDNN may run a float32 convolution in TF32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from diffusion_model_tpu_torch.ops.angles import norm3


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth_1d(y: torch.Tensor, sigma: float,
                       truncate: float = 4.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter1d(y, sigma, mode='reflect')`` over
    the last axis: ``out[i] = sum_k padded[i + k] * kernel[k]``."""
    kernel = torch.from_numpy(_gaussian_kernel(sigma, truncate)).to(y.device)
    taps = kernel.shape[0]
    radius = (taps - 1) // 2
    # reflect: (d c b a | a b c d | d c b a)
    left = y[..., :radius].flip(-1)
    right = y[..., y.shape[-1] - radius:].flip(-1)
    padded = torch.cat([left, y, right], dim=-1)
    window = padded.shape[-1] - taps + 1
    idx = (torch.arange(window, device=y.device)[:, None]
           + torch.arange(taps, device=y.device)[None, :])
    return (padded[..., idx] * kernel).sum(dim=-1)


def rdf_bin_counts(pos: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   r_max: float = 5.0, dr: float = 0.01) -> torch.Tensor:
    """Counts ``[G, nbins]`` (float32, exact) of the distances from node 0
    to the other real nodes with ``(k+1) dr < d < (k+2) dr`` in bin k."""
    nbins = int(round(r_max / dr))
    g = pos.shape[0]
    d = norm3(pos[:, 1:] - pos[:, :1])
    if mask is None:
        valid = torch.ones_like(d)
    else:
        m = mask.to(torch.float32)
        valid = m[:, 1:] * m[:, :1]
    bin_idx = torch.floor(d / torch.full_like(d, dr)).to(torch.int64) - 1
    in_range = (bin_idx >= 0) & (bin_idx < nbins)
    weights = valid * in_range.to(torch.float32)
    flat = (bin_idx.clamp(0, nbins - 1)
            + nbins * torch.arange(g, device=pos.device)[:, None])
    counts = torch.zeros(g * nbins, dtype=torch.float32, device=pos.device)
    counts.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    return counts.reshape(g, nbins)


def rdf_from_exo(pos: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 sigma: float = 5.0, r_max: float = 5.0, dr: float = 0.01,
                 normalize: bool = False) -> torch.Tensor:
    """Smoothed RDF ``[G, round(r_max/dr)]`` of distances from node 0.

    Args:
      pos: ``[G, N, 3]`` float32 positions (node 0 = exO).
      mask: optional ``[G, N]`` validity mask of padded graphs.
    """
    pos = pos.to(torch.float32)
    counts = rdf_bin_counts(pos, mask, r_max, dr)
    nbins = counts.shape[-1]
    if mask is None:
        num_atom = torch.full((pos.shape[0], 1), float(pos.shape[1]),
                              device=pos.device)
    else:
        num_atom = mask.to(torch.float32).sum(dim=-1, keepdim=True)
    rho = num_atom / torch.full_like(num_atom,
                                     4.0 / 3.0 * math.pi * r_max ** 3)
    r = (torch.arange(nbins, dtype=torch.float32, device=pos.device)
         + 1.0) * dr
    g = counts / (4.0 * math.pi * rho * (r * r) * dr)
    g = gaussian_smooth_1d(g, sigma)
    if normalize:
        g = g / g.max(dim=-1, keepdim=True).values
    return g


def rdf_cos_similarity(rdf_a: torch.Tensor,
                       rdf_b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of two RDF curves over the last axis."""
    return (rdf_a * rdf_b).sum(dim=-1) / (
        torch.linalg.vector_norm(rdf_a, dim=-1)
        * torch.linalg.vector_norm(rdf_b, dim=-1))
