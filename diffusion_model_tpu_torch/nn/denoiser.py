"""The conditional denoiser: feature assembly + EGNN -> (eps_x, eps_h).

    h_in   = [species_t(A) | compressed spectrum | exO | radius | t/T]
    h', x' = EGNN(h_in, pos_t)
    eps_x  = remove_mean(x' - pos_t)   (per graph, masked)
    eps_h  = h'[..., :A]

Everything is padded and masked. The topology is the dense pair grid of the
real nodes, which the edge function derives from ``node_mask``, or the kNN
lists ``(idx, edge_mask)`` the caller passes as ``edges``.

With ``global_radius_feature`` the column ``radius`` is ``log1p`` of each
real node's distance to the masked centre of mass, times the top-level
``radius_feature_gate [1]`` (zero at init: the untrained model is the one
without the feature). Its place, after exO and before t/T, is the first
layers' row order, which loaded weights fix.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.nn.compressor import SpectrumCompressor
from diffusion_model_tpu_torch.nn.egnn import EquivariantGNN
from diffusion_model_tpu_torch.ops.com import remove_mean
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges


class DiffusionDenoiser(nn.Module):
    """Parameters are drawn as ``DiffusionDenoiser.init`` of the JAX package
    draws them (names and shapes of its tree, flax's initialisers) and are
    trainable; ``api.denoiser_from_params`` freezes the weights it loads
    for serving."""

    def __init__(self, cfg: Config, edge_fn: Callable = egcl_pair_edges,
                 knn_edge_fn: Callable = egcl_knn_edges, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.spectrum_compressor = None
        if cfg.conditional and cfg.to_compress_spectrum:
            self.spectrum_compressor = SpectrumCompressor(
                cfg.spectrum_size, tuple(cfg.compressor_hidden_dim),
                cfg.compressed_spectrum_size, compute_dtype=dt, device=device)
        self.egnn = EquivariantGNN(
            cfg.L, cfg.h_size, cfg.m_hidden_size, cfg.m_size,
            cfg.x_hidden_size, cfg.h_hidden_size, compute_dtype=dt,
            edge_fn=edge_fn, knn_edge_fn=knn_edge_fn,
            h_residual=cfg.h_residual, virtual_node=cfg.virtual_node,
            zero_init_x=cfg.zero_init_x, h_init_scale=cfg.h_init_scale,
            edge_rbf=cfg.edge_rbf, edge_rbf_rmax=cfg.edge_rbf_rmax,
            compat_scalar_norm=cfg.compat_scalar_norm,
            remat_egcl=cfg.remat_egcl, device=device)
        if cfg.global_radius_feature:
            self.radius_feature_gate = nn.Parameter(
                torch.zeros(1, device=device))

    def forward(self, species_t, pos_t, spectrum, exo, t_norm, node_mask,
                edges=None):
        """Predict the joint noise.

        Args:
          species_t: ``[B, N, A]`` noisy species channel.
          pos_t: ``[B, N, 3]`` noisy positions.
          spectrum: ``[B, N, S]`` per-node conditioning spectra.
          exo: ``[B, N, 1]`` excited-atom indicator.
          t_norm: ``[B, N, 1]`` diffusion time t/T.
          node_mask: ``[B, N]``.
          edges: None for the dense topology, or the kNN lists
            ``(idx [B, N, K] int32, edge_mask [B, N, K])``.

        Returns:
          (eps_x ``[B, N, 3]`` CoM-free masked, eps_h ``[B, N, A]`` masked).
        """
        cfg = self.cfg
        feats = [species_t]
        if cfg.conditional:
            feats.append(spectrum if self.spectrum_compressor is None
                         else self.spectrum_compressor(spectrum))
        if cfg.give_exO:
            feats.append(exo)
        if cfg.global_radius_feature:
            feats.append(radius_feature(pos_t, node_mask)
                         * self.radius_feature_gate.to(pos_t.dtype))
        feats.append(t_norm)
        h_in = torch.cat(feats, dim=-1)
        h_out, x_out = self.egnn(h_in, pos_t, node_mask, edges)
        mask3 = node_mask.unsqueeze(-1).to(pos_t.dtype)
        eps_x = remove_mean((x_out - pos_t) * mask3, node_mask)
        eps_h = h_out[..., : cfg.atom_type_size] * mask3
        return eps_x, eps_h


def radius_feature(pos: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """``[B, N, 1]``: ``log1p`` of each real node's distance to the masked
    centre of mass (the node count floored at 1), 0 on padded nodes; the
    sqrt of ``max(d2, 1e-12)``, so a node at the centre has a finite
    gradient. E(3)-invariant."""
    m3 = node_mask.unsqueeze(-1).to(pos.dtype)
    count = node_mask.to(pos.dtype).sum(dim=-1, keepdim=True).clamp_min(
        1.0)[..., None]
    com = (pos * m3).sum(dim=1, keepdim=True) / count
    d2 = ((pos - com) ** 2).sum(dim=-1, keepdim=True)
    return torch.log1p(torch.sqrt(d2.clamp_min(1e-12))) * m3
