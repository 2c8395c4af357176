"""E(3)-equivariant graph network over padded graphs.

Node i aggregates messages from its sources j: every other real node (the
dense topology) or its K nearest neighbours (kNN lists, the large-cell
topology). Each layer:

  * edge MLP ``mlp_m``: Linear-SiLU-Linear-SiLU on ``[h_i | h_j | d2]``,
    gated by a sigmoid attention head, summed over j;
  * node MLP ``mlp_h``: Linear-SiLU-Linear on ``[h | sum_j m_ij]``;
  * coordinate MLP ``mlp_x``: Linear-SiLU-Linear-SiLU-Linear to one scalar
    per edge, ``x_i += sum_j (x_i - x_j) * s_ij / (|x_i - x_j| + 1)``.

The first Linear of each edge MLP is evaluated by node projections:
``W [h_i | h_j | d2] + b = (W_i h_i + b) + W_j h_j + w_d d2``. On the dense
route the per-edge work is only the second layer and the heads, which
``edge_fn`` does (by default ``ops.egcl_pair.egcl_pair_edges``); on the kNN
route ``knn_edge_fn`` (by default ``ops.egcl_knn.egcl_knn_edges``) also
computes ``W_j h_j`` per edge from the gathered ``h_j``. Both are the CUDA
kernel on the card and its plain statement on the CPU.

Two large-cell options compose outside the edge function, on both routes:
``virtual_node`` adds an O(N) global-context channel (a virtual node at the
masked centre of mass, computed from the layer's input h and x) to the
message sum and the coordinate update; ``h_residual`` makes the node update
``h + mlp_h(...)`` wherever the widths match, which in this stack is every
layer, layer 0 included.

Parameters keep the flax layout: the fused first-layer ``kernel [2H+1, F]``
and the ``[in, out]`` kernels the edge kernels and the virtual-node channel
read; only the node MLP uses ``nn.Linear``. Geometry stays float32; the MLP
matmuls run in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_model_tpu_torch.ops.com import masked_mean
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges


def _kernel_param(fan_in: int, fan_out: int, device) -> nn.Parameter:
    """An ``[in, out]`` kernel, drawn N(0, 1/fan_in) until weights load."""
    w = torch.empty(fan_in, fan_out, device=device)
    nn.init.normal_(w, std=1.0 / math.sqrt(fan_in))
    return nn.Parameter(w)


class _EdgeFirstLayer(nn.Module):
    """First Linear of an edge MLP, as fused ``kernel [2H+1, F]`` / ``bias``,
    applied by node projections."""

    def __init__(self, features: int, hdim: int, device=None):
        super().__init__()
        self.hdim = hdim
        self.kernel = _kernel_param(2 * hdim + 1, features, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def i_projection(self, h_c: torch.Tensor) -> torch.Tensor:
        """``h W_i + b`` ``[B, N, F]`` in h_c's dtype."""
        k = self.kernel[: self.hdim].to(h_c.dtype)
        return h_c @ k + self.bias.to(h_c.dtype)

    def j_kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """The ``[H, F]`` block ``W_j`` that multiplies the source's h."""
        return self.kernel[self.hdim : 2 * self.hdim].to(dtype)

    def node_projections(self, h_c: torch.Tensor):
        """(``h W_i + b``, ``h W_j``), each ``[B, N, F]`` in h_c's dtype."""
        return self.i_projection(h_c), h_c @ self.j_kernel(h_c.dtype)

    def d2_row(self, dtype: torch.dtype) -> torch.Tensor:
        """The ``[1, F]`` row that multiplies the squared distance."""
        return self.kernel[2 * self.hdim :].to(dtype)


class _GlobalFirstLayer(nn.Module):
    """Linear over ``[h | h_v | r2]`` as the fused ``kernel [H+V+1, F]`` /
    ``bias``, with the graph-constant ``h_v [B, 1, V]`` projected once per
    graph and broadcast over the nodes."""

    def __init__(self, features: int, hdim: int, vdim: int, device=None):
        super().__init__()
        self.hdim, self.vdim = hdim, vdim
        self.kernel = _kernel_param(hdim + vdim + 1, features, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, h, h_v, r2):
        """h ``[B, N, H]``, h_v ``[B, 1, V]``, r2 ``[B, N, 1]``, all in the
        compute dtype -> ``[B, N, F]``."""
        k = self.kernel.to(h.dtype)
        hv = self.hdim + self.vdim
        return (h @ k[: self.hdim] + h_v @ k[self.hdim : hv] + r2 * k[hv]
                + self.bias.to(h.dtype))


class _KernelDense(nn.Module):
    """Linear with an ``[in, out]`` kernel (the layout the edge kernels
    read; the virtual-node channel applies it in ``forward``)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = _kernel_param(in_features, out_features, device)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.kernel.to(v.dtype) + self.bias.to(v.dtype)


class _VectorHead(_KernelDense):
    """Dense to one output (``kernel [F, 1]``, ``bias [1]``). The edge
    functions apply it as a multiply-reduce in their epilogue; ``forward``
    is the same multiply-reduce."""

    def __init__(self, features: int, device=None):
        super().__init__(features, 1, device)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        w = self.kernel[:, 0].to(v.dtype)
        return (v * w).sum(dim=-1, keepdim=True) + self.bias.to(v.dtype)


class EGCL(nn.Module):
    """One equivariant graph convolution layer (masked, dense or kNN)."""

    def __init__(self, hdim: int, m_hidden: int, m_out: int, x_hidden: int,
                 h_hidden: int, h_out: int,
                 compute_dtype: torch.dtype = torch.float32,
                 edge_fn: Callable = egcl_pair_edges,
                 knn_edge_fn: Callable = egcl_knn_edges,
                 h_residual: bool = False, virtual_node: bool = False,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.edge_fn = edge_fn
        self.knn_edge_fn = knn_edge_fn
        self.h_residual = h_residual
        self.virtual_node = virtual_node
        self.mlp_m_dense0 = _EdgeFirstLayer(m_hidden, hdim, device)
        self.mlp_m_dense1 = _KernelDense(m_hidden, m_out, device)
        self.attention_dense = _VectorHead(m_out, device)
        self.mlp_x_dense0 = _EdgeFirstLayer(x_hidden, hdim, device)
        self.mlp_x_dense1 = _KernelDense(x_hidden, x_hidden, device)
        self.mlp_x_dense2 = _VectorHead(x_hidden, device)
        self.mlp_h_dense0 = nn.Linear(hdim + m_out, h_hidden, device=device)
        self.mlp_h_dense1 = nn.Linear(h_hidden, h_out, device=device)
        if virtual_node:
            self.vnode_in = _KernelDense(hdim + 1, m_hidden, device)
            self.vnode_pool = _KernelDense(m_hidden, m_out, device)
            self.vnode_out = _GlobalFirstLayer(m_out, hdim, m_out, device)
            self.vnode_x = _GlobalFirstLayer(x_hidden, hdim, m_out, device)
            self.vnode_x_head = _VectorHead(x_hidden, device)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                node_mask: torch.Tensor, edges=None):
        """h ``[B, N, H]``, x ``[B, N, 3]``, node_mask ``[B, N]``; edges
        None (dense) or ``(idx [B, N, K] int32, edge_mask [B, N, K])`` ->
        (h', x'). Padded nodes keep their x and get masked-out messages."""
        dt = self.compute_dtype
        f32 = torch.float32
        h_c = h.to(dt)
        x_f = x.to(f32).contiguous()
        m_first, x_first = self.mlp_m_dense0, self.mlp_x_dense0
        heads = (
            self.mlp_m_dense1.kernel.to(dt),
            self.mlp_m_dense1.bias.to(f32).unsqueeze(0),
            self.attention_dense.kernel.to(f32),
            self.attention_dense.bias.to(f32).unsqueeze(0),
            self.mlp_x_dense1.kernel.to(dt),
            self.mlp_x_dense1.bias.to(f32).unsqueeze(0),
            self.mlp_x_dense2.kernel.to(f32),
            self.mlp_x_dense2.bias.to(f32).unsqueeze(0),
        )
        if edges is None:
            am_i, am_j = m_first.node_projections(h_c)
            ax_i, ax_j = x_first.node_projections(h_c)
            m_sum, x_new = self.edge_fn(
                am_i, am_j, ax_i, ax_j, x_f,
                node_mask.to(f32).unsqueeze(-1),
                m_first.d2_row(dt), x_first.d2_row(dt), *heads)
        else:
            idx, edge_mask = edges
            m_sum, x_new = self.knn_edge_fn(
                m_first.i_projection(h_c), x_first.i_projection(h_c), h_c,
                x_f, idx, edge_mask, m_first.j_kernel(dt),
                x_first.j_kernel(dt), m_first.d2_row(dt), x_first.d2_row(dt),
                *heads)
        if self.virtual_node:
            vn_msg, x_vn = self._virtual_channel(h_c, x_f, node_mask)
            m_sum = m_sum + vn_msg.to(m_sum.dtype)
            x_new = x_new + x_vn
        h0, h1 = self.mlp_h_dense0, self.mlp_h_dense1
        cat = torch.cat([h_c, m_sum.to(dt)], dim=-1)
        h_new = F.linear(F.silu(F.linear(cat, h0.weight.to(dt), h0.bias.to(dt))),
                         h1.weight.to(dt), h1.bias.to(dt))
        if self.h_residual and h_new.shape[-1] == h_c.shape[-1]:
            h_new = h_new + h_c
        return h_new.to(h.dtype), x_new.to(x.dtype)

    def _virtual_channel(self, h_c, x_f, node_mask):
        """Messages through a virtual node at the masked centre of mass:
        (vn_msg ``[B, N, m_out]`` compute dtype, x_vn ``[B, N, 3]`` float32),
        added to the message sum and to the coordinates."""
        dt, f32 = h_c.dtype, torch.float32
        m3 = node_mask.unsqueeze(-1).to(f32)
        m3_c = m3.to(dt)
        h_m = h_c * m3_c
        diff = (x_f - masked_mean(x_f, node_mask)) * m3          # [B,N,3]
        r2_f = (diff * diff).sum(dim=-1, keepdim=True)           # [B,N,1]
        r2 = r2_f.to(dt)
        u = F.silu(self.vnode_in(torch.cat([h_m, r2], dim=-1))) * m3_c
        h_v = F.silu(self.vnode_pool(masked_mean(u, node_mask)))  # [B,1,V]
        vn_msg = self.vnode_out(h_m, h_v, r2) * m3_c
        s_v = self.vnode_x_head(F.silu(self.vnode_x(h_m, h_v, r2)))
        norm = torch.sqrt(torch.where(m3 > 0, r2_f.clamp_min(1e-12),
                                      torch.ones_like(r2_f)))
        return vn_msg, diff * (s_v.to(f32) / (norm + 1.0)) * m3


class EquivariantGNN(nn.Module):
    """Stack of L EGCLs, named ``egcl_0`` .. ``egcl_{L-1}``."""

    def __init__(self, L: int, hdim: int, m_hidden: int, m_out: int,
                 x_hidden: int, h_hidden: int,
                 compute_dtype: torch.dtype = torch.float32,
                 edge_fn: Callable = egcl_pair_edges,
                 knn_edge_fn: Callable = egcl_knn_edges,
                 h_residual: bool = False, virtual_node: bool = False,
                 device=None):
        super().__init__()
        self.L = L
        for l in range(L):
            self.add_module(f"egcl_{l}", EGCL(
                hdim, m_hidden, m_out, x_hidden, h_hidden, hdim,
                compute_dtype=compute_dtype, edge_fn=edge_fn,
                knn_edge_fn=knn_edge_fn, h_residual=h_residual,
                virtual_node=virtual_node, device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                node_mask: torch.Tensor, edges=None):
        for l in range(self.L):
            h, x = getattr(self, f"egcl_{l}")(h, x, node_mask, edges)
        return h, x
