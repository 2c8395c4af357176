"""E(3)-equivariant graph network over padded graphs, dense topology.

Node i aggregates messages from every other real node j. Each layer:

  * edge MLP ``mlp_m``: Linear-SiLU-Linear-SiLU on ``[h_i | h_j | d2]``,
    gated by a sigmoid attention head, summed over j;
  * node MLP ``mlp_h``: Linear-SiLU-Linear on ``[h | sum_j m_ij]``;
  * coordinate MLP ``mlp_x``: Linear-SiLU-Linear-SiLU-Linear to one scalar
    per edge, ``x_i += sum_j (x_i - x_j) * s_ij / (|x_i - x_j| + 1)``.

The first Linear of each edge MLP is evaluated by node projections:
``W [h_i | h_j | d2] + b = (W_i h_i + b) + W_j h_j + w_d d2``, so the
O(N^2) work is only the second layer and the heads, which ``edge_fn`` does
(by default ``ops.egcl_pair.egcl_pair_edges``: the CUDA kernel on the card,
its plain statement on the CPU). Parameters keep the flax layout: the fused
first-layer ``kernel [2H+1, F]`` and the ``[in, out]`` second-layer kernels
the edge kernel reads; only the node MLP uses ``nn.Linear``. Geometry stays
float32; the MLP matmuls run in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

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

    def node_projections(self, h_c: torch.Tensor):
        """(``h W_i + b``, ``h W_j``), each ``[B, N, F]`` in h_c's dtype."""
        k = self.kernel.to(h_c.dtype)
        return (h_c @ k[: self.hdim] + self.bias.to(h_c.dtype),
                h_c @ k[self.hdim : 2 * self.hdim])

    def d2_row(self, dtype: torch.dtype) -> torch.Tensor:
        """The ``[1, F]`` row that multiplies the squared distance."""
        return self.kernel[2 * self.hdim :].to(dtype)


class _KernelDense(nn.Module):
    """Linear with an ``[in, out]`` kernel (the layout the edge kernel reads)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = _kernel_param(in_features, out_features, device)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))


class _VectorHead(_KernelDense):
    """Dense to one output (``kernel [F, 1]``, ``bias [1]``). The edge
    function applies it as a multiply-reduce in its epilogue."""

    def __init__(self, features: int, device=None):
        super().__init__(features, 1, device)


class EGCL(nn.Module):
    """One equivariant graph convolution layer (dense, masked)."""

    def __init__(self, hdim: int, m_hidden: int, m_out: int, x_hidden: int,
                 h_hidden: int, h_out: int,
                 compute_dtype: torch.dtype = torch.float32,
                 edge_fn: Callable = egcl_pair_edges, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.edge_fn = edge_fn
        self.mlp_m_dense0 = _EdgeFirstLayer(m_hidden, hdim, device)
        self.mlp_m_dense1 = _KernelDense(m_hidden, m_out, device)
        self.attention_dense = _VectorHead(m_out, device)
        self.mlp_x_dense0 = _EdgeFirstLayer(x_hidden, hdim, device)
        self.mlp_x_dense1 = _KernelDense(x_hidden, x_hidden, device)
        self.mlp_x_dense2 = _VectorHead(x_hidden, device)
        self.mlp_h_dense0 = nn.Linear(hdim + m_out, h_hidden, device=device)
        self.mlp_h_dense1 = nn.Linear(h_hidden, h_out, device=device)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                node_mask: torch.Tensor):
        """h ``[B, N, H]``, x ``[B, N, 3]``, node_mask ``[B, N]`` ->
        (h', x'). Padded nodes keep their x and get masked-out messages."""
        dt = self.compute_dtype
        f32 = torch.float32
        h_c = h.to(dt)
        am_i, am_j = self.mlp_m_dense0.node_projections(h_c)
        ax_i, ax_j = self.mlp_x_dense0.node_projections(h_c)
        m_sum, x_new = self.edge_fn(
            am_i, am_j, ax_i, ax_j,
            x.to(f32).contiguous(), node_mask.to(f32).unsqueeze(-1),
            self.mlp_m_dense0.d2_row(dt), self.mlp_x_dense0.d2_row(dt),
            self.mlp_m_dense1.kernel.to(dt),
            self.mlp_m_dense1.bias.to(f32).unsqueeze(0),
            self.attention_dense.kernel.to(f32),
            self.attention_dense.bias.to(f32).unsqueeze(0),
            self.mlp_x_dense1.kernel.to(dt),
            self.mlp_x_dense1.bias.to(f32).unsqueeze(0),
            self.mlp_x_dense2.kernel.to(f32),
            self.mlp_x_dense2.bias.to(f32).unsqueeze(0),
        )
        h0, h1 = self.mlp_h_dense0, self.mlp_h_dense1
        cat = torch.cat([h_c, m_sum.to(dt)], dim=-1)
        h_new = F.linear(F.silu(F.linear(cat, h0.weight.to(dt), h0.bias.to(dt))),
                         h1.weight.to(dt), h1.bias.to(dt))
        return h_new.to(h.dtype), x_new.to(x.dtype)


class EquivariantGNN(nn.Module):
    """Stack of L EGCLs, named ``egcl_0`` .. ``egcl_{L-1}``."""

    def __init__(self, L: int, hdim: int, m_hidden: int, m_out: int,
                 x_hidden: int, h_hidden: int,
                 compute_dtype: torch.dtype = torch.float32,
                 edge_fn: Callable = egcl_pair_edges, device=None):
        super().__init__()
        self.L = L
        for l in range(L):
            self.add_module(f"egcl_{l}", EGCL(
                hdim, m_hidden, m_out, x_hidden, h_hidden, hdim,
                compute_dtype=compute_dtype, edge_fn=edge_fn, device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                node_mask: torch.Tensor):
        for l in range(self.L):
            h, x = getattr(self, f"egcl_{l}")(h, x, node_mask)
        return h, x
