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
kernel on the card and its plain statement on the CPU. Where the layer's
widths lie outside the kernels' limits (``edge_route``), the edge work runs
as the plain statement on any device, in chunks of targets
(``plain_edges``), and ``plain_edge_calls`` counts it.

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

from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.com import masked_mean
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges

# The most elements one ``[B', T, N|K, F]`` edge intermediate of the plain
# route may hold (float32: 64 MiB); ``plain_edges`` cuts its work to fit.
PLAIN_EDGE_ELEMENTS = 1 << 24
# Calls of the plain route in this process; only ``plain_edges`` adds to it.
plain_edge_calls = 0


def edge_route(m_hidden: int, x_hidden: int, m_out: int, dtype: torch.dtype,
               hdim: int | None = None) -> str:
    """The route of an EGCL's edge work, from its widths and compute dtype
    alone, before any call: ``"kernel"`` (the layer's edge function: the
    CUDA kernel on the card) or ``"plain"`` (``plain_edges``). ``"plain"``
    exactly where a shape limit of the kernels fails: the first-layer widths
    differ or are not multiples of 64, ``m_out`` is not a multiple of 64 or
    exceeds 256, a bfloat16 first layer is wider than ``MAX_F1``, or (kNN,
    ``hdim`` given) the node width exceeds ``MAX_H``. What the kernel refuses
    for any other reason (dtype, device, layout, grad) it still refuses. The
    JAX package routes by config the same way (``api.sampling_uses_pallas``);
    its XLA path takes any width. On the CPU both routes are the plain
    statement; only ``"plain"`` cuts it into chunks and counts the call."""
    fits = (m_hidden == x_hidden and m_hidden % 64 == 0 and m_out % 64 == 0
            and m_out <= 256
            and not (dtype == torch.bfloat16 and m_hidden > egcl_pair.MAX_F1)
            and (hdim is None or 1 <= hdim <= egcl_knn.MAX_H))
    return "kernel" if fits else "plain"


def plain_edges(reference: Callable, args: tuple, sources: int, width: int,
                budget: int = PLAIN_EDGE_ELEMENTS):
    """``reference`` (``egcl_pair_edges_reference`` or
    ``egcl_knn_edges_reference``) over ``args``, in chunks of whole graphs,
    or of one graph's targets where a graph is too large, so that no
    ``[graphs, targets, sources, width]`` intermediate exceeds ``budget``
    elements. The first six arguments of both are per graph. Returns
    (m_sum [B,N,Fm], x_out [B,N,3]) float32, as the reference does."""
    global plain_edge_calls
    plain_edge_calls += 1
    b, n = args[0].shape[:2]
    per_target = sources * width
    graphs = max(1, min(b, budget // max(n * per_target, 1)))
    targets = n if graphs * n * per_target <= budget else max(
        1, budget // per_target)
    m_sum = x_out = None
    for g0 in range(0, b, graphs):
        g = slice(g0, min(b, g0 + graphs))
        per_graph = tuple(a[g] for a in args[:6])
        for t0 in range(0, n, targets):
            t = slice(t0, min(n, t0 + targets))
            m, x = reference(*per_graph, *args[6:], targets=t)
            if m_sum is None:
                m_sum = m.new_empty((b, n, m.shape[-1]))
                x_out = x.new_empty((b, n, 3))
            m_sum[g, t] = m
            x_out[g, t] = x
    return m_sum, x_out


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

    def cast(self, dt: torch.dtype) -> tuple:
        """(``W_i [H, F]``, ``b [F]``, ``W_j [H, F]``, the d2 row ``[1, F]``)
        in ``dt``: ``h W_i + b`` and ``h W_j`` are the node projections."""
        k, hd = self.kernel, self.hdim
        return (k[:hd].to(dt), self.bias.to(dt), k[hd : 2 * hd].to(dt),
                k[2 * hd :].to(dt))


class _GlobalFirstLayer(nn.Module):
    """Linear over ``[h | h_v | r2]`` as the fused ``kernel [H+V+1, F]`` /
    ``bias``, with the graph-constant ``h_v [B, 1, V]`` projected once per
    graph and broadcast over the nodes."""

    def __init__(self, features: int, hdim: int, vdim: int, device=None):
        super().__init__()
        self.hdim, self.vdim = hdim, vdim
        self.kernel = _kernel_param(hdim + vdim + 1, features, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def cast(self, dt: torch.dtype) -> tuple:
        return self.kernel.to(dt), self.bias.to(dt)

    def forward(self, h, h_v, r2, weights):
        """h ``[B, N, H]``, h_v ``[B, 1, V]``, r2 ``[B, N, 1]``, all in the
        compute dtype -> ``[B, N, F]``; ``weights`` is ``cast(h.dtype)``."""
        k, b = weights
        hv = self.hdim + self.vdim
        return h @ k[: self.hdim] + h_v @ k[self.hdim : hv] + r2 * k[hv] + b


class _KernelDense(nn.Module):
    """Linear with an ``[in, out]`` kernel (the layout the edge kernels
    read; the virtual-node channel applies it in ``forward``, with the
    weights its EGCL keeps cast)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.kernel = _kernel_param(in_features, out_features, device)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def cast(self, dt: torch.dtype) -> tuple:
        return self.kernel.to(dt), self.bias.to(dt)

    def forward(self, v: torch.Tensor, weights) -> torch.Tensor:
        """``v @ kernel + bias`` with ``weights = cast(v.dtype)``."""
        k, b = weights
        return v @ k + b


class _VectorHead(_KernelDense):
    """Dense to one output (``kernel [F, 1]``, ``bias [1]``). The edge
    functions apply it as a multiply-reduce in their epilogue; ``forward``
    is the same multiply-reduce."""

    def __init__(self, features: int, device=None):
        super().__init__(features, 1, device)

    def cast(self, dt: torch.dtype) -> tuple:
        return self.kernel[:, 0].to(dt), self.bias.to(dt)

    def forward(self, v: torch.Tensor, weights) -> torch.Tensor:
        w, b = weights
        return (v * w).sum(dim=-1, keepdim=True) + b


def _drop_cast(module: "EGCL", incompatible_keys) -> None:
    module.drop_compute_weights()


class EGCL(nn.Module):
    """One equivariant graph convolution layer (masked, dense or kNN).

    The weights in the compute dtype are cast once and kept
    (``compute_weights``): the parameters are frozen while the port serves,
    and a cast a call was half of a served step's launches."""

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
        self._cast_key = None
        self._cast = None
        self.register_load_state_dict_post_hook(_drop_cast)

    def drop_compute_weights(self) -> None:
        """Forget the cast weights; the next call casts again."""
        self._cast_key = self._cast = None

    def compute_weights(self, dt: torch.dtype) -> dict:
        """The weights as the forward uses them, cast to ``dt`` at the first
        call and kept. Cast again when ``dt``, the device or any parameter
        changes (its storage or its version counter, which every in-place
        write bumps), and after ``load_state_dict``."""
        params = tuple(self.parameters())
        key = (dt, params[0].device,
               tuple((p.data_ptr(), p._version) for p in params))
        if key != self._cast_key:
            f32 = torch.float32
            m1, x1 = self.mlp_m_dense1, self.mlp_x_dense1
            att, x2 = self.attention_dense, self.mlp_x_dense2
            h0, h1 = self.mlp_h_dense0, self.mlp_h_dense1
            w = {"m_first": self.mlp_m_dense0.cast(dt),
                 "x_first": self.mlp_x_dense0.cast(dt),
                 "heads": (m1.kernel.to(dt), m1.bias.to(f32).unsqueeze(0),
                           att.kernel.to(f32), att.bias.to(f32).unsqueeze(0),
                           x1.kernel.to(dt), x1.bias.to(f32).unsqueeze(0),
                           x2.kernel.to(f32), x2.bias.to(f32).unsqueeze(0)),
                 "h0": (h0.weight.to(dt), h0.bias.to(dt)),
                 "h1": (h1.weight.to(dt), h1.bias.to(dt))}
            if self.virtual_node:
                w.update({name: getattr(self, name).cast(dt) for name in (
                    "vnode_in", "vnode_pool", "vnode_out", "vnode_x",
                    "vnode_x_head")})
            self._cast, self._cast_key = w, key
        return self._cast

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                node_mask: torch.Tensor, edges=None):
        """h ``[B, N, H]``, x ``[B, N, 3]``, node_mask ``[B, N]``; edges
        None (dense) or ``(idx [B, N, K] int32, edge_mask [B, N, K])`` ->
        (h', x'). Padded nodes keep their x and get masked-out messages."""
        dt = self.compute_dtype
        f32 = torch.float32
        w = self.compute_weights(dt)
        h_c = h.to(dt)
        x_f = x.to(f32).contiguous()
        mi_k, mi_b, mj_k, m_d2 = w["m_first"]
        xi_k, xi_b, xj_k, x_d2 = w["x_first"]
        am_i, ax_i = h_c @ mi_k + mi_b, h_c @ xi_k + xi_b
        m_hidden, m_out = mi_k.shape[-1], w["heads"][0].shape[-1]
        x_hidden = xi_k.shape[-1]
        if edges is None:
            args = (am_i, h_c @ mj_k, ax_i, h_c @ xj_k, x_f,
                    node_mask.to(f32).unsqueeze(-1), m_d2, x_d2, *w["heads"])
            route = edge_route(m_hidden, x_hidden, m_out, dt)
            reference, edge_fn, sources = (
                egcl_pair.egcl_pair_edges_reference, self.edge_fn,
                h.shape[1])
        else:
            idx, edge_mask = edges
            args = (am_i, ax_i, h_c, x_f, idx, edge_mask, mj_k, xj_k, m_d2,
                    x_d2, *w["heads"])
            route = edge_route(m_hidden, x_hidden, m_out, dt, h.shape[-1])
            reference, edge_fn, sources = (
                egcl_knn.egcl_knn_edges_reference, self.knn_edge_fn,
                idx.shape[-1])
        if route == "plain":
            m_sum, x_new = plain_edges(reference, args, sources,
                                       max(m_hidden, x_hidden, m_out))
        else:
            m_sum, x_new = edge_fn(*args)
        if self.virtual_node:
            vn_msg, x_vn = self._virtual_channel(h_c, x_f, node_mask, w)
            m_sum = m_sum + vn_msg.to(m_sum.dtype)
            x_new = x_new + x_vn
        cat = torch.cat([h_c, m_sum.to(dt)], dim=-1)
        h_new = F.linear(F.silu(F.linear(cat, *w["h0"])), *w["h1"])
        if self.h_residual and h_new.shape[-1] == h_c.shape[-1]:
            h_new = h_new + h_c
        return h_new.to(h.dtype), x_new.to(x.dtype)

    def _virtual_channel(self, h_c, x_f, node_mask, w):
        """Messages through a virtual node at the masked centre of mass:
        (vn_msg ``[B, N, m_out]`` compute dtype, x_vn ``[B, N, 3]`` float32),
        added to the message sum and to the coordinates; ``w`` is
        ``compute_weights``."""
        dt, f32 = h_c.dtype, torch.float32
        m3 = node_mask.unsqueeze(-1).to(f32)
        m3_c = m3.to(dt)
        h_m = h_c * m3_c
        diff = (x_f - masked_mean(x_f, node_mask)) * m3          # [B,N,3]
        r2_f = (diff * diff).sum(dim=-1, keepdim=True)           # [B,N,1]
        r2 = r2_f.to(dt)
        u = F.silu(self.vnode_in(torch.cat([h_m, r2], dim=-1),
                                 w["vnode_in"])) * m3_c
        h_v = F.silu(self.vnode_pool(masked_mean(u, node_mask),
                                     w["vnode_pool"]))           # [B,1,V]
        vn_msg = self.vnode_out(h_m, h_v, r2, w["vnode_out"]) * m3_c
        s_v = self.vnode_x_head(F.silu(self.vnode_x(h_m, h_v, r2,
                                                    w["vnode_x"])),
                                w["vnode_x_head"])
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
