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

With ``edge_rbf`` = K > 0, K Gaussians of the edge length
(``ops.edges.rbf_features``, re-exported here) enter both edge MLPs'
pre-activations through the bias-free, zero-initialised ``rbf_m [K,
m_hidden]`` and ``rbf_x [K, x_hidden]``. Neither kernel computes that term
(the JAX package's Pallas kernels compute none either), so such a layer
always takes the plain route, whatever its widths.

With ``compat_scalar_norm`` (dense topology only; the kNN route raises, as
in the JAX package) the coordinate update divides by one norm per graph,
the Frobenius norm of its whole masked pair grid (``ops.egcl_pair.
compat_norm``), in place of each edge's length. K1 divides per edge, so
such a layer takes the plain route too; the norm is computed over all
pairs before the plain statement is cut into chunks of targets.

``remat_egcl`` recomputes each layer's forward in the backward
(``torch.utils.checkpoint``, where grad mode is on): a layer's activations
are freed after its forward. The recompute casts the weights again and
launches the layer's edge function again, so a train step launches K1/K2
(or adds to ``plain_edge_calls``) twice a layer; the parameter names stay
``egcl_{l}.*``.

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
from torch.utils.checkpoint import checkpoint

from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.com import masked_mean
from diffusion_model_tpu_torch.ops.edge_grad import (
    GRAPH_ARGS,
    PLAIN_EDGE_ELEMENTS,
    edge_chunks,
)
from diffusion_model_tpu_torch.ops.edges import rbf_features  # noqa: F401
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges

# Calls of the plain route in this process; only ``plain_edges`` adds to it.
plain_edge_calls = 0


def edge_route(m_hidden: int, x_hidden: int, m_out: int, dtype: torch.dtype,
               hdim: int | None = None, edge_rbf: int = 0,
               compat_scalar_norm: bool = False) -> str:
    """The route of an EGCL's edge work, from its config alone, before any
    call: ``"kernel"`` (the layer's edge function: the CUDA kernel on the
    card) or ``"plain"`` (``plain_edges``). ``"plain"`` exactly where the
    layer has a radial-basis term (``edge_rbf`` > 0: no kernel computes
    one), divides by a per-graph norm (``compat_scalar_norm``: K1 divides
    each edge by its own length, and the JAX package's fast path, which
    never reads the flag, would drop the norm) or a shape limit of the
    kernels fails: the first-layer widths differ or are not multiples of
    64, ``m_out`` is not a multiple of 64 or exceeds 256, a bfloat16 first
    layer is wider than ``MAX_F1``, or (kNN, ``hdim`` given) the node width
    exceeds ``MAX_H``. What the kernel refuses for any other reason (dtype,
    device, layout, grad) it still refuses. The JAX package routes by
    config the same way (``api.sampling_uses_pallas`` keeps ``edge_rbf`` on
    XLA, and sends every dense model to XLA); its XLA path takes any width.
    On the CPU both routes are the plain statement; only ``"plain"`` cuts
    it into chunks and counts the call."""
    fits = (edge_rbf == 0 and not compat_scalar_norm
            and m_hidden == x_hidden and m_hidden % 64 == 0
            and m_out % 64 == 0 and m_out <= 256
            and not (dtype == torch.bfloat16 and m_hidden > egcl_pair.MAX_F1)
            and (hdim is None or 1 <= hdim <= egcl_knn.MAX_H))
    return "kernel" if fits else "plain"


def plain_edges(reference: Callable, args: tuple, sources: int, width: int,
                budget: int = PLAIN_EDGE_ELEMENTS, norm=None):
    """``reference`` (``egcl_pair_edges_reference`` or
    ``egcl_knn_edges_reference``) over ``args``, in chunks of whole graphs,
    or of one graph's targets where a graph is too large (``ops.edge_grad.
    edge_chunks``), so that no ``[graphs, targets, sources, width]``
    intermediate exceeds ``budget`` elements. The first ``GRAPH_ARGS`` of
    both are per graph; the rest (weights, an ``rbf`` term) pass whole;
    ``norm`` (``[B, 1, 1, 1]``, the dense reference's per-graph divisor) is
    per graph too. Returns (m_sum [B,N,Fm], x_out [B,N,3]) float32, as
    the reference does; written chunk by chunk into fresh tensors, which
    autograd follows."""
    global plain_edge_calls
    plain_edge_calls += 1
    b, n = args[0].shape[:2]
    m_sum = x_out = None
    for g, t in edge_chunks(b, n, sources, width, budget):
        per_graph = tuple(a[g] for a in args[:GRAPH_ARGS])
        kw = {} if norm is None else {"norm": norm[g]}
        m, x = reference(*per_graph, *args[GRAPH_ARGS:], targets=t, **kw)
        if m_sum is None:
            m_sum = m.new_empty((b, n, m.shape[-1]))
            x_out = x.new_empty((b, n, 3))
        m_sum[g, t] = m
        x_out[g, t] = x
    return m_sum, x_out


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  scale: float = 1.0) -> torch.Tensor:
    """Draw ``w`` in place as flax's ``variance_scaling(scale, "fan_in",
    "truncated_normal")`` (``lecun_normal`` at scale 1): a normal cut at two
    standard deviations, widened so its variance is ``scale / fan_in``. The
    distribution is flax's; the bits are not (threefry is not Philox)."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _kernel_param(fan_in: int, fan_out: int, device,
                  zero: bool = False) -> nn.Parameter:
    """An ``[in, out]`` kernel: zeros, or ``lecun_normal``."""
    w = torch.zeros(fan_in, fan_out, device=device)
    if not zero:
        lecun_normal_(w, fan_in)
    return nn.Parameter(w)


def flax_dense(fan_in: int, fan_out: int, device,
               scale: float = 1.0) -> nn.Linear:
    """``nn.Linear`` drawn as a flax ``Dense``: ``lecun_normal`` weight
    (``variance_scaling(scale, ...)``), zero bias."""
    layer = nn.Linear(fan_in, fan_out, device=device)
    lecun_normal_(layer.weight, fan_in, scale)
    nn.init.zeros_(layer.bias)
    return layer


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

    def __init__(self, features: int, hdim: int, vdim: int, device=None,
                 zero: bool = False):
        super().__init__()
        self.hdim, self.vdim = hdim, vdim
        self.kernel = _kernel_param(hdim + vdim + 1, features, device, zero)
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

    def __init__(self, in_features: int, out_features: int, device=None,
                 zero: bool = False):
        super().__init__()
        self.kernel = _kernel_param(in_features, out_features, device, zero)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def cast(self, dt: torch.dtype) -> tuple:
        return self.kernel.to(dt), self.bias.to(dt)

    def forward(self, v: torch.Tensor, weights) -> torch.Tensor:
        """``v @ kernel + bias`` with ``weights = cast(v.dtype)``."""
        k, b = weights
        return v @ k + b


class _RbfKernel(nn.Module):
    """Bias-free ``kernel [K, F]`` of a radial-basis term, zero at init."""

    def __init__(self, num: int, features: int, device=None):
        super().__init__()
        self.kernel = _kernel_param(num, features, device, zero=True)

    def cast(self, dt: torch.dtype) -> torch.Tensor:
        return self.kernel.to(dt)


class _VectorHead(_KernelDense):
    """Dense to one output (``kernel [F, 1]``, ``bias [1]``). The edge
    functions apply it as a multiply-reduce in their epilogue; ``forward``
    is the same multiply-reduce."""

    def __init__(self, features: int, device=None, zero: bool = False):
        super().__init__(features, 1, device, zero)

    def cast(self, dt: torch.dtype) -> tuple:
        return self.kernel[:, 0].to(dt), self.bias.to(dt)

    def forward(self, v: torch.Tensor, weights) -> torch.Tensor:
        w, b = weights
        return (v * w).sum(dim=-1, keepdim=True) + b


def _drop_cast(module: "EGCL", incompatible_keys) -> None:
    module.drop_compute_weights()


class EGCL(nn.Module):
    """One equivariant graph convolution layer (masked, dense or kNN).

    While no autograd can see them, the weights in the compute dtype are
    cast once and kept (``compute_weights``): a cast a call was half of a
    served step's launches. Parameters are drawn as flax draws them:
    ``lecun_normal`` kernels, zero biases, the coordinate MLP's last layer
    zero with ``zero_init_x``, the node MLP's output kernel at variance
    ``h_init_scale / fan_in``, the virtual node's two output heads and the
    radial-basis kernels zero."""

    def __init__(self, hdim: int, m_hidden: int, m_out: int, x_hidden: int,
                 h_hidden: int, h_out: int,
                 compute_dtype: torch.dtype = torch.float32,
                 edge_fn: Callable = egcl_pair_edges,
                 knn_edge_fn: Callable = egcl_knn_edges,
                 h_residual: bool = False, virtual_node: bool = False,
                 zero_init_x: bool = True, h_init_scale: float = 1.0,
                 edge_rbf: int = 0, edge_rbf_rmax: float = 8.0,
                 compat_scalar_norm: bool = False, device=None):
        super().__init__()
        if edge_rbf and (edge_rbf < 2 or not edge_rbf_rmax > 0):
            raise ValueError(
                f"edge_rbf={edge_rbf} needs >= 2 Gaussian centres and "
                f"edge_rbf_rmax={edge_rbf_rmax} > 0 (width = rmax / "
                "(num - 1)); use edge_rbf=0 to disable")
        self.compute_dtype = compute_dtype
        self.edge_rbf, self.edge_rbf_rmax = edge_rbf, float(edge_rbf_rmax)
        self.compat_scalar_norm = compat_scalar_norm
        self.edge_fn = edge_fn
        self.knn_edge_fn = knn_edge_fn
        self.h_residual = h_residual
        self.virtual_node = virtual_node
        self.mlp_m_dense0 = _EdgeFirstLayer(m_hidden, hdim, device)
        self.mlp_m_dense1 = _KernelDense(m_hidden, m_out, device)
        self.attention_dense = _VectorHead(m_out, device)
        self.mlp_x_dense0 = _EdgeFirstLayer(x_hidden, hdim, device)
        self.mlp_x_dense1 = _KernelDense(x_hidden, x_hidden, device)
        self.mlp_x_dense2 = _VectorHead(x_hidden, device, zero_init_x)
        self.mlp_h_dense0 = flax_dense(hdim + m_out, h_hidden, device)
        self.mlp_h_dense1 = flax_dense(h_hidden, h_out, device, h_init_scale)
        if virtual_node:
            self.vnode_in = _KernelDense(hdim + 1, m_hidden, device)
            self.vnode_pool = _KernelDense(m_hidden, m_out, device)
            self.vnode_out = _GlobalFirstLayer(m_out, hdim, m_out, device,
                                               zero=True)
            self.vnode_x = _GlobalFirstLayer(x_hidden, hdim, m_out, device)
            self.vnode_x_head = _VectorHead(x_hidden, device, zero=True)
        if edge_rbf:
            self.rbf_m = _RbfKernel(edge_rbf, m_hidden, device)
            self.rbf_x = _RbfKernel(edge_rbf, x_hidden, device)
        self._cast_key = None
        self._cast = None
        self.register_load_state_dict_post_hook(_drop_cast)

    def drop_compute_weights(self) -> None:
        """Forget the cast weights; the next call casts again."""
        self._cast_key = self._cast = None

    def compute_weights(self, dt: torch.dtype) -> dict:
        """The weights as the forward uses them, in ``dt``.

        Where autograd records (grad mode on and a parameter requires grad)
        they are cast anew at every call, inside the graph, as the JAX
        package's ``model.apply`` casts inside the traced function. Else
        they are cast at the first call and kept, as ``nn/fast_apply.py``
        casts once for sampling: cast again when ``dt``, the device or any
        parameter changes (its storage or its version counter, which every
        in-place write bumps), and after ``load_state_dict``. A kept cast
        has no graph, so it never reaches a training forward.

        Under ``torch.export`` the kept cast is the one used and no key is
        read (a parameter may be a fake tensor there): its tensors become
        the exported program's constants, cast once before the trace and
        never inside the graph. Cast them first (a call of this method outside
        the trace); a layer that finds none, or one in another dtype,
        raises."""
        params = tuple(self.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return self._cast_weights(dt)
        if torch.compiler.is_exporting():
            if self._cast is None or self._cast_key[0] != dt:
                raise RuntimeError(
                    f"an EGCL is exported with no weights kept in {dt}: "
                    "call compute_weights before torch.export")
            return self._cast
        key = (dt, params[0].device,
               tuple((p.data_ptr(), p._version) for p in params))
        if key != self._cast_key:
            self._cast, self._cast_key = self._cast_weights(dt), key
        return self._cast

    def _cast_weights(self, dt: torch.dtype) -> dict:
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
        if self.edge_rbf:
            w["rbf"] = (self.rbf_m.cast(dt), self.rbf_x.cast(dt),
                        self.edge_rbf_rmax)
        return w

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
        norm = None
        if edges is None:
            args = (am_i, h_c @ mj_k, ax_i, h_c @ xj_k, x_f,
                    node_mask.to(f32).unsqueeze(-1), m_d2, x_d2, *w["heads"])
            route = edge_route(m_hidden, x_hidden, m_out, dt,
                               edge_rbf=self.edge_rbf,
                               compat_scalar_norm=self.compat_scalar_norm)
            if self.compat_scalar_norm:
                norm = egcl_pair.compat_norm(x_f, node_mask)
            reference, edge_fn, sources = (
                egcl_pair.egcl_pair_edges_reference, self.edge_fn,
                h.shape[1])
        else:
            if self.compat_scalar_norm:
                raise NotImplementedError(
                    "compat_scalar_norm is a dense-path-only validation mode")
            idx, edge_mask = edges
            args = (am_i, ax_i, h_c, x_f, idx, edge_mask, mj_k, xj_k, m_d2,
                    x_d2, *w["heads"])
            route = edge_route(m_hidden, x_hidden, m_out, dt, h.shape[-1],
                               self.edge_rbf)
            reference, edge_fn, sources = (
                egcl_knn.egcl_knn_edges_reference, self.knn_edge_fn,
                idx.shape[-1])
        if self.edge_rbf:
            args = args + (w["rbf"],)
        if route == "plain":
            m_sum, x_new = plain_edges(reference, args, sources,
                                       max(m_hidden, x_hidden, m_out),
                                       norm=norm)
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
    """Stack of L EGCLs, named ``egcl_0`` .. ``egcl_{L-1}``; with
    ``remat_egcl`` each is called through ``torch.utils.checkpoint`` where
    grad mode is on, and directly under ``no_grad``."""

    def __init__(self, L: int, hdim: int, m_hidden: int, m_out: int,
                 x_hidden: int, h_hidden: int,
                 compute_dtype: torch.dtype = torch.float32,
                 edge_fn: Callable = egcl_pair_edges,
                 knn_edge_fn: Callable = egcl_knn_edges,
                 h_residual: bool = False, virtual_node: bool = False,
                 zero_init_x: bool = True, h_init_scale: float = 1.0,
                 edge_rbf: int = 0, edge_rbf_rmax: float = 8.0,
                 compat_scalar_norm: bool = False, remat_egcl: bool = False,
                 device=None):
        super().__init__()
        self.L = L
        self.remat_egcl = remat_egcl
        for l in range(L):
            self.add_module(f"egcl_{l}", EGCL(
                hdim, m_hidden, m_out, x_hidden, h_hidden, hdim,
                compute_dtype=compute_dtype, edge_fn=edge_fn,
                knn_edge_fn=knn_edge_fn, h_residual=h_residual,
                virtual_node=virtual_node, zero_init_x=zero_init_x,
                h_init_scale=h_init_scale, edge_rbf=edge_rbf,
                edge_rbf_rmax=edge_rbf_rmax,
                compat_scalar_norm=compat_scalar_norm, device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                node_mask: torch.Tensor, edges=None):
        remat = self.remat_egcl and torch.is_grad_enabled()
        for l in range(self.L):
            layer = getattr(self, f"egcl_{l}")
            if remat:
                h, x = checkpoint(layer, h, x, node_mask, edges,
                                  use_reentrant=False)
            else:
                h, x = layer(h, x, node_mask, edges)
        return h, x
