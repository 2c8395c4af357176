"""EGCL edge work over the dense pair grid: the CUDA kernel and its plain
PyTorch statement.

``egcl_pair_edges`` replaces ``diffusion_model_tpu/ops/egcl_pallas.py:171
egcl_pair_kernel``. For graph b and each ordered pair (i, j) of real atoms
with i != j (pair mask pm)::

    pre_m   = Am_i + Bm_j + d2_ij * w_dm
    m       = silu(silu(pre_m) @ W2m + b2m)
    m_sum_i = sum_j m * sigmoid(m @ wa + ba) * pm
    pre_x   = Ax_i + Bx_j + d2_ij * w_dx
    s       = silu(silu(pre_x) @ W2x + b2x) @ wx3 + bx3
    x_out_i = x_i + sum_j (x_i - x_j) * s / (|x_i - x_j| + 1) * pm

The plain statement also takes an edge model's radial-basis term (``rbf``:
``rbf(|x_i - x_j|) @ W_rbf_m`` added to pre_m and ``@ W_rbf_x`` to pre_x,
``ops.edges.rbf_features`` under the pair mask) and a ``compat_scalar_norm``
model's divisor (``norm``: one value per graph in place of ``|x_i - x_j|``,
``compat_norm``); the kernel computes neither, as the Pallas kernel computes
neither, and ``egcl_pair_edges`` refuses both.

The kernel (``csrc/egcl_pair.cu``) is bound by tensor-core FLOPs: 2.62
MFLOP per live pair at F1=1024, Fm=256, against at most 8 KB of node input
per edge (four bf16 projection rows), above the card's FLOP-per-byte ridge
even with no reuse. In bf16 a block owns a run of consecutive targets and
computes their live pairs only (``edge_tiles`` states the schedule), in
64-row tiles of silu(pre) built 8 bf16 at a time; both second-layer products
run as wgmma with W streamed by TMA, and bias, SiLU, the gate and the
width-1 heads fold into the epilogue, so no ``[edges, F1]`` tensor reaches
device memory and the j-sums need no atomics. A float32 variant walks the
padded grid with plain FMAs. ``last_rows`` holds the tile rows the last
launch computed (an int32 on the card).

Where autograd does not record, ``egcl_pair_edges`` calls the custom op
``torch.ops.diffusion_model_tpu_torch.egcl_pair`` (``egcl_pair_op``), which
dispatches by device: on CUDA tensors it launches the kernel or raises, on
CPU tensors it runs ``egcl_pair_edges_reference``, and on any other device
it has no implementation. Its fake implementation gives the outputs' shapes,
so ``torch.export`` records the op as one opaque node (the serving export,
``serve.py``). Where autograd records (grad mode on and an input requires
grad) ``egcl_pair_edges`` runs through ``ops.edge_grad.EdgeFunction``, the
port of the JAX package's ``custom_vjp`` (``ops/egcl_pallas.py:290-322``):
the kernel (or the plain statement on the CPU) forward on detached inputs,
and backward autograd of the float32 reference where the compute dtype is
float32, else of ``egcl_pair_edges_compute``, the statement the JAX
package's training differentiates (F11, ``ROADMAP.md`` §3). The launch
itself (``_launch``) refuses an input that requires grad.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from diffusion_model_tpu_torch.ops import _tiles
from diffusion_model_tpu_torch.ops.activations import (  # noqa: F401
    logistic,
    silu,
)
from diffusion_model_tpu_torch.ops.edge_grad import EdgeFunction, wants_grad
from diffusion_model_tpu_torch.ops.edges import rbf_features

# Launches of the CUDA kernel in this process; only egcl_pair_edges adds to
# it, right after a launch was accepted.
egcl_pair_launches = 0
# Tile rows the last launch computed: one int32 on the card, which every
# block of the kernel adds its rows to.
last_rows = None

_SOURCE = "egcl_pair.cu"
MAX_F1 = 1024   # first-layer width of the bf16 kernel (csrc kMaxF1)


def egcl_pair_edges_reference(am_i, am_j, ax_i, ax_j, x, mask, w_dm, w_dx,
                              w2m, b2m, wa, ba, w2x, b2x, wx3, bx3, rbf=None,
                              targets: slice = slice(None), norm=None):
    """Plain float32 statement of the kernel's math (materialises the
    ``[B, T, N, F]`` edge tensors) for the targets ``i`` in ``targets`` (all
    by default), with the radial-basis term where ``rbf`` is given as
    ``(W_rbf_m [K, F1], W_rbf_x [K, F1], rmax)`` (kernels in the compute
    dtype, the features cast to it), and the coordinate update divided by
    ``norm [B, 1, 1, 1] + 1`` (``compat_norm``) where it is given, else by
    ``|x_i - x_j| + 1``. Returns (m_sum [B,T,Fm], x_out [B,T,3])."""
    f32 = torch.float32
    am_i, am_j, ax_i, ax_j, x = (v.to(f32) for v in (am_i, am_j, ax_i, ax_j, x))
    n = am_i.shape[1]
    x_i = x[:, targets]
    diff = x_i[:, :, None, :] - x[:, None, :, :]            # [B,T,N,3]
    d2 = (diff * diff).sum(dim=-1, keepdim=True)            # [B,T,N,1]
    m3 = mask.to(f32)                                        # [B,N,1]
    eye = torch.eye(n, dtype=f32, device=x.device)[targets]
    pm = (m3[:, targets, None, :] * m3[:, None, :, :]
          * (1.0 - eye)[None, :, :, None])

    pre_m = am_i[:, targets, None, :] + am_j[:, None, :, :] + d2 * w_dm.to(f32)
    pre_x = ax_i[:, targets, None, :] + ax_j[:, None, :, :] + d2 * w_dx.to(f32)
    if rbf is not None:
        pre_m, pre_x = add_rbf(pre_m, pre_x, d2, pm > 0, *rbf)
    m = F.silu(F.silu(pre_m) @ w2m.to(f32) + b2m.to(f32))
    att = torch.sigmoid(m @ wa.to(f32) + ba.to(f32))
    m_sum = (m * att * pm).sum(dim=2)                        # [B,T,Fm]

    u = F.silu(F.silu(pre_x) @ w2x.to(f32) + b2x.to(f32))
    s = u @ wx3.to(f32) + bx3.to(f32)                        # [B,T,N,1]
    if norm is None:
        norm = torch.sqrt(torch.where(pm > 0, d2.clamp_min(1e-12),
                                      torch.ones_like(d2)))
    upd = diff * s / (norm + 1.0) * pm
    return m_sum, x_i + upd.sum(dim=2)


def egcl_pair_edges_compute(am_i, am_j, ax_i, ax_j, x, mask, w_dm, w_dx,
                            w2m, b2m, wa, ba, w2x, b2x, wx3, bx3, rbf=None,
                            targets: slice = slice(None), norm=None):
    """The same edge work in the compute dtype ``am_i.dtype``, as the JAX
    package's flax ``EGCL._dense_call`` computes it dtype for dtype (its
    training route, which reaches no Pallas kernel): every weight cast to
    the compute dtype as ``Dense(dtype=dt)`` casts it, the first-layer sum,
    the second layers, the SiLUs, the gate, the heads and the masked sum
    over sources in the compute dtype; the geometry (``diff``, ``d2``, the
    norm, the update) in float32, ``d2`` rounded to the compute dtype for
    the first layer. Same arguments as ``egcl_pair_edges_reference``.
    Returns (m_sum [B,T,Fm] in the compute dtype, x_out [B,T,3] float32);
    in float32 it is the reference up to rounding order."""
    dt, f32 = am_i.dtype, torch.float32
    x = x.to(f32)
    n = am_i.shape[1]
    x_i = x[:, targets]
    diff = x_i[:, :, None, :] - x[:, None, :, :]            # [B,T,N,3]
    d2 = (diff * diff).sum(dim=-1, keepdim=True)            # [B,T,N,1]
    m3 = mask.to(f32)
    eye = torch.eye(n, dtype=f32, device=x.device)[targets]
    pm = (m3[:, targets, None, :] * m3[:, None, :, :]
          * (1.0 - eye)[None, :, :, None])
    d2_c = d2.to(dt)
    pre_m = am_i[:, targets, None, :] + am_j[:, None, :, :] + d2_c * w_dm.to(dt)
    pre_x = ax_i[:, targets, None, :] + ax_j[:, None, :, :] + d2_c * w_dx.to(dt)
    if rbf is not None:
        pre_m, pre_x = compute_rbf(pre_m, pre_x, d2, pm > 0, *rbf)
    return compute_tail(pre_m, pre_x, pm, diff, d2, x_i, w2m, b2m, wa, ba,
                        w2x, b2x, wx3, bx3, norm)


def compute_rbf(pre_m, pre_x, d2, valid, w_rbf_m, w_rbf_x, rmax):
    """``add_rbf`` in ``pre_m``'s dtype: the features rounded to it and
    each term a product in it, as the JAX package's ``rbf_m`` / ``rbf_x``
    ``Dense(dtype=dt)`` compute them."""
    dt = pre_m.dtype
    rbf = rbf_features(d2, valid, w_rbf_m.shape[0], rmax).to(dt)
    return pre_m + rbf @ w_rbf_m.to(dt), pre_x + rbf @ w_rbf_x.to(dt)


def compute_tail(pre_m, pre_x, em, diff, d2, x_i, w2m, b2m, wa, ba, w2x,
                 b2x, wx3, bx3, norm=None):
    """The compute-dtype statements' work after the first layers, in
    ``pre_m``'s dtype but the geometry: (m_sum, x_i + the update).
    ``em`` is the float32 edge (or pair) mask ``[B, T, S, 1]``; ``norm``
    the dense per-graph divisor, else each edge's length."""
    dt, f32 = pre_m.dtype, torch.float32
    m = silu(silu(pre_m) @ w2m.to(dt) + b2m.to(dt))
    m = m * logistic(m @ wa.to(dt) + ba.to(dt)) * em.to(dt)
    u = silu(silu(pre_x) @ w2x.to(dt) + b2x.to(dt))
    s = u @ wx3.to(dt) + bx3.to(dt)                         # [B,T,S,1]
    if norm is None:
        norm = torch.sqrt(torch.where(em > 0, d2.clamp_min(1e-12),
                                      torch.ones_like(d2)))
    upd = diff * (s.to(f32) / (norm + 1.0)) * em
    return m.sum(dim=2), x_i + upd.sum(dim=2)


def compat_norm(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """``[B, 1, 1, 1]`` float32: the ``compat_scalar_norm`` divisor, one
    Frobenius norm per graph over its whole masked pair grid,
    ``sqrt(sum_ij |x_i - x_j|^2 pm_ij)`` (the JAX package's
    ``nn/egnn.py`` ``_dense_call``), computed before the edge work is cut
    into chunks of targets, which each see only their own rows of the grid.
    As in JAX the sqrt has no guard: a graph with one live atom has sum 0,
    a finite forward and an infinite gradient."""
    f32 = torch.float32
    x = x.to(f32)
    m = node_mask.to(f32).reshape(x.shape[0], x.shape[1])
    n = x.shape[1]
    pm = (m[:, :, None] * m[:, None, :]
          * (1.0 - torch.eye(n, dtype=f32, device=x.device)))
    diff = x[:, :, None, :] - x[:, None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    return torch.sqrt((d2 * pm).sum(dim=(-1, -2)))[:, None, None, None]


def add_rbf(pre_m, pre_x, d2, valid, w_rbf_m, w_rbf_x, rmax):
    """``pre_m + rbf @ W_rbf_m`` and ``pre_x + rbf @ W_rbf_x`` in float32,
    with ``rbf = rbf_features(d2, valid)`` rounded to the kernels' (compute)
    dtype first, as the JAX package rounds it."""
    f32 = torch.float32
    rbf = rbf_features(d2, valid, w_rbf_m.shape[0], rmax).to(
        w_rbf_m.dtype).to(f32)
    return pre_m + rbf @ w_rbf_m.to(f32), pre_x + rbf @ w_rbf_x.to(f32)


def refuse_rbf(rbf, kernel: str) -> None:
    """Raise where an RBF term reaches a kernel, which computes none."""
    if rbf is not None:
        raise ValueError(
            f"the {kernel} kernel computes no radial-basis (edge_rbf) term; "
            "an edge_rbf model's edge work runs the plain statement "
            "(nn.egnn.edge_route)")


def refuse_norm(norm) -> None:
    """Raise where a per-graph norm reaches K1, which divides per edge."""
    if norm is not None:
        raise ValueError(
            "the pair (K1) kernel divides by each edge's length and takes no "
            "per-graph norm; a compat_scalar_norm model's edge work runs the "
            "plain statement (nn.egnn.edge_route)")


def edge_tiles(mask) -> _tiles.EdgeTiles:
    """The bf16 kernel's schedule over the pair grid of ``mask [B, N, 1]``
    (or ``[B, N]``): the live pairs (i, j), i != j, both masks nonzero, in
    (target, j) order, blocks of consecutive targets, and the tile rows the
    kernel computes."""
    m = np.asarray(torch.as_tensor(mask).detach().cpu()).reshape(
        mask.shape[0], mask.shape[1]) != 0
    b, n = m.shape
    live = m[:, :, None] & m[:, None, :] & ~np.eye(n, dtype=bool)
    source = np.broadcast_to(
        (np.arange(b)[:, None, None] * n + np.arange(n)), (b, n, n))
    return _tiles.schedule(live.reshape(b * n, n),
                           source.reshape(b * n, n), n - 1)


_NAMES = ("am_i", "am_j", "ax_i", "ax_j", "x", "mask", "w_dm", "w_dx", "w2m",
          "b2m", "wa", "ba", "w2x", "b2x", "wx3", "bx3")
_COMPUTE = ("am_i", "am_j", "ax_i", "ax_j", "w_dm", "w_dx", "w2m", "w2x")


def _expected_shapes(b, n, f1, fm):
    return {"am_i": (b, n, f1), "am_j": (b, n, f1), "ax_i": (b, n, f1),
            "ax_j": (b, n, f1), "x": (b, n, 3), "mask": (b, n, 1),
            "w_dm": (1, f1), "w_dx": (1, f1), "w2m": (f1, fm),
            "b2m": (1, fm), "wa": (fm, 1), "ba": (1, 1), "w2x": (f1, f1),
            "b2x": (1, f1), "wx3": (f1, 1), "bx3": (1, 1)}


def _check(tensors: dict) -> torch.dtype:
    """Raise on anything the kernel does not take; return the compute dtype."""
    device = tensors["am_i"].device
    b, n, f1 = tensors["am_i"].shape
    fm = tensors["w2m"].shape[-1]
    cdt = tensors["am_i"].dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute dtype {cdt} is neither bfloat16 nor float32")
    if f1 % 64 or fm % 64 or fm > 256:
        raise ValueError(
            f"kernel takes F1 and Fm in multiples of 64 with Fm <= 256; "
            f"got F1={f1}, Fm={fm}")
    if cdt == torch.bfloat16 and f1 > MAX_F1:
        raise ValueError(
            f"the bf16 kernel holds a 64-row tile of F1 <= {MAX_F1} columns "
            f"in shared memory; got F1={f1}")
    for name, want in _expected_shapes(b, n, f1, fm).items():
        t = tensors[name]
        dtype = cdt if name in _COMPUTE else torch.float32
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, am_i on {device}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
        if t.requires_grad:
            raise ValueError(
                f"{name} requires grad: the launch takes detached inputs "
                f"(the edge function pairs it with its backward)")
    return cdt


@functools.cache
def _library() -> ctypes.CDLL:
    from diffusion_model_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    lib.egcl_pair_forward.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.egcl_pair_forward.restype = ctypes.c_int
    lib.egcl_pair_error_string.argtypes = [ctypes.c_int]
    lib.egcl_pair_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


def egcl_pair_edges(am_i, am_j, ax_i, ax_j, x, mask, w_dm, w_dx, w2m, b2m,
                    wa, ba, w2x, b2x, wx3, bx3, rbf=None, norm=None):
    """Fused EGCL edge work (see module docstring).

    Args:
      am_i, am_j, ax_i, ax_j: ``[B, N, F1]`` node projections in the compute
        dtype (bfloat16 or float32); the i-parts carry the first-layer bias.
      x: ``[B, N, 3]`` float32 coordinates; mask: ``[B, N, 1]`` float32.
      w_dm, w_dx: ``[1, F1]`` compute dtype; w2m ``[F1, Fm]`` and w2x
        ``[F1, F1]`` compute dtype; b2m ``[1, Fm]``, wa ``[Fm, 1]``,
        ba ``[1, 1]``, b2x ``[1, F1]``, wx3 ``[F1, 1]``, bx3 ``[1, 1]``
        float32.
      rbf, norm: None. The kernel computes no radial-basis term and no
        per-graph norm, on any device, and raises ``ValueError`` rather than
        drop one.

    Returns:
      (m_sum ``[B, N, Fm]`` float32, x_out ``[B, N, 3]`` float32),
      differentiable in every input but ``mask`` where autograd records.
    """
    refuse_rbf(rbf, "pair (K1)")
    refuse_norm(norm)
    args = (am_i, am_j, ax_i, ax_j, x, mask, w_dm, w_dx, w2m, b2m, wa, ba,
            w2x, b2x, wx3, bx3)
    device = am_i.device
    if device.type == "cpu":
        forward = egcl_pair_edges_reference
    elif device.type == "cuda":
        forward = _launch
    else:
        raise ValueError(f"no EGCL pair kernel for device {device}")
    if wants_grad(args):
        statement = (egcl_pair_edges_reference
                     if am_i.dtype == torch.float32
                     else egcl_pair_edges_compute)
        return EdgeFunction.apply(forward, statement,
                                  am_i.shape[1],
                                  max(w2x.shape[-1], w2m.shape[-1]), (5,),
                                  *args)
    return egcl_pair_op(*(a.detach() for a in args))


def _launch(*args):
    """The kernel on CUDA tensors that require no grad, or raise: the
    op's CUDA implementation."""
    global egcl_pair_launches, last_rows
    am_i, w2m = args[0], args[8]
    device = am_i.device
    tensors = dict(zip(_NAMES, args))
    cdt = _check(tensors)
    b, n, f1 = am_i.shape
    fm = w2m.shape[-1]
    m_sum = torch.empty((b, n, fm), dtype=torch.float32, device=device)
    x_out = torch.empty((b, n, 3), dtype=torch.float32, device=device)
    rows = torch.zeros(1, dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.egcl_pair_forward(
            int(cdt == torch.bfloat16), *(t.data_ptr() for t in args),
            m_sum.data_ptr(), x_out.data_ptr(), rows.data_ptr(), b, n, f1,
            fm, stream)
    if rc != 0:
        raise RuntimeError(
            f"egcl_pair kernel launch failed: "
            f"{lib.egcl_pair_error_string(rc).decode()} (cudaError {rc})")
    egcl_pair_launches += 1
    last_rows = rows
    return m_sum, x_out


# The custom op: the kernel on CUDA tensors, the plain statement on CPU
# tensors, no implementation on any other device.
egcl_pair_op = torch.library.custom_op(
    "diffusion_model_tpu_torch::egcl_pair", _launch, mutates_args=(),
    device_types="cuda",
    schema="(" + ", ".join(f"Tensor {n}" for n in _NAMES)
    + ") -> (Tensor, Tensor)")
egcl_pair_op.register_kernel("cpu", egcl_pair_edges_reference)


@egcl_pair_op.register_fake
def _(*args):
    am_i, w2m = args[0], args[8]
    b, n = am_i.shape[:2]
    return (am_i.new_empty((b, n, w2m.shape[-1]), dtype=torch.float32),
            am_i.new_empty((b, n, 3), dtype=torch.float32))
