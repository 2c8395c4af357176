"""EGCL edge work over fixed-degree kNN neighbour lists: the CUDA kernel and
its plain PyTorch statement.

``egcl_knn_edges`` replaces ``diffusion_model_tpu/ops/egcl_pallas_sparse.py:177
egcl_knn_kernel``. For graph b, target i and slot k < K, with source
j = idx[b, i, k] and edge weight em = edge_mask[b, i, k]::

    pre_m   = Am_i + h_j @ Wm_j + d2_ij * w_dm
    m       = silu(silu(pre_m) @ W2m + b2m)
    m_sum_i = sum_k m * sigmoid(m @ wa + ba) * em
    pre_x   = Ax_i + h_j @ Wx_j + d2_ij * w_dx
    s       = silu(silu(pre_x) @ W2x + b2x) @ wx3 + bx3
    x_out_i = x_i + sum_k (x_i - x_j) * s / (|x_i - x_j| + 1) * em

The kernel (``csrc/egcl_knn.cu``) shares the dense kernel's edge tile and
epilogue (``csrc/egcl_edge_tile.cuh``). In bf16 a block owns a run of
consecutive targets and computes their live slots only (``edge_tiles``
states the schedule), in 64-row tiles; it gathers h_j and x_j by ``idx``
and runs the j-side first layer ``h_j @ W_j`` per edge on the tensor cores,
so only the H-wide node rows cross device memory; the sums over the slots
are taken in the block in a fixed order with no atomics. A slot whose index
lies outside ``[0, N)`` is treated as masked: the kernel never reads outside
the graph. A float32 variant walks the padded slots with plain FMAs.
``last_rows`` holds the tile rows the last launch computed (an int32 on the
card).

On CPU tensors ``egcl_knn_edges`` runs ``egcl_knn_edges_reference``; on CUDA
tensors it launches the kernel or raises. Serving needs no gradient, so an
input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from diffusion_model_tpu_torch.ops import _tiles

# Launches of the CUDA kernel in this process; only egcl_knn_edges adds to
# it, right after a launch was accepted.
egcl_knn_launches = 0
# Tile rows the last launch computed: one int32 on the card, which every
# block of the kernel adds its rows to.
last_rows = None

_SOURCE = "egcl_knn.cu"
MAX_H = 48   # node feature width the kernel takes (csrc/egcl_knn.cu kMaxH)
MAX_F1 = 1024   # first-layer width of the bf16 kernel (csrc kMaxF1)


def gather_nodes(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr [B, N, D]`` rows picked by ``idx [B, N, K]`` -> ``[B, N, K, D]``."""
    rows = torch.arange(arr.shape[0], device=arr.device)[:, None, None]
    return arr[rows, idx.long()]


def egcl_knn_edges_reference(am_i, ax_i, h, x, idx, edge_mask, wm_j, wx_j,
                             w_dm, w_dx, w2m, b2m, wa, ba, w2x, b2x, wx3,
                             bx3, targets: slice = slice(None)):
    """Plain float32 statement of the kernel's math (materialises the
    ``[B, T, K, F]`` edge tensors), as ``_edge_math_sparse`` states it, for
    the targets ``i`` in ``targets`` (all by default). Returns
    (m_sum [B,T,Fm], x_out [B,T,3])."""
    f32 = torch.float32
    am_i, ax_i, h, x = (v.to(f32) for v in (am_i, ax_i, h, x))
    idx = idx[:, targets]
    h_j = gather_nodes(h, idx)                               # [B,T,K,H]
    x_j = gather_nodes(x, idx)
    x_i = x[:, targets]
    diff = x_i[:, :, None, :] - x_j
    d2 = (diff * diff).sum(dim=-1, keepdim=True)             # [B,T,K,1]
    em = edge_mask[:, targets, :, None].to(f32)

    pre_m = am_i[:, targets, None, :] + h_j @ wm_j.to(f32) + d2 * w_dm.to(f32)
    m = F.silu(F.silu(pre_m) @ w2m.to(f32) + b2m.to(f32))
    att = torch.sigmoid(m @ wa.to(f32) + ba.to(f32))
    m_sum = (m * att * em).sum(dim=2)                        # [B,T,Fm]

    pre_x = ax_i[:, targets, None, :] + h_j @ wx_j.to(f32) + d2 * w_dx.to(f32)
    u = F.silu(F.silu(pre_x) @ w2x.to(f32) + b2x.to(f32))
    s = u @ wx3.to(f32) + bx3.to(f32)                        # [B,T,K,1]
    norm = torch.sqrt(torch.where(em > 0, d2.clamp_min(1e-12),
                                  torch.ones_like(d2)))
    upd = diff * s / (norm + 1.0) * em
    return m_sum, x_i + upd.sum(dim=2)


def edge_tiles(idx, edge_mask) -> _tiles.EdgeTiles:
    """The bf16 kernel's schedule over the kNN lists ``idx [B, N, K]`` and
    ``edge_mask [B, N, K]``: the live slots (mask nonzero, 0 <= idx < N) in
    (target, slot) order, wherever they sit in a row, blocks of consecutive
    targets, and the tile rows the kernel computes."""
    idx = np.asarray(torch.as_tensor(idx).detach().cpu()).astype(np.int64)
    em = np.asarray(torch.as_tensor(edge_mask).detach().cpu())
    b, n, k = idx.shape
    live = (em != 0) & (idx >= 0) & (idx < n)
    source = np.where(live, np.arange(b)[:, None, None] * n + idx, -1)
    return _tiles.schedule(live.reshape(b * n, k), source.reshape(b * n, k),
                           k)


_NAMES = ("am_i", "ax_i", "h", "x", "idx", "edge_mask", "wm_j", "wx_j",
          "w_dm", "w_dx", "w2m", "b2m", "wa", "ba", "w2x", "b2x", "wx3",
          "bx3")
_COMPUTE = ("am_i", "ax_i", "h", "wm_j", "wx_j", "w_dm", "w_dx", "w2m",
            "w2x")


def _expected_shapes(b, n, hdim, k, f1, fm):
    return {"am_i": (b, n, f1), "ax_i": (b, n, f1), "h": (b, n, hdim),
            "x": (b, n, 3), "idx": (b, n, k), "edge_mask": (b, n, k),
            "wm_j": (hdim, f1), "wx_j": (hdim, f1), "w_dm": (1, f1),
            "w_dx": (1, f1), "w2m": (f1, fm), "b2m": (1, fm),
            "wa": (fm, 1), "ba": (1, 1), "w2x": (f1, f1), "b2x": (1, f1),
            "wx3": (f1, 1), "bx3": (1, 1)}


def _check(tensors: dict) -> torch.dtype:
    """Raise on anything the kernel does not take; return the compute dtype."""
    device = tensors["am_i"].device
    b, n, f1 = tensors["am_i"].shape
    hdim = tensors["h"].shape[-1]
    k = tensors["idx"].shape[-1]
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
    if not 1 <= hdim <= MAX_H:
        raise ValueError(
            f"kernel takes node features of width 1..{MAX_H}; got H={hdim}")
    for name, want in _expected_shapes(b, n, hdim, k, f1, fm).items():
        t = tensors[name]
        dtype = (torch.int32 if name == "idx"
                 else cdt if name in _COMPUTE else torch.float32)
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
                f"{name} requires grad: the kernel has no backward yet")
    return cdt


@functools.cache
def _library() -> ctypes.CDLL:
    from diffusion_model_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    lib.egcl_knn_forward.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.egcl_knn_forward.restype = ctypes.c_int
    lib.egcl_knn_error_string.argtypes = [ctypes.c_int]
    lib.egcl_knn_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


def egcl_knn_edges(am_i, ax_i, h, x, idx, edge_mask, wm_j, wx_j, w_dm, w_dx,
                   w2m, b2m, wa, ba, w2x, b2x, wx3, bx3):
    """Fused kNN EGCL edge work (see module docstring).

    Args:
      am_i, ax_i: ``[B, N, F1]`` i-side first-layer projections (with the
        bias) in the compute dtype (bfloat16 or float32).
      h: ``[B, N, H]`` node features in the compute dtype, H <= 48.
      x: ``[B, N, 3]`` float32 coordinates.
      idx: ``[B, N, K]`` int32 neighbour indices; edge_mask: ``[B, N, K]``
        float32 (``ops.edges.knn_edges``).
      wm_j, wx_j: ``[H, F1]`` j-blocks of the fused first-layer kernels;
        w_dm, w_dx ``[1, F1]``; w2m ``[F1, Fm]``; w2x ``[F1, F1]``; all in
        the compute dtype. b2m ``[1, Fm]``, wa ``[Fm, 1]``, ba ``[1, 1]``,
        b2x ``[1, F1]``, wx3 ``[F1, 1]``, bx3 ``[1, 1]`` float32.

    Returns:
      (m_sum ``[B, N, Fm]`` float32, x_out ``[B, N, 3]`` float32).
    """
    global egcl_knn_launches, last_rows
    args = (am_i, ax_i, h, x, idx, edge_mask, wm_j, wx_j, w_dm, w_dx, w2m,
            b2m, wa, ba, w2x, b2x, wx3, bx3)
    device = am_i.device
    if device.type == "cpu":
        return egcl_knn_edges_reference(*args)
    if device.type != "cuda":
        raise ValueError(f"no EGCL kNN kernel for device {device}")
    cdt = _check(dict(zip(_NAMES, args)))
    b, n, f1 = am_i.shape
    hdim, k, fm = h.shape[-1], idx.shape[-1], w2m.shape[-1]
    m_sum = torch.empty((b, n, fm), dtype=torch.float32, device=device)
    x_out = torch.empty((b, n, 3), dtype=torch.float32, device=device)
    rows = torch.zeros(1, dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.egcl_knn_forward(
            int(cdt == torch.bfloat16), *(t.data_ptr() for t in args),
            m_sum.data_ptr(), x_out.data_ptr(), rows.data_ptr(), b, n, hdim,
            k, f1, fm, stream)
    if rc != 0:
        raise RuntimeError(
            f"egcl_knn kernel launch failed: "
            f"{lib.egcl_knn_error_string(rc).decode()} (cudaError {rc})")
    egcl_knn_launches += 1
    last_rows = rows
    return m_sum, x_out
