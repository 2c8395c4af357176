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

On CPU tensors ``egcl_pair_edges`` runs ``egcl_pair_edges_reference``; on
CUDA tensors it launches the kernel or raises. Serving needs no gradient, so
an input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from diffusion_model_tpu_torch.ops import _tiles

# Launches of the CUDA kernel in this process; only egcl_pair_edges adds to
# it, right after a launch was accepted.
egcl_pair_launches = 0
# Tile rows the last launch computed: one int32 on the card, which every
# block of the kernel adds its rows to.
last_rows = None

_SOURCE = "egcl_pair.cu"
MAX_F1 = 1024   # first-layer width of the bf16 kernel (csrc kMaxF1)


def egcl_pair_edges_reference(am_i, am_j, ax_i, ax_j, x, mask, w_dm, w_dx,
                              w2m, b2m, wa, ba, w2x, b2x, wx3, bx3,
                              targets: slice = slice(None)):
    """Plain float32 statement of the kernel's math (materialises the
    ``[B, T, N, F]`` edge tensors) for the targets ``i`` in ``targets`` (all
    by default). Returns (m_sum [B,T,Fm], x_out [B,T,3])."""
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
    m = F.silu(F.silu(pre_m) @ w2m.to(f32) + b2m.to(f32))
    att = torch.sigmoid(m @ wa.to(f32) + ba.to(f32))
    m_sum = (m * att * pm).sum(dim=2)                        # [B,T,Fm]

    pre_x = ax_i[:, targets, None, :] + ax_j[:, None, :, :] + d2 * w_dx.to(f32)
    u = F.silu(F.silu(pre_x) @ w2x.to(f32) + b2x.to(f32))
    s = u @ wx3.to(f32) + bx3.to(f32)                        # [B,T,N,1]
    norm = torch.sqrt(torch.where(pm > 0, d2.clamp_min(1e-12),
                                  torch.ones_like(d2)))
    upd = diff * s / (norm + 1.0) * pm
    return m_sum, x_i + upd.sum(dim=2)


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
                f"{name} requires grad: the kernel has no backward yet")
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
                    wa, ba, w2x, b2x, wx3, bx3):
    """Fused EGCL edge work (see module docstring).

    Args:
      am_i, am_j, ax_i, ax_j: ``[B, N, F1]`` node projections in the compute
        dtype (bfloat16 or float32); the i-parts carry the first-layer bias.
      x: ``[B, N, 3]`` float32 coordinates; mask: ``[B, N, 1]`` float32.
      w_dm, w_dx: ``[1, F1]`` compute dtype; w2m ``[F1, Fm]`` and w2x
        ``[F1, F1]`` compute dtype; b2m ``[1, Fm]``, wa ``[Fm, 1]``,
        ba ``[1, 1]``, b2x ``[1, F1]``, wx3 ``[F1, 1]``, bx3 ``[1, 1]``
        float32.

    Returns:
      (m_sum ``[B, N, Fm]`` float32, x_out ``[B, N, 3]`` float32).
    """
    global egcl_pair_launches, last_rows
    args = (am_i, am_j, ax_i, ax_j, x, mask, w_dm, w_dx, w2m, b2m, wa, ba,
            w2x, b2x, wx3, bx3)
    device = am_i.device
    if device.type == "cpu":
        return egcl_pair_edges_reference(*args)
    if device.type != "cuda":
        raise ValueError(f"no EGCL pair kernel for device {device}")
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
