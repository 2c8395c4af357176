"""The int8 EGCL edge tile in stages (probe P1): the CUDA kernel, its plain
PyTorch versions, and the probe.

Replaces ``benchmarks/probe_kernel_stages.py``:

- ``edge_stage(mode, ...)``, ``:126 make_call(mode)``: the edge tile at
  the flagship's widths (N=192, F1=1024, FM=256) in three stages, "mm"
  (the int8 products of prebuilt int8 rows, consumed by group sums),
  "mm_post" (also the dequant, SiLU, the wa and wx3 heads, the gate, the
  pair mask and the coordinate update) and "full_serial" (also the build
  of the int8 rows from the node projections, in the kernel);
- ``x_branch(q, w)``, ``:169 make_call_x(dtype)``: the x product alone,
  int8 or bf16, group sums of its first 8 columns;
- ``x_branch_blocked(q, w, wx3)``, ``:239 make_call_xblk(dtype)``: the x
  product consumed in 256-column blocks, the SiLU'd block dotted with wx3.

The plain versions keep the TPU probe's bf16 rounding points: x_i, mask_i
and the i-side projections are rounded to bf16 (its one-hot repeat), every
summand of a group sum is rounded to bf16 before a float32 sum, and the
full_serial build rounds after each bf16 operation. Each function also
returns ``check [B, N]``: the wrapping int32 sum (float32 for bf16) of every
product entry of target i's edges, which the kernel writes so that no
product column is dead code; int32 stages match bit for bit.

The kernel (``csrc/probe_kernel_stages.cu``) walks the B N N edge rows
flattened, in tiles of ``TILE_ROWS``, on a persistent grid of clusters of
two blocks that share W by TMA multicast; ``grid`` sizes that grid from
the clusters the card holds at once, and the kernel's library states the
scratch a launch needs (``probe_stages_scratch_bytes``).

    python -m diffusion_model_tpu_torch.probes.kernel_stages [mode ...]

prints one line per mode (mm mm_post full_serial x8 xbf xblk8 xblkbf) with
ms per layer call and TOP/s, as the TPU probe did, beside the product alone
through one PyTorch call (``library``). It needs a CUDA card and exits
non-zero without one.
"""

from __future__ import annotations

import ctypes
import functools
import math
import sys

import torch

from diffusion_model_tpu_torch.probes import _common

B, N, F1, FM = 1, 192, 1024, 256
T_CALLS = 50
MODES = ("mm", "mm_post", "full_serial")
X_MODES = {"x8": ("x", torch.int8), "xbf": ("x", torch.bfloat16),
           "xblk8": ("xblk", torch.int8), "xblkbf": ("xblk", torch.bfloat16)}
_MODE_CODE = {"mm": 0, "mm_post": 1, "full_serial": 2, "x": 3, "xblk": 4}

# Launches of the CUDA kernel in this process; only edge_stage, x_branch and
# x_branch_blocked add to it, right after a launch was accepted.
probe_kernel_stages_launches = 0

_SOURCE = "probe_kernel_stages.cu"
_ENTRY = "probe_stages"
_BF = torch.bfloat16

TILE_ROWS = 128      # edge rows of a tile
CLUSTER = 2          # blocks of a cluster, one tile of a pair each
MAX_BUILD_F1 = 1024  # full_serial keeps a tile's int8 rows in shared memory


def mxu_ops(n: int = N, f1: int = F1, fm: int = FM) -> int:
    """Tensor-core operations of one edge_stage call."""
    return 2 * n * n * (f1 * f1 + f1 * fm)


def tile_count(b: int, n: int) -> int:
    """Tiles of ``TILE_ROWS`` over the B N N flattened edge rows."""
    return -(-b * n * n // TILE_ROWS)


def grid(b: int, n: int, active: int) -> int:
    """Blocks of the persistent grid: a cluster a tile pair, at most the
    ``active`` clusters the card holds at once."""
    if active < 1:
        raise ValueError(f"the card holds {active} clusters of {CLUSTER}")
    pairs = -(-tile_count(b, n) // CLUSTER)
    return CLUSTER * min(active, pairs)


def sfu_ops(mode: str, b: int = B, n: int = N, f1: int = F1,
            fm: int = FM) -> int:
    """MUFU operations of one call, from the kernel's instructions: one
    ``tanh.approx`` a SiLU of the epilogues (every om and ox value of
    mm_post and full_serial, every product of xblk); a row's gate (ex2 and
    a reciprocal, in each of the quad's four lanes), norm (rsqrt) and
    division (a reciprocal) in mm_post and full_serial; ex2 and a
    reciprocal a value of full_serial's build (both branches)."""
    e = b * n * n
    kind = mode if mode in MODES else X_MODES[mode][0]
    post = e * (fm + f1) + e * (4 * 2 + 2)
    return {"mm": 0, "x": 0, "xblk": e * f1, "mm_post": post,
            "full_serial": post + 2 * 2 * e * f1}[kind]


def _bf(v: torch.Tensor) -> torch.Tensor:
    """Round to bf16, back in float32."""
    return v.to(_BF).float()


def _silu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def _group_sum(v: torch.Tensor) -> torch.Tensor:
    """[B, N, N, F] -> [B, N, F]: sum over j of bf16-rounded summands."""
    return _bf(v).sum(dim=2)


def _product(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q @ w in float32 (TF32 off); int32 for int8 inputs, which is exact:
    every partial sum is an integer below F1 * 127**2 < 2**24."""
    o = q.float() @ w.float()
    return o.to(torch.int32) if q.dtype == torch.int8 else o


def _checksum(*products: torch.Tensor) -> torch.Tensor:
    """Per target [B, N]: wrapping int32 sum of int products, or float32 sum
    of float ones, over every source j and column."""
    if products[0].dtype == torch.int32:
        total = sum(p.to(torch.int64).sum(dim=(2, 3)) for p in products)
        return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)
    return sum(p.sum(dim=(2, 3)) for p in products)


def _edges(q: torch.Tensor) -> tuple:
    """[B, N*N, F] -> ([B, N, N, F], N)."""
    b, nn, f = q.shape
    n = math.isqrt(nn)
    if n * n != nn:
        raise ValueError(f"q has {nn} edge rows, not N*N for any N")
    return q.reshape(b, n, n, f), n


def _geometry(x: torch.Tensor, mask: torch.Tensor) -> tuple:
    """diff, d2 [B,N,N,1] and pm [B,N,N,1], with x_i and mask_i rounded to
    bf16 as the TPU probe's one-hot repeat rounds them."""
    n = x.shape[1]
    diff = _bf(x)[:, :, None, :] - x[:, None, :, :]
    d2 = (diff * diff).sum(dim=-1, keepdim=True)
    off = 1.0 - torch.eye(n, dtype=torch.float32, device=x.device)
    pm = _bf(mask)[:, :, None, :] * mask[:, None, :, :] * off[None, :, :,
                                                             None]
    return diff, d2, pm


def _build(a_i, a_j, w_d, d2) -> torch.Tensor:
    """full_serial's int8 rows, each bf16 operation rounded as bf16."""
    pre = (a_i[:, :, None, :] + a_j[:, None, :, :]) + d2.to(_BF) * w_d
    q = torch.round(_silu(pre.float()) * 32.0).clamp_(-127, 127)
    return q.to(torch.int8)


def edge_stage_reference(mode, am_i, am_j, ax_i, ax_j, x, mask, qm, qx, w_dm,
                         w_dx, w2m_q, w2x_q, wx3, wa) -> tuple:
    """Plain statement of ``make_call(mode)``: (m_sum [B,N,FM],
    x_out [B,N,8], check [B,N] int32)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    diff, d2, pm = _geometry(x, mask)
    if mode == "full_serial":
        qm4 = _build(am_i, am_j, w_dm, d2)
        qx4 = _build(ax_i, ax_j, w_dx, d2)
    else:
        qm4, qx4 = _edges(qm)[0], _edges(qx)[0]
    om = _product(qm4, w2m_q)
    ox = _product(qx4, w2x_q)
    check = _checksum(om, ox)
    if mode == "mm":
        return _group_sum(om.float()), _group_sum(ox[..., :8].float()), check
    m = _bf(_silu(om.float() * (1.0 / 2048.0)))
    u = _bf(_silu(ox.float() * (1.0 / 2048.0)))
    s = u @ _bf(wx3)
    gate = torch.sigmoid(m @ _bf(wa)) * pm
    m_sum = _group_sum(m * gate)
    norm = torch.sqrt(torch.where(pm > 0, d2.clamp_min(1e-12),
                                  torch.ones_like(d2)))
    upd = _group_sum(diff * (s * pm / (norm + 1.0)))
    x_out = torch.cat([upd, torch.zeros_like(upd[..., :1]).expand(
        *upd.shape[:-1], 5)], dim=-1)
    return m_sum, x_out, check


def x_branch_reference(q, w) -> tuple:
    """Plain statement of ``make_call_x``: (x_out [B,N,8], check [B,N])."""
    ox = _product(_edges(q)[0], w)
    return _group_sum(ox[..., :8].float()), _checksum(ox)


def x_branch_blocked_reference(q, w, wx3) -> tuple:
    """Plain statement of ``make_call_xblk``: (x_out [B,N,8], check)."""
    ox = _product(_edges(q)[0], w)
    s = _bf(_silu(ox.float() * (1.0 / 2048.0))) @ _bf(wx3)
    return (_group_sum(s.expand(*s.shape[:-1], 8)), _checksum(ox))


_STAGE_NAMES = ("am_i", "am_j", "ax_i", "ax_j", "x", "mask", "qm", "qx",
                "w_dm", "w_dx", "w2m_q", "w2x_q", "wx3", "wa")


def _check_stage(args: dict, mode: str = "mm") -> None:
    """Raise on anything the stage kernel does not take."""
    b, n, f1 = args["am_i"].shape
    fm = args["w2m_q"].shape[-1]
    if f1 % 256 or fm != 256:
        raise ValueError(f"kernel takes F1 in multiples of 256 and FM = "
                         f"256; got F1={f1}, FM={fm}")
    if mode == "full_serial" and f1 > MAX_BUILD_F1:
        raise ValueError(f"full_serial builds a tile's rows in shared "
                         f"memory: F1 at most {MAX_BUILD_F1}; got {f1}")
    want = {"am_i": (_BF, (b, n, f1)), "am_j": (_BF, (b, n, f1)),
            "ax_i": (_BF, (b, n, f1)), "ax_j": (_BF, (b, n, f1)),
            "x": (torch.float32, (b, n, 3)),
            "mask": (torch.float32, (b, n, 1)),
            "qm": (torch.int8, (b, n * n, f1)),
            "qx": (torch.int8, (b, n * n, f1)),
            "w_dm": (_BF, (1, f1)), "w_dx": (_BF, (1, f1)),
            "w2m_q": (torch.int8, (f1, fm)),
            "w2x_q": (torch.int8, (f1, f1)),
            "wx3": (torch.float32, (f1, 1)), "wa": (torch.float32, (fm, 1))}
    device = args["am_i"].device
    for name, (dtype, shape) in want.items():
        _common.check_tensor(name, args[name], device=device, dtype=dtype,
                             shape=shape)


def _check_x(q, w, wx3=None) -> None:
    """Raise on anything the x-branch kernel does not take."""
    if q.dtype not in (torch.int8, _BF):
        raise TypeError(f"q has dtype {q.dtype}: int8 or bfloat16")
    if q.dim() != 3:
        raise ValueError(f"q has shape {tuple(q.shape)}, want [B, N*N, F1]")
    b, nn, f1 = q.shape
    _edges(q)
    if f1 % 256:
        raise ValueError(f"kernel takes F1 in multiples of 256; got {f1}")
    _common.check_tensor("q", q, device=q.device, dtype=q.dtype,
                         shape=(b, nn, f1))
    _common.check_tensor("w", w, device=q.device, dtype=q.dtype,
                         shape=(f1, f1))
    if wx3 is not None:
        _common.check_tensor("wx3", wx3, device=q.device,
                             dtype=torch.float32, shape=(f1, 1))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _common.load_library(
        _SOURCE, _ENTRY,
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 18 + [ctypes.c_longlong]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.probe_stages_active_clusters.argtypes = [ctypes.c_int] * 3
    lib.probe_stages_active_clusters.restype = ctypes.c_int
    lib.probe_stages_scratch_bytes.argtypes = [ctypes.c_int] * 6
    lib.probe_stages_scratch_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def active_clusters(device_index: int, code: int, int8: bool,
                    f1: int) -> int:
    """Clusters of two the card holds at once for this mode's kernel."""
    with torch.cuda.device(device_index):
        return _library().probe_stages_active_clusters(code, int(int8), f1)


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


def _launch(mode: str, int8: bool, ptrs: dict, outs: tuple, b: int, n: int,
            f1: int, fm: int, device) -> None:
    global probe_kernel_stages_launches
    lib = _library()
    args = [None if ptrs.get(k) is None else ptrs[k].data_ptr()
            for k in _STAGE_NAMES]
    code = _MODE_CODE[mode]
    blocks = grid(b, n, active_clusters(device.index or 0, code, int8, f1))
    size = lib.probe_stages_scratch_bytes(code, int(int8), b, n, f1, fm)
    scratch = torch.empty(size, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        rc = lib.probe_stages(code, int(int8), *args,
                              *(None if o is None else o.data_ptr()
                                for o in outs),
                              scratch.data_ptr(), size, b, n, f1, fm, blocks,
                              _common.stream_of(device))
    _common.raise_on(rc, lib, _ENTRY)
    probe_kernel_stages_launches += 1


def _device_or_raise(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel-stages kernel for device {t.device}")


def edge_stage(mode, am_i, am_j, ax_i, ax_j, x, mask, qm, qx, w_dm, w_dx,
               w2m_q, w2x_q, wx3, wa) -> tuple:
    """One layer call of the staged edge tile (see the module docstring).

    Args (the TPU probe's): am_i, am_j, ax_i, ax_j ``[B, N, F1]`` bf16;
      x ``[B, N, 3]`` and mask ``[B, N, 1]`` float32; qm, qx
      ``[B, N*N, F1]`` int8 (edge row i*N + j; unread by full_serial);
      w_dm, w_dx ``[1, F1]`` bf16; w2m_q ``[F1, FM]`` and w2x_q
      ``[F1, F1]`` int8; wx3 ``[F1, 1]`` and wa ``[FM, 1]`` float32.

    Returns:
      (m_sum ``[B, N, FM]``, x_out ``[B, N, 8]`` float32, check ``[B, N]``
      int32).
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    args = dict(zip(_STAGE_NAMES, (am_i, am_j, ax_i, ax_j, x, mask, qm, qx,
                                   w_dm, w_dx, w2m_q, w2x_q, wx3, wa)))
    if am_i.device.type == "cpu":
        return edge_stage_reference(mode, *args.values())
    _device_or_raise(am_i)
    _check_stage(args, mode)
    b, n, f1 = am_i.shape
    fm = w2m_q.shape[-1]
    m_sum = torch.empty((b, n, fm), dtype=torch.float32, device=am_i.device)
    x_out = torch.empty((b, n, 8), dtype=torch.float32, device=am_i.device)
    check = torch.empty((b, n), dtype=torch.int32, device=am_i.device)
    _launch(mode, True, args, (m_sum, x_out, check), b, n, f1, fm,
            am_i.device)
    return m_sum, x_out, check


def _x_call(mode: str, q, w, wx3) -> tuple:
    b, nn, f1 = q.shape
    n = math.isqrt(nn)
    x_out = torch.empty((b, n, 8), dtype=torch.float32, device=q.device)
    check = torch.empty((b, n), device=q.device, dtype=(
        torch.int32 if q.dtype == torch.int8 else torch.float32))
    _launch(mode, q.dtype == torch.int8,
            {"qx": q, "w2x_q": w, "wx3": wx3}, (None, x_out, check), b, n,
            f1, 0, q.device)
    return x_out, check


def x_branch(q, w) -> tuple:
    """``make_call_x``: q ``[B, N*N, F1]`` int8 or bf16, w ``[F1, F1]`` of
    the same dtype. Returns (x_out ``[B, N, 8]``, check ``[B, N]``)."""
    if q.device.type == "cpu":
        return x_branch_reference(q, w)
    _device_or_raise(q)
    _check_x(q, w)
    return _x_call("x", q, w, None)


def x_branch_blocked(q, w, wx3) -> tuple:
    """``make_call_xblk``: as ``x_branch``, with wx3 ``[F1, 1]`` float32;
    the product is consumed in blocks of 256 columns."""
    if q.device.type == "cpu":
        return x_branch_blocked_reference(q, w, wx3)
    _device_or_raise(q)
    _check_x(q, w, wx3)
    return _x_call("xblk", q, w, wx3)


def make_inputs(device, n: int = N, f1: int = F1, fm: int = FM,
                seed: int = 0) -> dict:
    """The TPU probe's inputs (its ``main``), drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, scale=0.5, dtype=_BF):
        return (torch.randn(shape, generator=g, device=device) * scale
                ).to(dtype)

    def rndq(shape):
        return (torch.randn(shape, generator=g, device=device) * 40
                ).clamp_(-127, 127).to(torch.int8)

    return {"am_i": rnd((B, n, f1)), "am_j": rnd((B, n, f1)),
            "ax_i": rnd((B, n, f1)), "ax_j": rnd((B, n, f1)),
            "x": rnd((B, n, 3), 3.0, torch.float32),
            "mask": torch.ones((B, n, 1), device=device),
            "qm": rndq((B, n * n, f1)), "qx": rndq((B, n * n, f1)),
            "w_dm": rnd((1, f1)), "w_dx": rnd((1, f1)),
            "w2m_q": rndq((f1, fm)), "w2x_q": rndq((f1, f1)),
            "wx3": rnd((f1, 1), 0.05, torch.float32),
            "wa": rnd((fm, 1), 0.05, torch.float32)}


def make_x_inputs(dtype, device, n: int = N, f1: int = F1,
                  seed: int = 7) -> tuple:
    """(q, w, wx3) of the x-branch modes, as the TPU probe draws them."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, n * n, f1), generator=g, device=device)
    w = torch.randn((f1, f1), generator=g, device=device)
    if dtype == torch.int8:
        q, w = ((v * 40).clamp_(-127, 127).to(torch.int8) for v in (q, w))
    else:
        q, w = q.to(dtype), w.to(dtype)
    wx3 = torch.randn((f1, 1), generator=g, device=device) * 0.05
    return q, w, wx3


def library_call(mode: str, inputs: dict):
    """The product alone (no epilogue) through one PyTorch call a product,
    at this mode's shapes: ``torch._int_mm`` (cuBLAS) for int8, both
    products for the stages, with w laid out column-major beforehand (its
    int8 kernels run several times slower on a row-major w); ``q @ w`` for
    bf16. A yardstick of speed, called by no port code."""
    def col_major(w):
        return w.t().contiguous().t()

    if mode in MODES:
        f1 = inputs["w2m_q"].shape[0]
        qm, qx = (inputs[k].reshape(-1, f1) for k in ("qm", "qx"))
        wm, wx = col_major(inputs["w2m_q"]), col_major(inputs["w2x_q"])
        return lambda: (torch._int_mm(qm, wm), torch._int_mm(qx, wx))
    q, w = inputs["q"], inputs["w"]
    q2 = q.reshape(-1, q.shape[-1])
    if q.dtype == torch.int8:
        wc = col_major(w)
        return lambda: torch._int_mm(q2, wc)
    return lambda: q2 @ w


def variants(device, n: int = N) -> dict:
    """name -> {"kernel", "plain", "library": calls on the probe's inputs,
    "ops": its tensor-core operations, "bound": the card's bound for the
    call (operations, bytes and, where the mode has SiLUs, the SFU at the
    card's highest clock)} for every mode the probe times."""
    args = make_inputs(device, n)
    f1, fm = args["w2m_q"].shape
    clock = _common.sm_clock_hz()
    reads = {"mm": ("qm", "qx", "w2m_q", "w2x_q"),
             "mm_post": ("x", "mask", "qm", "qx", "w2m_q", "w2x_q", "wx3",
                         "wa"),
             "full_serial": ("am_i", "am_j", "ax_i", "ax_j", "x", "mask",
                             "w_dm", "w_dx", "w2m_q", "w2x_q", "wx3", "wa")}
    out = {}
    for mode in MODES:
        moved = (_common.nbytes(*(args[k] for k in reads[mode]))
                 + B * n * (fm + 8 + 1) * 4)
        out[mode] = {
            "kernel": functools.partial(edge_stage, mode, **args),
            "plain": functools.partial(edge_stage_reference, mode,
                                       *args.values()),
            "library": library_call(mode, args),
            "ops": mxu_ops(n, f1, fm),
            "bound": _common.bound(moved, int8=mxu_ops(n, f1, fm),
                                   sfu=sfu_ops(mode, B, n, f1, fm),
                                   sm_clock_hz=clock)}
    for name, (kind, dtype) in X_MODES.items():
        q, w, wx3 = make_x_inputs(dtype, device, n)
        call, plain = ((x_branch, x_branch_reference) if kind == "x" else
                       (x_branch_blocked, x_branch_blocked_reference))
        inputs = (q, w) if kind == "x" else (q, w, wx3)
        moved = _common.nbytes(*inputs) + B * n * (8 + 1) * 4
        ops = {"int8" if dtype == torch.int8 else "bf16": 2 * n * n * f1 * f1}
        out[name] = {"kernel": functools.partial(call, *inputs),
                     "plain": functools.partial(plain, *inputs),
                     "library": library_call(name, {"q": q, "w": w}),
                     "ops": 2 * n * n * f1 * f1,
                     "bound": _common.bound(
                         moved, sfu=sfu_ops(name, B, n, f1), sm_clock_hz=clock,
                         **ops)}
    return out


def check_on_card(table: dict) -> list:
    """Each mode against its plain version: the outputs within relative L2
    1e-5 for mm (the same bf16 summands in another order) and 1e-2 for the
    others, the checksum of the int32 products bit for bit (of the float32
    products within relative 1e-3), and a second launch bit for bit the
    first. full_serial's checksum is reported only: its int8 rows round
    silu(pre) * 32, where the kernel's and PyTorch's exp may part at a
    half. Raises on a miss."""
    records = []
    for name, calls in table.items():
        got, again, want = calls["kernel"](), calls["kernel"](), calls["plain"]()
        torch.cuda.synchronize()
        rec = {"mode": name, "max_abs_err": max(
            float((g - w).abs().max()) for g, w in zip(got[:-1], want[:-1])),
            "repeatable": all(torch.equal(g, a) for g, a in zip(got, again))}
        for what, g, w in zip(("m_sum", "x_out") if len(got) == 3
                              else ("x_out",), got[:-1], want[:-1]):
            rec[f"rel_l2_{what}"] = _common.rel_l2(g, w)
            rec[f"finite_{what}"] = bool(torch.isfinite(g).all())
        if got[-1].dtype == torch.int32:
            rec["check_mismatches"] = int((got[-1] != want[-1]).sum())
            ok_check = (rec["check_mismatches"] == 0
                        or name == "full_serial")
        else:
            err = (got[-1] - want[-1]).abs().max() / want[-1].abs().max()
            rec["check_rel"] = float(err)
            ok_check = rec["check_rel"] <= 1e-3
        rec["limit_rel_l2"] = 1e-5 if name == "mm" else 1e-2
        records.append(rec)
        rels = [v for k, v in rec.items() if k.startswith("rel_l2")]
        finite = all(v for k, v in rec.items() if k.startswith("finite"))
        if not (ok_check and finite and rec["repeatable"]
                and max(rels) <= rec["limit_rel_l2"]):
            raise AssertionError(f"kernel stage off its plain version: {rec}")
    return records


def check_padded(device) -> list:
    """mm_post and full_serial at N with the last 5 targets masked: their
    m_sum and x_out rows exactly zero, the rest within relative L2 1e-2 of
    the plain version. Raises on a miss."""
    padded = 5
    args = make_inputs(device, seed=3)
    args["mask"][:, N - padded:] = 0.0
    records = []
    for mode in ("mm_post", "full_serial"):
        got = edge_stage(mode, **args)
        want = edge_stage_reference(mode, *args.values())
        torch.cuda.synchronize()
        rec = {"mode": mode, "padded_targets": padded,
               "padded_nonzero": int(sum(
                   int((g[:, N - padded:] != 0).sum()) for g in got[:2])),
               "rel_l2": max(_common.rel_l2(g, w)
                             for g, w in zip(got[:2], want[:2]))}
        records.append(rec)
        if rec["padded_nonzero"] or not rec["rel_l2"] <= 1e-2:
            raise AssertionError(f"padded targets not inert: {rec}")
    return records


def measure(table: dict, reps: int = T_CALLS) -> list:
    """ms per layer call of each mode on the card (the mean of ``reps``
    calls between CUDA events: W's transpose, the counters' reset and the
    stage kernel of each), its TOP/s, the card's bound for the call, and
    the product alone through one PyTorch call timed the same way
    (``library_ms``, no epilogue)."""
    records = []
    for name, calls in table.items():
        ms = _common.cuda_ms(calls["kernel"], reps)
        library_ms = _common.cuda_ms(calls["library"], reps)
        rec = {"mode": name, "ms_per_layer_call": ms,
               "tops": calls["ops"] / ms / 1e9, "library_ms": library_ms,
               "over_library": ms / library_ms, **calls["bound"]}
        rec["over_bound"] = ms / rec["bound_ms"]
        if name in MODES:
            rec["ms_per_denoiser_step_5L"] = 5 * ms
        records.append(rec)
    return records


def main(argv=None) -> int:
    device = _common.card_or_none()
    if device is None:
        return 1
    names = list(argv if argv is not None else sys.argv[1:]) or [
        *MODES, *X_MODES]
    unknown = set(names) - set(MODES) - set(X_MODES)
    if unknown:
        print(f"unknown modes {sorted(unknown)}", file=sys.stderr)
        return 2
    build()
    _common.emit({"devices": [torch.cuda.get_device_name(0)],
                  "card": _common.card_line(), "n": N,
                  "tile_rows": TILE_ROWS, "cluster": CLUSTER})
    table = {k: v for k, v in variants(device).items() if k in names}
    for rec in check_on_card(table):
        _common.emit({"check": rec})
    if {"mm_post", "full_serial"} <= set(names):
        for rec in check_padded(device):
            _common.emit({"check_padded": rec})
    for rec in measure(table):
        _common.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
