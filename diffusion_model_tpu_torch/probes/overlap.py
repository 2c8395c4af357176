"""Tensor-core and CUDA-core work in one loop (probe P4): the CUDA kernel,
its plain PyTorch version, and the probe.

``overlap`` replaces ``benchmarks/probe_overlap.py:45 make_call``. Mode
"mxu" runs the int8 chain of ``matmul_rate`` (``x <- clip((x @ w) >> 9,
+-127)``), mode "vpu" an independent float32 chain ``y <- y * sigmoid(y) +
0.3`` four times a link, mode "both" the two at once on the same SMs. On
this card "mxu" means the tensor cores and "vpu" the CUDA cores and the
special-function unit (SFU); the names are the TPU probe's. The kernel
(``csrc/probe_overlap.cu``) is P2's int8 block chain (its launch plan,
``matmul_rate.chain_plan``) with a side warpgroup in every block that
carries y in registers; the mode chooses which of them works, on one grid.

    python -m diffusion_model_tpu_torch.probes.overlap

prints ``t_mxu``, ``t_vpu``, ``t_both`` (seconds of ``T_OUTER`` calls, as
the TPU probe printed them) and ``overlap_fraction = (t_m + t_v - t_c) /
min(t_m, t_v)``: 1 is perfect overlap, 0 none. It needs a CUDA card and
exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from diffusion_model_tpu_torch.probes import _common, matmul_rate
from diffusion_model_tpu_torch.probes.matmul_rate import product, requant

M, N, STEPS = 512, 1024, 256     # the TPU probe's shape and loop length
FILL_M = 132 * 2 * 16            # a card-filling M: 66 chains of 64 rows
T_OUTER = 20                     # calls a timing covers, as on the TPU
VPU_REPEAT = 4
MODES = ("mxu", "vpu", "both")
WIDTHS = (256, 512, 1024)        # N the kernel takes
MUFU_PER_SIGMOID = 2             # ex2 and the reciprocal

# Launches of the CUDA kernel in this process; only ``overlap`` adds to it,
# right after a launch was accepted.
probe_overlap_launches = 0

_SOURCE = "probe_overlap.cu"
_ENTRY = "probe_overlap"


def vpu_link(y: torch.Tensor) -> torch.Tensor:
    for _ in range(VPU_REPEAT):
        y = y * torch.sigmoid(y) + 0.3
    return y


def overlap_reference(a, w, y, steps: int = STEPS, mode: str = "both"):
    """Plain statement: returns (x int8, y float32) after ``steps`` links."""
    x = a
    for _ in range(steps):
        if mode in ("mxu", "both"):
            x = requant(product(x, w), torch.int8)
        if mode in ("vpu", "both"):
            y = vpu_link(y)
    return x, y


def _check(a, w, y, steps, mode) -> None:
    """Raise on anything the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if a.dim() != 2:
        raise ValueError(f"a has shape {tuple(a.shape)}, want [M, N]")
    m, n = a.shape
    if n not in WIDTHS or m < 1:
        raise ValueError(f"kernel takes N in {WIDTHS} and M >= 1; got M={m}, "
                         f"N={n}")
    if not isinstance(steps, int) or steps < 0:
        raise ValueError(f"steps must be an int >= 0, got {steps!r}")
    for name, t, dtype, shape in (("a", a, torch.int8, (m, n)),
                                  ("w", w, torch.int8, (n, n)),
                                  ("y", y, torch.float32, (m, n))):
        _common.check_tensor(name, t, device=a.device, dtype=dtype,
                             shape=shape)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _common.load_library(
        _SOURCE, _ENTRY,
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2)
    lib.probe_overlap_active_clusters.argtypes = [ctypes.c_int] * 3
    lib.probe_overlap_active_clusters.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


@functools.cache
def _card_active(cluster: int, ns: int, smem: int) -> int:
    """Clusters of this shape the card holds at once, for this kernel."""
    return _library().probe_overlap_active_clusters(ns, cluster, smem)


def card_plan(m: int, n: int = N) -> dict:
    """The launch plan of ``overlap``: P2's rule for an int8 block chain
    (``matmul_rate.chain_plan``), with the card's answer for this kernel."""
    return matmul_rate.chain_plan(m, n, torch.int8, "block",
                                  active=_card_active)


def held_sms(plan: dict) -> int:
    """SMs a launch of ``plan`` holds at once: its blocks, or as many as
    the card holds clusters of at once (one block an SM)."""
    cluster = plan["chains"] * plan["cs"]
    return min(plan["blocks"], plan["active_clusters"] * cluster)


def overlap(a, w, y, steps: int = STEPS, mode: str = "both"):
    """``steps`` links of the chosen chains.

    Args:
      a: ``[M, N]`` int8, the x chain's start; w: ``[N, N]`` int8;
      y: ``[M, N]`` float32, the y chain's start.
      mode: "mxu" (x only), "vpu" (y only) or "both".

    Returns:
      (x ``[M, N]`` int8, y ``[M, N]`` float32); a chain the mode does not
      run comes back as it went in.
    """
    global probe_overlap_launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if a.device.type == "cpu":
        return overlap_reference(a, w, y, steps, mode)
    if a.device.type != "cuda":
        raise ValueError(f"no overlap kernel for device {a.device}")
    return _launch(a, w, y, steps, mode)[:2]


def _launch(a, w, y, steps, mode):
    """Check, plan, launch, count, and hold the kernel's plan to
    ``card_plan``; returns (x, y, the plan with ``active_clusters``)."""
    global probe_overlap_launches
    _check(a, w, y, steps, mode)
    m, n = a.shape
    keys = matmul_rate.PLAN_KEYS
    with torch.cuda.device(a.device):
        lib = _library()
        want = card_plan(m, n)
        x_out = torch.empty_like(a)
        y_out = torch.empty_like(y)
        wt = torch.empty_like(w)           # w transposed, the kernel's scratch
        used = (ctypes.c_int * (len(keys) + 1))()
        rc = lib.probe_overlap(
            MODES.index(mode), a.data_ptr(), w.data_ptr(), wt.data_ptr(),
            y.data_ptr(), x_out.data_ptr(), y_out.data_ptr(), m, n, steps,
            ctypes.addressof(used), _common.stream_of(a.device))
    _common.raise_on(rc, lib, _ENTRY)
    probe_overlap_launches += 1
    got = dict(zip(keys, used))
    if got != want:
        raise RuntimeError(f"{_ENTRY} used the plan {got}, chain_plan says "
                           f"{want}")
    return x_out, y_out, got | {"active_clusters": used[len(keys)]}


def make_inputs(m: int, n: int, device, seed: int = 0) -> tuple:
    """The TPU probe's inputs: int8 ``clip(20 v)`` for a and w, y normal."""
    g = torch.Generator().manual_seed(seed)
    a, w, y = (torch.randn(shape, generator=g)
               for shape in ((m, n), (n, n), (m, n)))
    a, w = ((v * 20).clamp(-127, 127).to(torch.int8) for v in (a, w))
    return a.to(device), w.to(device), y.to(device)


def check_on_card(device, short: int = 3, ms=(M, FILL_M)) -> list:
    """Each mode against the plain version at every M that ``measure``
    times: x bit for bit over ``short`` links and over the full loop, y
    within rtol 1e-5 over ``short`` links and finite over the full loop.
    Raises on any miss."""
    records = []
    for m, mode in ((m, mode) for m in ms for mode in MODES):
        a, w, y = make_inputs(m, N, device)
        for steps in (short, STEPS):
            got_x, got_y = overlap(a, w, y, steps, mode)
            want_x, want_y = overlap_reference(a, w, y, steps, mode)
            torch.cuda.synchronize()
            x_err = float((got_x.float() - want_x.float()).abs().max())
            y_err = float((got_y - want_y).abs().max())
            rec = {"mode": mode, "m": m, "steps": steps,
                   "x_mismatches": int((got_x != want_x).sum()),
                   "y_max_abs_err": y_err, "max_abs_err": max(x_err, y_err),
                   "y_finite": bool(torch.isfinite(got_y).all())}
            records.append(rec)
            ok = rec["x_mismatches"] == 0 and rec["y_finite"]
            if ok and steps == short:
                torch.testing.assert_close(got_y, want_y, rtol=1e-5,
                                           atol=1e-5)
            if not ok:
                raise AssertionError(f"overlap kernel off its plain "
                                     f"version: {rec}")
    return records


def sfu_ops(m: int, n: int = N, steps: int = STEPS) -> int:
    """MUFU operations of the y chain: two a sigmoid."""
    return MUFU_PER_SIGMOID * VPU_REPEAT * m * n * steps


def measure(device, reps: int = T_OUTER,
            shapes=(("tpu", M), ("card_filling", FILL_M))) -> list:
    """Per shape: ms per call of each mode (CUDA events, mean of ``reps``
    after a warm-up), the TPU probe's t_* (seconds of T_OUTER calls), the
    overlap fraction, the plan, the bound of mode "both" (over the card)
    and the SFU's time on the SMs the plan holds, beside vpu's."""
    clock = _common.sm_clock_hz()
    records = []
    for shape, m in shapes:
        a, w, y = make_inputs(m, N, device)
        ms = {mode: _common.cuda_ms(lambda: overlap(a, w, y, STEPS, mode),
                                    reps)
              for mode in MODES}
        t_m, t_v, t_c = (ms[k] * T_OUTER / 1e3 for k in MODES)
        plan = card_plan(m)
        plan["active_clusters"] = _card_active(
            plan["chains"] * plan["cs"], plan["ns"], plan["smem"])
        sms = held_sms(plan)
        sfu_on_plan = _common.bound(0, sfu=sfu_ops(m), sms=sms,
                                    sm_clock_hz=clock)["bound_ms"]
        records.append({
            "shape": shape, "m": m, "steps": STEPS,
            **{f"{k}_ms": v for k, v in ms.items()},
            "t_mxu": t_m, "t_vpu": t_v, "t_both": t_c,
            "overlap_fraction": (t_m + t_v - t_c) / min(t_m, t_v),
            "note": "mxu = tensor cores, vpu = CUDA cores and SFU",
            "plan": plan, "sms_held": sms, "sm_clock_hz": clock,
            "sfu_ms_on_plan_sms": sfu_on_plan,
            "vpu_over_sfu_on_plan_sms": ms["vpu"] / sfu_on_plan,
            # the bound of "both": a sigmoid link counts five float32
            # operations (exp, add, reciprocal, multiply, add) and two
            # MUFU ones
            **_common.bound(
                2 * _common.nbytes(a, y) + _common.nbytes(w),
                int8=2 * m * N * N * STEPS,
                f32=5 * VPU_REPEAT * m * N * STEPS, sfu=sfu_ops(m),
                sm_clock_hz=clock)})
    return records


def main() -> int:
    device = _common.card_or_none()
    if device is None:
        return 1
    build()
    _common.emit({"devices": [torch.cuda.get_device_name(0)],
                  "card": _common.card_line()})
    for rec in check_on_card(device):
        _common.emit({"check": rec})
    for rec in measure(device):
        _common.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
