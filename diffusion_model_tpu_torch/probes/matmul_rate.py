"""Chained tensor-core products, bf16 and int8 (probe P2): the CUDA kernel,
its plain PyTorch version, and the probe.

``chain`` replaces ``benchmarks/probe_matmul_rate.py:45 pallas_chain``
(``schedule="block"``) and ``:71 pallas_chain_ilp`` (``schedule="warp"``):
the serial chain ``x <- requant(x @ w)``, ``steps`` times, with int8
products into int32 and requant ``clip(o >> 9, +-127)``, or bf16 products
into float32 and requant ``bf16(o * 0.03125)``. Each link needs the whole
previous x, so no compiler can drop one. The int8 chain is exact in float32
(every partial sum is an integer below 1024 * 127**2 < 2**24), so the
plain version, a float32 matmul with TF32 off (PyTorch's default), gives
the kernel's bits.

    python -m diffusion_model_tpu_torch.probes.matmul_rate

prints, as the TPU probe did, one JSON line per variant with its TOP/s:
the kernel's two schedules and the cuBLAS chain (``library_*``, a
yardstick that no code of the port calls), at the TPU probe's M = 512 and
at a card-filling M. It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from diffusion_model_tpu_torch.probes import _common

M, N, STEPS = 512, 1024, 256     # the TPU probe's shape and chain length
FILL_M = 132 * 128               # rows that fill the card's 132 SMs
SCHEDULES = {"block": 32, "warp": 128}   # schedule -> rows M must divide by

# Launches of the CUDA kernel in this process; only ``chain`` adds to it,
# right after a launch was accepted.
probe_matmul_rate_launches = 0

_SOURCE = "probe_matmul_rate.cu"
_ENTRY = "probe_chain"


def requant(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 -> int8 ``clip(o >> 9, +-127)``; float32 -> bf16 ``o / 32``."""
    if dtype == torch.int8:
        return (o >> 9).clamp_(-127, 127).to(torch.int8)
    return (o * 0.03125).to(dtype)


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in float32 (TF32 off), as int32 for int8 inputs (exact)."""
    o = x.float() @ w.float()
    return o.to(torch.int32) if x.dtype == torch.int8 else o


def chain_reference(a: torch.Tensor, w: torch.Tensor,
                    steps: int = STEPS) -> torch.Tensor:
    """Plain statement of the chain."""
    x = a
    for _ in range(steps):
        x = requant(product(x, w), a.dtype)
    return x


def _check(a, w, steps, schedule) -> None:
    """Raise on anything the kernel does not take."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of "
                         f"{tuple(SCHEDULES)}")
    if a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"a has dtype {a.dtype}: the chain is int8 or "
                        f"bfloat16")
    if a.dim() != 2:
        raise ValueError(f"a has shape {tuple(a.shape)}, want [M, N]")
    m, n = a.shape
    if n % 256 or m % SCHEDULES[schedule]:
        raise ValueError(
            f"kernel takes N in multiples of 256 and M in multiples of "
            f"{SCHEDULES[schedule]} ({schedule} chains); got M={m}, N={n}")
    if not isinstance(steps, int) or steps < 0:
        raise ValueError(f"steps must be an int >= 0, got {steps!r}")
    for name, t, shape in (("a", a, (m, n)), ("w", w, (n, n))):
        _common.check_tensor(name, t, device=a.device, dtype=a.dtype,
                             shape=shape)


@functools.cache
def _library() -> ctypes.CDLL:
    return _common.load_library(
        _SOURCE, _ENTRY,
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


def chain(a: torch.Tensor, w: torch.Tensor, steps: int = STEPS,
          schedule: str = "block") -> torch.Tensor:
    """``steps`` links of ``x <- requant(x @ w)`` from x = a.

    Args:
      a: ``[M, N]`` int8 or bfloat16; w: ``[N, N]`` of the same dtype.
      schedule: "block" (a block of 8 warps carries 32 rows' chain in
        shared memory; ``pallas_chain``) or "warp" (each warp carries its
        own 32 rows' chain; ``pallas_chain_ilp``).

    Returns:
      x after the last link, ``[M, N]`` in a's dtype.
    """
    global probe_matmul_rate_launches
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of "
                         f"{tuple(SCHEDULES)}")
    if a.device.type == "cpu":
        return chain_reference(a, w, steps)
    if a.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {a.device}")
    _check(a, w, steps, schedule)
    m, n = a.shape
    out = torch.empty_like(a)
    scratch = torch.empty_like(a) if schedule == "warp" else None
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.probe_chain(
            int(a.dtype == torch.int8), int(schedule == "warp"),
            a.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), m, n, steps,
            _common.stream_of(a.device))
    _common.raise_on(rc, lib, _ENTRY)
    probe_matmul_rate_launches += 1
    return out


def library_chain(a: torch.Tensor, w: torch.Tensor,
                  steps: int = STEPS) -> torch.Tensor:
    """The same chain through cuBLAS (``torch._int_mm`` for int8): the
    yardstick of speed, timed beside the kernel and called by no port code."""
    x = a
    for _ in range(steps):
        if a.dtype == torch.int8:
            x = requant(torch._int_mm(x, w), torch.int8)
        else:
            x = (x @ w).mul_(0.03125)    # a power of 2: the same rounding
    return x


def make_inputs(m: int, n: int, dtype: torch.dtype, device,
                seed: int = 0) -> tuple:
    """The TPU probe's inputs: standard normals, as int8 ``clip(20 v)``."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, n, generator=g)
    w = torch.randn(n, n, generator=g)
    if dtype == torch.int8:
        a, w = ((v * 20).clamp(-127, 127).to(torch.int8) for v in (a, w))
    else:
        a, w = a.to(dtype), w.to(dtype)
    return a.to(device), w.to(device)


def check_on_card(device, short: int = 3) -> list:
    """Each schedule and dtype against the plain version at M = 512: int8
    bit for bit over ``short`` links and over the full chain, bf16 by
    relative L2 <= 1e-2 over ``short`` links and finite over the full chain.
    Raises on any miss; returns the records."""
    records = []
    for dtype in (torch.int8, torch.bfloat16):
        a, w = make_inputs(M, N, dtype, device)
        for schedule in SCHEDULES:
            for steps in (short, STEPS):
                got = chain(a, w, steps, schedule)
                want = chain_reference(a, w, steps)
                torch.cuda.synchronize()
                rec = {"schedule": schedule, "dtype": str(dtype)[6:],
                       "steps": steps, "max_abs_err": float(
                           (got.float() - want.float()).abs().max())}
                if dtype == torch.int8:
                    rec["mismatches"] = int((got != want).sum())
                    rec["tolerance"] = "bit for bit"
                    ok = rec["mismatches"] == 0
                elif steps == short:
                    rec["rel_l2"] = _common.rel_l2(got, want)
                    rec["tolerance"] = "relative L2 1e-2"
                    ok = rec["rel_l2"] <= 1e-2
                else:
                    rec["finite"] = bool(torch.isfinite(got.float()).all())
                    ok = rec["finite"]
                records.append(rec)
                if not ok:
                    raise AssertionError(f"chain kernel off its plain "
                                         f"version: {rec}")
    return records


def measure(device, reps: int = 10, shapes=(("tpu", M), ("card_filling",
                                                        FILL_M))) -> list:
    """TOP/s of each variant of the full chain, CUDA events, mean of
    ``reps`` calls after a warm-up, beside the card's bound for the chain."""
    records = []
    for shape, m in shapes:
        ops = 2 * m * N * N * STEPS
        for dtype in (torch.bfloat16, torch.int8):
            a, w = make_inputs(m, N, dtype, device)
            name = "int8" if dtype == torch.int8 else "bf16"
            for variant, fn in (
                    (f"library_{name}", lambda: library_chain(a, w)),
                    (f"block_{name}", lambda: chain(a, w, STEPS, "block")),
                    (f"warp_{name}", lambda: chain(a, w, STEPS, "warp"))):
                ms = _common.cuda_ms(fn, reps)
                records.append({
                    "variant": variant, "shape": shape, "m": m, "ms": ms,
                    "tops": ops / ms / 1e9,
                    **_common.bound(2 * _common.nbytes(a) + _common.nbytes(w),
                                    **{name: ops})})
    return records


def main() -> int:
    device = _common.card_or_none()
    if device is None:
        return 1
    build()
    _common.emit({"devices": [torch.cuda.get_device_name(0)],
                  "card": _common.card_line(),
                  "ops_total_t": 2 * M * N * N * STEPS / 1e12,
                  "note": "one call = one chain of 256 links; tops over "
                          "mean CUDA-event time"})
    for rec in check_on_card(device):
        _common.emit({"check": rec})
    for rec in measure(device):
        _common.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
