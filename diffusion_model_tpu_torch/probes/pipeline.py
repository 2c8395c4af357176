"""bf16(silu(a @ w)) with and without an overlapped epilogue (probe P3): the
CUDA kernel, its plain PyTorch version, and the probe.

``silu_product`` replaces ``benchmarks/probe_pipeline.py:40 make_seq``
(``schedule="seq"``) and ``:66 make_pipelined``
(``schedule="pipelined"``): ``bf16(silu(a @ w))`` at the flagship EGCL's
second-layer shape, a ``[36864, 1024]`` and w ``[1024, 1024]`` in bf16,
float32 accumulation. In ``seq`` a block finishes a tile's product, then
its epilogue; in ``pipelined`` dedicated warps run tile c's SiLU and store
while the product warps compute tile c+1.

    python -m diffusion_model_tpu_torch.probes.pipeline

prints the TPU probe's lines, ms per call of ``library`` (``F.silu(a @ w)``
through cuBLAS, a yardstick no port code calls), ``seq`` and
``pipelined``, and its verdict line with ``library`` in place of ``xla``.
It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch
import torch.nn.functional as F

from diffusion_model_tpu_torch.probes import _common

ROWS, K, N = 36864, 1024, 1024   # flagship edge-MLP second layer
SCHEDULES = ("seq", "pipelined")
T_OUTER = 20

# Launches of the CUDA kernel in this process; only ``silu_product`` adds
# to it, right after a launch was accepted.
probe_pipeline_launches = 0

_SOURCE = "probe_pipeline.cu"
_ENTRY = "probe_pipeline"


def silu_product_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain statement: float32 product (TF32 off), SiLU, bf16."""
    return F.silu(a.float() @ w.float()).to(torch.bfloat16)


def _check(a, w, schedule) -> None:
    """Raise on anything the kernel does not take."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of {SCHEDULES}")
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"a {tuple(a.shape)} and w {tuple(w.shape)} must be "
                         f"matrices")
    r, k = a.shape
    n = w.shape[1]
    if r % 128 or n % 128 or k % 64:
        raise ValueError(f"kernel takes rows and N in multiples of 128 and K "
                         f"in multiples of 64; got {r} x {k} @ {k} x {n}")
    for name, t, shape in (("a", a, (r, k)), ("w", w, (k, n))):
        _common.check_tensor(name, t, device=a.device, dtype=torch.bfloat16,
                             shape=shape)


@functools.cache
def _library() -> ctypes.CDLL:
    return _common.load_library(
        _SOURCE, _ENTRY,
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


def silu_product(a: torch.Tensor, w: torch.Tensor,
                 schedule: str = "pipelined") -> torch.Tensor:
    """``bf16(silu(a @ w))`` for bf16 a ``[R, K]`` and w ``[K, N]``."""
    global probe_pipeline_launches
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of {SCHEDULES}")
    if a.device.type == "cpu":
        return silu_product_reference(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"no pipeline kernel for device {a.device}")
    _check(a, w, schedule)
    r, k = a.shape
    n = w.shape[1]
    out = torch.empty((r, n), dtype=torch.bfloat16, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.probe_pipeline(int(schedule == "pipelined"), a.data_ptr(),
                                w.data_ptr(), out.data_ptr(), r, k, n,
                                _common.stream_of(a.device))
    _common.raise_on(rc, lib, _ENTRY)
    probe_pipeline_launches += 1
    return out


def library_silu_product(a, w):
    """``F.silu(a @ w)`` through cuBLAS: the yardstick, no port code calls
    it."""
    return F.silu(a @ w)


def make_inputs(rows: int, k: int, n: int, device, seed: int = 0) -> tuple:
    """The TPU probe's inputs: a ~ N(0, 0.5^2), w ~ N(0, 0.02^2), bf16."""
    g = torch.Generator().manual_seed(seed)
    a = (torch.randn(rows, k, generator=g) * 0.5).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g) * 0.02).to(torch.bfloat16)
    return a.to(device), w.to(device)


def check_on_card(device) -> list:
    """Both schedules against the plain version at the probe's shape,
    relative L2 <= 1e-2 (bf16 output). Raises on a miss."""
    a, w = make_inputs(ROWS, K, N, device)
    want = silu_product_reference(a, w)
    records = []
    for schedule in SCHEDULES:
        got = silu_product(a, w, schedule)
        torch.cuda.synchronize()
        rec = {"schedule": schedule, "rel_l2": _common.rel_l2(got, want),
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "tolerance": "relative L2 1e-2"}
        records.append(rec)
        if not rec["rel_l2"] <= 1e-2:
            raise AssertionError(f"pipeline kernel off its plain version: "
                                 f"{rec}")
    return records


def measure(device, reps: int = T_OUTER) -> dict:
    """ms per call (CUDA events, mean of ``reps`` after a warm-up) of the
    library call and both schedules, the TPU probe's verdict, and the
    card's bound."""
    a, w = make_inputs(ROWS, K, N, device)
    t_lib = _common.cuda_ms(lambda: library_silu_product(a, w), reps)
    t_seq = _common.cuda_ms(lambda: silu_product(a, w, "seq"), reps)
    t_pipe = _common.cuda_ms(lambda: silu_product(a, w, "pipelined"), reps)
    return {"library_ms": t_lib, "seq_ms": t_seq, "pipelined_ms": t_pipe,
            "pipelined_vs_library": t_pipe / t_lib,
            "pipelined_vs_seq": t_pipe / t_seq,
            "verdict": ("BUILD the kernel" if t_pipe < 0.9 * t_lib
                        else "gate stays closed"),
            **_common.bound(_common.nbytes(a, w) + ROWS * N * 2,
                            bf16=2 * ROWS * K * N)}


def main() -> int:
    device = _common.card_or_none()
    if device is None:
        return 1
    build()
    _common.emit({"devices": [torch.cuda.get_device_name(0)],
                  "card": _common.card_line()})
    for rec in check_on_card(device):
        _common.emit({"check": rec})
    res = measure(device)
    for mode in ("library", "seq", "pipelined"):
        _common.emit({"mode": mode, "ms_per_call": res[f"{mode}_ms"]})
    _common.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
