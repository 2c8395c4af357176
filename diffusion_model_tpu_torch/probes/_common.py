"""What the hardware probes share: loading a kernel library, checking the
tensors a kernel is given, raising a launch's error, timing on the card,
and the card's bound for a given work.

Nothing here runs at import: a library is built at its first launch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch


# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet):
# operations per second by type, and bytes per second of device memory.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
MEMORY_RATE = 3.35e12
# The special-function unit (exp2, reciprocal, tanh: MUFU) of a Hopper SM
# completes 16 operations a clock (4 a sub-partition); its rate is that times
# the SMs times the SM clock.
SFU_PER_CLOCK = 16
H100_SMS = 132


def bound(moved: int, *, sfu: int = 0, sms: int = H100_SMS,
          sm_clock_hz: float | None = None, **ops) -> dict:
    """The least time the card could take, in ms: the largest of ``moved``
    bytes at the memory rate, the operations ``ops[kind]`` at each kind's
    peak, and ``sfu`` MUFU operations at ``SFU_PER_CLOCK`` a clock on
    ``sms`` SMs at ``sm_clock_hz`` (kinds run on separate units), with each
    of those times. ``bound_by`` is "bytes" or "operations";
    ``bound_kind`` names the unit ("bytes", a type of ``PEAK_OPS``, or
    "sfu")."""
    times = {kind: n / PEAK_OPS[kind] * 1e3 for kind, n in ops.items()}
    if sfu:
        if not sm_clock_hz:
            raise ValueError("an SFU bound needs the SM clock")
        times["sfu"] = sfu / (SFU_PER_CLOCK * sms * sm_clock_hz) * 1e3
    times["bytes"] = moved / MEMORY_RATE * 1e3
    slowest = max(times, key=times.get)
    return {"bound_ms": times[slowest],
            "bound_by": "bytes" if slowest == "bytes" else "operations",
            "bound_kind": slowest, "bound_ms_by": times}


def sm_clock_hz() -> float:
    """The card's highest SM clock, in Hz, as ``nvidia-smi`` reports it
    (``clocks.max.sm``): the clock a bound assumes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def load_library(source: str, entry: str, argtypes: list) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; declare the C entry
    ``entry`` and its ``<entry>_error_string``."""
    from diffusion_model_tpu_torch.ops import _build

    lib = _build.load(source)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{entry}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def raise_on(rc: int, lib: ctypes.CDLL, entry: str) -> None:
    """Raise if the C entry ``entry`` returned a cudaError_t other than 0."""
    if rc != 0:
        msg = getattr(lib, f"{entry}_error_string")(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg} (cudaError {rc})")


def check_tensor(name: str, t: torch.Tensor, *, device: torch.device,
                 dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` lies on ``device`` with this dtype and shape,
    contiguous and 16-byte aligned, and needs no gradient."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad: the probes have no backward")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, after
    one warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_or_none() -> torch.device | None:
    """cuda:0, or None (with a message on stderr) where there is no card."""
    if not torch.cuda.is_available():
        print("this probe needs a CUDA card: its kernel is CUDA C++ for "
              "sm_90a", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())
