"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source in ``diffusion_model_tpu_torch/csrc/`` exposes a plain C
entry point, so it compiles in seconds without PyTorch's headers. The
shared library goes to ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded from the cache. ``build_all`` starts one nvcc per missing library,
all at once. A library is written under a temporary name and renamed into
place, so two processes building at once cannot leave a half-written file
behind.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")


def find_nvcc() -> str:
    """nvcc from PyTorch's CUDA_HOME, else from PATH; raises if neither."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the CUDA "
            "kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` is cached."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = Path(source).stem
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_all(sources: Sequence[str]) -> list:
    """Compile every ``csrc/<source>`` whose cached library is missing, one
    nvcc process each, all started together; return the library paths."""
    todo = [s for s in sources if not library_path(s).exists()]
    jobs = []
    try:
        if todo:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for source in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
            jobs.append((source, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failures = []
        for source, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed on {source} (exit "
                                f"{proc.returncode}):\n{out}\n{err}")
            else:
                os.replace(tmp, library_path(source))
        if failures:
            raise RuntimeError("\n".join(failures))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [library_path(s) for s in sources]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its cached library exists."""
    return build_all([source])[0]


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """Build if needed, then load ``csrc/<source>`` once per process."""
    return ctypes.CDLL(str(build(source)))
