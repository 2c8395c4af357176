"""ctypes bindings of the native (C++) dataset-builder routines, as
``diffusion_model_tpu/data/native.py``: the shell BFS over the 3x3x3
supercell, the distance matrix and the kNN lists of ``native/graphbuild.cpp``.

The port builds its own library from that source with g++ on first use,
into ``build/native/`` at the root of the checkout, named by a hash of the
source and the flags (as ``ops/_build.py`` names the CUDA libraries), and
never writes the JAX package's ``native/libgraphbuild.so``. A library is
written under a temporary name and renamed into place.

``load_library`` returns None where the library cannot be built or loaded,
and ``data/shells.py`` then takes its numpy route, which gives the same
selection and order; ``require_library`` raises with the compiler's
message instead, for a caller that must have the native route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graphbuild.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native: a library left in build/ by one machine must load on
# another that shares the checkout
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_error = None


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``native/graphbuild.cpp`` is cached."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return build_dir / f"libgraphbuild_{digest.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library into ``build_dir`` unless its cached copy exists
    there; raises with the compiler's output if it fails."""
    path = library_path(build_dir)
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native shell builder cannot "
                           "be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed on {SOURCE.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def require_library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The shared library, built if needed; raises if it cannot be. With
    ``build_dir`` it is built there (or found there) and loaded in place of
    any library loaded before, for a caller that must build it anew."""
    global _lib, _error
    if _lib is not None and build_dir is None:
        return _lib
    lib = ctypes.CDLL(str(build_library(build_dir or BUILD_DIR)))
    lib.build_shells.restype = ctypes.c_int
    lib.build_shells.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.distance_matrix.restype = None
    lib.distance_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.knn_indices.restype = None
    lib.knn_indices.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib, _error = lib, None
    return _lib


def load_library():
    """The shared library, or None if it cannot be built or loaded (the
    numpy route applies; a failed build is not tried again)."""
    global _error
    if _lib is None and _error is None:
        try:
            require_library()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = str(e)
    return _lib


def available() -> bool:
    return load_library() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_shells_native(lattice: np.ndarray, frac: np.ndarray,
                        exo_index: int, n_shells: int, cutoff: float = 2.0):
    """Native twin of shells.shell_indices over the 3x3x3 supercell.

    Returns (pos [M,3] float64 relative to exO, src [M] int32 unit-cell site
    indices, exO first).
    """
    lib = require_library()
    lattice = np.ascontiguousarray(lattice, np.float64)
    frac = np.ascontiguousarray(frac, np.float64)
    n = frac.shape[0]
    max_out = 27 * n
    out_pos = np.zeros((max_out, 3), np.float64)
    out_src = np.zeros((max_out,), np.int32)
    count = lib.build_shells(
        _dptr(lattice), _dptr(frac), n, exo_index, n_shells,
        ctypes.c_double(cutoff), _dptr(out_pos), _iptr(out_src), max_out,
    )
    if count < 0:
        raise RuntimeError("build_shells overflow or bad exo_index")
    return out_pos[:count], out_src[:count]


def distance_matrix_native(pos: np.ndarray) -> np.ndarray:
    lib = require_library()
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    out = np.zeros((n, n), np.float64)
    lib.distance_matrix(_dptr(pos), n, _dptr(out))
    return out


def knn_indices_native(pos: np.ndarray, k: int) -> np.ndarray:
    lib = require_library()
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    out = np.zeros((n, k), np.int32)
    lib.knn_indices(_dptr(pos), n, k, _iptr(out))
    return out
