"""Where a bf16 EGCL tile spends its time: K1 and K2 timed phase by phase.

    python -m diffusion_model_tpu_torch.probes.edge_tile_phases

Needs the card. It copies ``csrc/egcl_*`` into ``build/edge_tile_phases/``,
marks the phases of the consumer loop of ``egcl_edge_tile.cuh`` with
``clock64`` (thread 0 of block 0 adds each phase's cycles to a device
counter), builds both kernels from the copy, and runs them through their
wrappers at flagship width (F1=1024, Fm=256, H=36) on the main path's
shapes: K1 at 80 x 16 (graphs of 3-16 atoms) and 1 x 192, K2 at 80 x 16
(K=15) and 1 x 2048 (K=32). One JSON line each: the cycles a tile spends in
each phase (block 0, averaged over its tiles), their shares, and the
milliseconds of the marked and of the unmarked kernel, with the card's name
and power limit. The phases:

  meta          the tile's edges, sources and geometry
  build_m       h branch: (K2) h_j @ W_j, then silu(pre) into A
  message       A @ W2m, the gate and the per-target message sums
  build_x       x branch: (K2) h_j @ W_j, then silu(pre) into A
  coord_passes  A @ W2x in 256-column passes and the wx3 head
  coord_sums    the coordinate updates and their per-target sums
  products      inside message and coord_passes: the first warpgroup's ring
                waits and wgmma loop

Each mark is a text edit of the source that must apply exactly once, so a
change to the kernel that moves a phase breaks this probe loudly rather
than timing the wrong thing (``tests/test_torch_edge_tile_phases.py``).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from diffusion_model_tpu_torch.probes._common import (
    card_line,
    card_or_none,
    cuda_ms,
    emit,
)

PHASES = ("meta", "build_m", "message", "build_x", "coord_passes",
          "coord_sums", "products")
HEADER = "egcl_edge_tile.cuh"
SHARED = "hopper_ptx.cuh"        # what HEADER includes; copied as it is
_MARK = ("if (blockIdx.x == 0 && threadIdx.x == 0) {{ const long long now = "
         "clock64(); egcl_phase_cycles[{0}] += now - mark; mark = now; }}")
_BUILD_M = ("    build_rows<Op::kJside>(A, p.am, p.bm, p.w_dm, mt, node0, "
            "p.F1);\n    fence_proxy_async();\n    consumer_sync();")
_BUILD_X = ("    build_rows<Op::kJside>(A, p.ax, p.bx, p.w_dx, mt, node0, "
            "p.F1);\n    fence_proxy_async();\n    consumer_sync();")
_META = ("    tile_meta<Op>(p, mt, off, ntb, n_edges, tile, node0, "
         "base + lay.ah);")
# (anchor, replacement) pairs on the shared header, each applied once
EDITS = (
    ("namespace egcl {\n",
     "namespace egcl {\n__device__ unsigned long long egcl_phase_cycles[8];\n"),
    (_META, "    long long mark = clock64();\n" + _META),
    ("    if (tid == 0) {  // the target that goes on into the next tile",
     "    " + _MARK.format(0) + "\n"
     "    if (tid == 0) {  // the target that goes on into the next tile"),
    (_BUILD_M, _BUILD_M + "\n    " + _MARK.format(1)),
    ("    consumer_sync();  // every product of the branch has read A",
     "    consumer_sync();  // every product of the branch has read A\n    "
     + _MARK.format(2)),
    (_BUILD_X, _BUILD_X + "\n    " + _MARK.format(3)),
    ("    // the update of each row, then",
     "    " + _MARK.format(4) + "\n    // the update of each row, then"),
    ("    consumer_sync();\n  }\n}\n\n// Launches edge_kernel",
     "    consumer_sync();\n    " + _MARK.format(5)
     + "\n  }\n}\n\n// Launches edge_kernel"),
    ("    for (int s = 0; s < nslices; ++s) {\n"
     "      const int pos = pos0 + s * stride;",
     "    const long long start = clock64();\n"
     "    for (int s = 0; s < nslices; ++s) {\n"
     "      const int pos = pos0 + s * stride;"),
    ("      ring.release(pos);\n    }\n  }\n}\n\n// K2's j-side",
     "      ring.release(pos);\n    }\n"
     "    if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "      egcl_phase_cycles[6] += clock64() - start;\n"
     "  }\n}\n\n// K2's j-side"),
)
_READER = """
extern "C" int egcl_phase_cycles_read(void* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return int(cudaMemcpyToSymbol(egcl::egcl_phase_cycles, zero,
                                  sizeof(zero)));
  }
  return int(cudaMemcpyFromSymbol(out, egcl::egcl_phase_cycles,
                                  sizeof(egcl::egcl_phase_cycles)));
}
"""
SOURCES = ("egcl_pair.cu", "egcl_knn.cu")


def instrumented_sources(dest: Path) -> list:
    """Copy the EGCL sources into ``dest`` with the phase marks; return the
    paths of the two kernel sources. Raises if a mark does not apply
    exactly once."""
    from diffusion_model_tpu_torch.ops import _build

    dest.mkdir(parents=True, exist_ok=True)
    for name in (HEADER, SHARED, *SOURCES):
        shutil.copy(_build.CSRC / name, dest / name)
    text = (dest / HEADER).read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"phase mark does not apply once: {old!r}")
        text = text.replace(old, new)
    (dest / HEADER).write_text(text)
    for name in SOURCES:
        (dest / name).write_text((dest / name).read_text() + _READER)
    return [dest / name for name in SOURCES]


def _build_marked(dest: Path) -> dict:
    """nvcc the marked sources, one process each; name -> library path."""
    from diffusion_model_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    jobs = {}
    for src in instrumented_sources(dest):
        lib = src.with_suffix(".so")
        jobs[src.stem] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the marked {name}:\n{err}")
    return {name: lib for name, (lib, _) in jobs.items()}


def _inputs(device, b, n, n_real, k=0, f1=1024, fm=256, hdim=36, seed=0):
    """Random bf16 edge inputs of K1 (k = 0) or K2 in argument order."""
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    g = torch.Generator(device=device).manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, scale=0.5, dtype=bf):
        return (torch.randn(shape, generator=g, device=device)
                * scale).to(dtype)

    mask = torch.zeros(b, n, device=device)
    for i, r in enumerate(n_real):
        mask[i, :r] = 1.0
    x = rnd(b, n, 3, scale=2.0, dtype=f32)
    heads = (rnd(f1, fm, scale=f1 ** -0.5), rnd(1, fm, dtype=f32),
             rnd(fm, 1, scale=fm ** -0.5, dtype=f32), rnd(1, 1, dtype=f32),
             rnd(f1, f1, scale=f1 ** -0.5), rnd(1, f1, dtype=f32),
             rnd(f1, 1, scale=f1 ** -0.5, dtype=f32), rnd(1, 1, dtype=f32))
    if not k:
        return (rnd(b, n, f1), rnd(b, n, f1), rnd(b, n, f1), rnd(b, n, f1),
                x, mask[..., None], rnd(1, f1, scale=0.1),
                rnd(1, f1, scale=0.1), *heads)
    idx, em = knn_edges(x, mask, k)
    return (rnd(b, n, f1), rnd(b, n, f1), rnd(b, n, hdim), x, idx, em,
            rnd(hdim, f1, scale=hdim ** -0.5),
            rnd(hdim, f1, scale=hdim ** -0.5), rnd(1, f1, scale=0.1),
            rnd(1, f1, scale=0.1), *heads)


def main(argv=None) -> int:
    from diffusion_model_tpu_torch.ops import _build, egcl_knn, egcl_pair

    device = card_or_none()
    if device is None:
        return 1
    root = _build.BUILD_DIR.parent / "edge_tile_phases"
    libs = _build_marked(root)
    card = card_line()
    served = [3 + (7 * i) % 14 for i in range(80)]
    cases = (("egcl_pair", "80x16", _inputs(device, 80, 16, served)),
             ("egcl_pair", "1x192", _inputs(device, 1, 192, [192])),
             ("egcl_knn", "80x16_k15", _inputs(device, 80, 16, served, 15)),
             ("egcl_knn", "1x2048_k32",
              _inputs(device, 1, 2048, [2048], 32)))
    for name, shape, args in cases:
        module = egcl_pair if name == "egcl_pair" else egcl_knn
        kernel = getattr(module, f"{name}_edges")
        plain_ms = cuda_ms(lambda: kernel(*args), 20)
        unmarked = module._library
        marked = ctypes.CDLL(str(libs[name]))
        entry = unmarked()
        for fn in (f"{name}_forward", f"{name}_error_string"):
            getattr(marked, fn).argtypes = getattr(entry, fn).argtypes
            getattr(marked, fn).restype = getattr(entry, fn).restype
        marked.egcl_phase_cycles_read.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
        module._library = lambda: marked
        try:
            ms = cuda_ms(lambda: kernel(*args), 20)
            marked.egcl_phase_cycles_read(None, 1)
            kernel(*args)
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * 8)()
            marked.egcl_phase_cycles_read(ctypes.addressof(cycles), 0)
        finally:
            module._library = unmarked
        sched = (egcl_pair.edge_tiles(args[5]) if name == "egcl_pair"
                 else egcl_knn.edge_tiles(args[4], args[5]))
        tiles = max(-(-len(sched.edges[0]) // 64), 1)
        per_tile = {p: cycles[i] / tiles for i, p in enumerate(PHASES)}
        total = sum(per_tile[p] for p in PHASES[:-1])
        emit({"probe": "edge_tile_phases", "card": card, "kernel": name,
              "shape": shape, "tiles_of_block_0": tiles,
              "cycles_per_tile": per_tile,
              "share": {p: per_tile[p] / total for p in PHASES},
              "marked_ms": ms, "ms": plain_ms})
    return 0


if __name__ == "__main__":
    sys.exit(main())
