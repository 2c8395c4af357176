"""The live-edge schedule of the bf16 EGCL edge kernels, in plain Python.

K1 (``csrc/egcl_pair.cu``) and K2 (``csrc/egcl_knn.cu``) share it through
``csrc/egcl_edge_tile.cuh``: a block owns a run of consecutive targets in
the flattened (b, i) order, possibly across graphs, and computes their live
edges only, in (target, j or slot) order, in tiles of ``ROWS`` rows. The
number of targets per block comes from the shape alone (``B * N`` targets of
at most ``E`` edges each), never from the mask. ``edge_tiles`` in
``ops/egcl_pair.py`` and ``ops/egcl_knn.py`` states each kernel's live edges;
``schedule`` here lays them out as the kernel does and says how many tile
rows it computes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ROWS = 64              # rows of a tile (wgmma M), csrc kRows
TILES_PER_BLOCK = 4    # full tiles per block when every edge is live
SMS = 132              # blocks the grid aims at: one per SM of an H100
MAX_TB = 1024          # targets per block, at most (csrc kMaxTB)


def targets_per_block(targets: int, edges_per_target: int) -> int:
    """``targets_per_block_bf16`` of ``csrc/egcl_edge_tile.cuh``."""
    per_block = ROWS * TILES_PER_BLOCK
    want = -(-targets * edges_per_target // per_block)
    want = min(max(want, 1), SMS)
    return min(max(-(-targets // want), 1), MAX_TB)


@dataclasses.dataclass
class EdgeTiles:
    """The schedule of one launch.

    ``blocks[g]`` is the range of flattened targets block g owns and
    ``edges[g]`` its live edges in the order its tiles hold them, one row
    each: (target, position, source) with position j (K1) or the slot (K2)
    and source the flattened node b * N + j. ``rows`` is what the kernel
    counts: every block's edges rounded up to whole tiles.
    """

    targets_per_block: int
    blocks: list
    edges: list
    rows: int
    live_edges: int


def schedule(live: np.ndarray, source: np.ndarray,
             edges_per_target: int) -> EdgeTiles:
    """Lay out the live edges ``live [T, P]`` (position p of target t is an
    edge) with source nodes ``source [T, P]`` as the kernel does."""
    n_targets = live.shape[0]
    tb = targets_per_block(n_targets, edges_per_target)
    blocks, edges = [], []
    rows = 0
    for start in range(0, n_targets, tb):
        stop = min(start + tb, n_targets)
        t, pos = np.nonzero(live[start:stop])
        t = t + start
        edges.append(np.stack([t, pos, source[t, pos]], axis=1))
        blocks.append(range(start, stop))
        rows += -(-len(t) // ROWS) * ROWS
    return EdgeTiles(tb, blocks, edges, rows, int(live.sum()))
