"""``edge_tiles``: the live-edge schedule of the bf16 EGCL kernels (K1, K2).

The schedule is what the card kernels compute, and the count of tile rows
they report is held to it on the card (``test_torch_cuda.py``,
``chip_smoke.py``). Here, on the CPU, it is held to its own contract on
random masks: every live edge exactly once, in (target, j or slot) order;
blocks of consecutive targets in the flattened (b, i) order that cover all
targets; at most 63 padded rows a block; the block size from the shape
alone.
"""

import numpy as np
import pytest
import torch

from diffusion_model_tpu_torch.ops import _tiles, egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import dense_pair_mask, knn_edges
from torch_port_fixtures import knn_lists


def _pair_mask(seed, b, n, n_real):
    """[B, N, 1] masks with n_real[g] real atoms scattered over the graph."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, n, 1), np.float32)
    for g, k in enumerate(n_real):
        mask[g, rng.permutation(n)[:k], 0] = rng.uniform(0.5, 1.0, k)
    return torch.from_numpy(mask)


def _check_layout(sched, n_targets, live, source, edges_per_target):
    """The contract shared by both kernels' schedules."""
    tb = _tiles.targets_per_block(n_targets, edges_per_target)
    assert sched.targets_per_block == tb
    starts = [blk.start for blk in sched.blocks]
    assert starts == list(range(0, n_targets, tb))
    assert sched.blocks[-1].stop == n_targets
    for blk in sched.blocks:
        assert blk.step == 1 and 0 < len(blk) <= tb
    seen = np.concatenate(sched.edges) if sched.edges else np.zeros((0, 3))
    want_t, want_p = np.nonzero(live)
    # every live edge exactly once, in (target, position) order
    np.testing.assert_array_equal(seen[:, 0], want_t)
    np.testing.assert_array_equal(seen[:, 1], want_p)
    np.testing.assert_array_equal(seen[:, 2], source[want_t, want_p])
    rows = 0
    for blk, edges in zip(sched.blocks, sched.edges):
        assert np.all((edges[:, 0] >= blk.start) & (edges[:, 0] < blk.stop))
        block_rows = -(-len(edges) // _tiles.ROWS) * _tiles.ROWS
        assert block_rows <= len(edges) + _tiles.ROWS - 1
        rows += block_rows
    assert sched.rows == rows
    assert sched.live_edges == len(want_t)
    assert sched.rows <= sched.live_edges + (_tiles.ROWS - 1) * len(
        sched.blocks)


@pytest.mark.parametrize("seed,b,n,n_real", [
    (0, 6, 16, (0, 1, 2, 16, 5, 0)),       # graphs of 0, 1 and 2 atoms
    (1, 80, 16, None),                      # the served chunk
    (2, 1, 192, (192,)),                    # the headline cell
    (3, 3, 70, (70, 1, 33)),
    (4, 2, 5, (5, 3)),
    (5, 300, 40, None),                     # more targets than one per SM
    (6, 1, 1, (1,)),                        # no pair at all
])
def test_pair_schedule_holds_its_contract(seed, b, n, n_real):
    if n_real is None:
        n_real = [max(n - g % 7, 0) for g in range(b)]
    mask = _pair_mask(seed, b, n, n_real)
    sched = egcl_pair.edge_tiles(mask)
    live = (dense_pair_mask(mask[..., 0]) != 0).numpy().reshape(b * n, n)
    source = (np.arange(b)[:, None, None] * n
              + np.arange(n)[None, None, :]).repeat(n, 1).reshape(b * n, n)
    _check_layout(sched, b * n, live, source, n - 1)
    # the same mask as [B, N] gives the same schedule
    again = egcl_pair.edge_tiles(mask[..., 0])
    assert again.rows == sched.rows
    for a, c in zip(again.edges, sched.edges):
        np.testing.assert_array_equal(a, c)


def _knn_case(seed, b, n, k, n_real, shuffle):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    mask = np.zeros((b, n), np.float32)
    for g, real in enumerate(n_real):
        mask[g, rng.permutation(n)[:real]] = 1.0
    idx, em = knn_lists(x, mask, k)
    if shuffle:                             # live slots no longer a prefix
        perm = rng.permutation(k)
        idx, em = idx[..., perm].copy(), em[..., perm].copy()
        idx[0, 0, 0] = n + 3                # an unmasked slot out of range
        em[0, 0, 0] = 1.0
        idx[-1, -1, -1] = -2
        em[-1, -1, -1] = 1.0
    return torch.from_numpy(idx), torch.from_numpy(em)


@pytest.mark.parametrize("seed,b,n,k,shuffle", [
    (0, 80, 16, 15, False),                 # the served kNN chunk
    (1, 2, 40, 20, True),                   # K does not divide the tile
    (2, 2, 90, 70, True),                   # K above one tile
    (3, 1, 2048, 32, False),                # the large cell
    (4, 3, 24, 7, True),
    (5, 2, 512, 32, True),
])
def test_knn_schedule_holds_its_contract(seed, b, n, k, shuffle):
    n_real = [n - 1 - (g % 5) for g in range(b)]
    if b > 2:
        n_real[1] = 0                       # a graph of padding only
    idx, em = _knn_case(seed, b, n, k, n_real, shuffle)
    sched = egcl_knn.edge_tiles(idx, em)
    i64 = idx.numpy().astype(np.int64)
    live = ((em.numpy() != 0) & (i64 >= 0) & (i64 < n)).reshape(b * n, k)
    source = (np.arange(b)[:, None, None] * n + i64).reshape(b * n, k)
    _check_layout(sched, b * n, live, source, k)
    # all-masked targets (padding) have no edge in the schedule
    dead = np.nonzero(~live.any(axis=1))[0]
    assert not np.isin(dead, np.concatenate(sched.edges)[:, 0]).any()


def test_knn_at_k_n_minus_1_is_the_pair_schedule():
    """Over the real atoms, K = N-1 lists hold the dense pairs: the two
    schedules hold the same edges, in the same blocks."""
    mask = _pair_mask(7, 80, 16, [16 - g % 5 for g in range(80)])
    pos = torch.from_numpy(
        np.random.default_rng(7).normal(size=(80, 16, 3)).astype(np.float32))
    idx, em = knn_edges(pos, mask[..., 0] != 0, 15)
    pair = egcl_pair.edge_tiles(mask)
    knn = egcl_knn.edge_tiles(idx, em)
    assert pair.targets_per_block == knn.targets_per_block
    assert pair.rows == knn.rows and pair.live_edges == knn.live_edges
    for p, q in zip(pair.edges, knn.edges):
        np.testing.assert_array_equal(p[:, 0], q[:, 0])
        np.testing.assert_array_equal(np.sort(p[:, 2]), np.sort(q[:, 2]))


@pytest.mark.parametrize("targets,edges,want", [
    (1280, 15, 18),       # 80 x 16: 75 blocks wanted, 18 targets each
    (192, 191, 2),        # 1 x 192: at most one block per SM
    (2048, 32, 16),       # 1 x 2048, K = 32
    (1024, 32, 8),        # 2 x 512
    (10, 4, 10),          # a tiny launch: one block
    (10 ** 6, 32, 1024),  # capped: more blocks than SMs
    (5, 0, 5),            # no edges at all
])
def test_targets_per_block_rule(targets, edges, want):
    assert _tiles.targets_per_block(targets, edges) == want


def test_served_chunk_computes_under_twice_its_live_pairs():
    """The acceptance bound at 80 x 16: rows <= 2 x live edges."""
    n_real = [16 - g % 5 for g in range(80)]
    sched = egcl_pair.edge_tiles(_pair_mask(8, 80, 16, n_real))
    assert sched.rows <= 2 * sched.live_edges
