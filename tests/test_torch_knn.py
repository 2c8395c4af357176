"""The port's kNN neighbour lists and large synthetic cells against the JAX
package's ``knn_edges`` and ``amorphous_cell``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data.synthetic import (
    amorphous_cell as jax_amorphous_cell,
)
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu_torch.data.synthetic import amorphous_cell
from diffusion_model_tpu_torch.ops.edges import knn_edges
from torch_port_fixtures import knn_lists

torch.set_num_threads(4)


def _ragged(seed, b, n, n_real):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 2.0).astype(np.float32)
    mask = np.zeros((b, n), np.float32)
    for g, real in enumerate(n_real):
        mask[g, :real] = 1.0
    return pos, mask


@pytest.mark.parametrize("seed,n,k,n_real", [
    (0, 16, 4, (16, 11, 3)),      # one graph with fewer than K+1 atoms
    (1, 16, 15, (16, 9, 1)),      # K = N-1, a one-atom graph
    (2, 24, 6, (24, 24, 5)),
    (3, 12, 11, (12, 0, 7)),      # an all-padding graph
])
def test_knn_edges_match_jax(seed, n, k, n_real):
    pos, mask = _ragged(seed, len(n_real), n, n_real)
    want_idx, want_em = (np.asarray(a) for a in
                         jax_knn_edges(jnp.asarray(pos), jnp.asarray(mask), k))
    got_idx, got_em = knn_edges(torch.from_numpy(pos), torch.from_numpy(mask),
                                k)
    assert got_idx.dtype == torch.int32 and got_em.dtype == torch.float32
    assert got_idx.shape == got_em.shape == (len(n_real), n, k)
    got_idx, got_em = got_idx.numpy(), got_em.numpy()
    np.testing.assert_array_equal(got_em, want_em)
    # top-k may order equal (masked) distances differently: compare the
    # set of live neighbours of every target
    for g in range(len(n_real)):
        for i in range(n):
            got = set(got_idx[g, i][got_em[g, i] > 0].tolist())
            want = set(want_idx[g, i][want_em[g, i] > 0].tolist())
            assert got == want, (g, i)
            assert i not in got and all(mask[g, j] > 0 for j in got)
    assert np.all(got_em[mask == 0] == 0)
    # nearest first, as the numpy statement the card's tests use
    np.testing.assert_array_equal(got_em, knn_lists(pos, mask, k)[1])


def test_knn_edges_counts_real_neighbours():
    pos, mask = _ragged(4, 2, 10, (10, 4))
    _, em = knn_edges(torch.from_numpy(pos), torch.from_numpy(mask), 5)
    np.testing.assert_array_equal(em.sum(-1).numpy(),
                                  [[5] * 10, [3] * 4 + [0] * 6])


@pytest.mark.parametrize("seed,num_atoms", [(0, 192), (7, 300)])
def test_amorphous_cell_bit_identical_to_jax(seed, num_atoms):
    want = jax_amorphous_cell(seed=seed, num_atoms=num_atoms)
    got = amorphous_cell(seed=seed, num_atoms=num_atoms)
    assert sorted(got) == sorted(want)
    for key in ("pos", "species", "spectrum", "exo"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["id"] == want["id"] and got["cn"] == want["cn"]
