"""The port's synthetic dataset and split against the JAX package's.

Both are numpy on both sides, so a seed gives the same graphs and the same
split bit for bit; the flagship's test split is also the committed
fixture's ``cond_*`` arrays, which the card holds the port's data to.
"""

import numpy as np
import pytest
import torch

from diffusion_model_tpu.data.split import split_dataset as jax_split
from diffusion_model_tpu.data.synthetic import (
    synthetic_sio2_dataset as jax_dataset,
)
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.split import split_dataset
from diffusion_model_tpu_torch.data.synthetic import (
    _random_unit_vectors,
    make_graph,
    synthetic_sio2_dataset,
)
from diffusion_model_tpu_torch.evals.restore_check import held_out_conditions
from diffusion_model_tpu_torch.train.checkpoint import load_config_npz
from torch_port_fixtures import FIXTURE, NUM_GRAPHS, SNAPSHOT

torch.set_num_threads(4)

FIELDS = ("pos", "species", "spectrum", "exo", "cn", "mean_angle_deg", "id")


def assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in FIELDS:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert type(g[k]) is type(w[k]) and g[k] == w[k], k


def test_test_split_equals_the_fixture_bit_for_bit():
    cfg = load_config_npz(str(SNAPSHOT))
    test = held_out_conditions(cfg, NUM_GRAPHS, shells=2)
    batch = collate(test, cfg.n_max, "cpu")
    with np.load(FIXTURE) as fx:
        for field in ("pos", "species", "spectrum", "exo", "mask"):
            got = getattr(batch, field).numpy()
            want = fx[f"cond_{field}"]
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        assert [g["id"] for g in test] == list(fx["cond_id"])


@pytest.mark.parametrize("shells", [1, 2])
@pytest.mark.parametrize("seed", [2024, 2025])
def test_dataset_matches_jax_bit_for_bit(seed, shells):
    assert_graphs_equal(
        synthetic_sio2_dataset(seed, NUM_GRAPHS, 16, spectrum_size=200,
                               shells=shells),
        jax_dataset(seed, NUM_GRAPHS, 16, spectrum_size=200, shells=shells))


@pytest.mark.parametrize("n_max", [3, 6])
def test_second_shell_stops_at_n_max(n_max):
    from diffusion_model_tpu.data.synthetic import make_graph as jax_graph

    for cn in (2, 3, 4):
        got = make_graph(np.random.default_rng(cn), n_max, 20, 2, cn)
        want = jax_graph(np.random.default_rng(cn), n_max, 20, 2, cn)
        assert_graphs_equal([got], [want])
        assert len(got["pos"]) == min(1 + 2 * cn, max(n_max, 1 + cn))


def test_unit_vectors_keep_their_minimum_angle():
    from diffusion_model_tpu.data.synthetic import (
        _random_unit_vectors as jax_vectors,
    )

    got = _random_unit_vectors(np.random.default_rng(3), 4, 70.0)
    np.testing.assert_array_equal(
        got, jax_vectors(np.random.default_rng(3), 4, 70.0))
    cos = got @ got.T
    assert np.all(cos[~np.eye(4, dtype=bool)] < np.cos(np.radians(70.0)))


@pytest.mark.parametrize("n,seed", [(256, 2024), (256, 2025), (11, 7),
                                    (1, 0)])
def test_split_matches_jax(n, seed):
    items = list(range(n))
    got = split_dataset(items, seed)
    want = jax_split(items, seed)
    assert [list(p) for p in got] == [list(p) for p in want]
    assert sorted(sum(got, [])) == items
