"""The committed fixture of the PyTorch port against a fresh build of it."""

import numpy as np
import pytest
import torch

import torch_port_fixtures as fixtures

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def pair():
    with np.load(fixtures.FIXTURE) as z:
        committed = {k: z[k] for k in z.files}
    return committed, fixtures.build()


def test_same_arrays(pair):
    committed, fresh = pair
    assert sorted(committed) == sorted(fresh)
    for k in fresh:
        assert committed[k].shape == fresh[k].shape, k
        assert committed[k].dtype == fresh[k].dtype, k


@pytest.mark.parametrize("key", [
    "cond_pos", "cond_species", "cond_spectrum", "cond_exo", "cond_mask",
    "cond_id", "cell_pos", "cell_species", "cell_spectrum", "cell_exo",
    "t_frac", "in_species_t", "in_pos_t", "in_t_norm"])
def test_inputs_are_current(pair, key):
    committed, fresh = pair
    np.testing.assert_array_equal(committed[key], fresh[key])


@pytest.mark.parametrize("key", ["eps_x_float32", "eps_h_float32",
                                 "knn6_eps_x_float32", "knn6_eps_h_float32"])
def test_float32_goldens_are_current(pair, key):
    # XLA's CPU kernels may sum in another order on another CPU
    committed, fresh = pair
    np.testing.assert_allclose(committed[key], fresh[key], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("key", ["eps_x_bfloat16", "eps_h_bfloat16",
                                 "knn6_eps_x_bfloat16", "knn6_eps_h_bfloat16"])
def test_bfloat16_goldens_are_current(pair, key):
    committed, fresh = pair
    err = np.linalg.norm(committed[key] - fresh[key])
    assert err <= 1e-3 * np.linalg.norm(fresh[key])


def test_fixture_is_small():
    assert fixtures.FIXTURE.stat().st_size < 1 << 20


# --- the training fixture (chip_smoke.py's train_parity and train_learned)


@pytest.fixture(scope="module")
def train_pair():
    with np.load(fixtures.TRAIN_FIXTURE) as z:
        committed = {k: z[k] for k in z.files}
    return committed, fixtures.build_train()


def test_train_fixture_has_the_same_arrays(train_pair):
    committed, fresh = train_pair
    assert sorted(committed) == sorted(fresh)
    for k in fresh:
        assert committed[k].shape == fresh[k].shape, k
        assert committed[k].dtype == fresh[k].dtype, k


@pytest.mark.parametrize("key", ["train_pos", "draw_t", "draw_pos", "draw_h",
                                 "leaf_names", "gamma_init_l1/weight",
                                 "gamma_init_l2/weight",
                                 "gamma_init_l3/weight",
                                 "gamma_init_gamma_0", "gamma_init_gamma_1"])
def test_train_fixture_inputs_are_current(train_pair, key):
    committed, fresh = train_pair
    np.testing.assert_array_equal(committed[key], fresh[key])


@pytest.mark.parametrize("dt,rtol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_train_fixture_step_is_current(train_pair, dt, rtol):
    # XLA's CPU kernels may sum in another order on another CPU
    committed, fresh = train_pair
    for k in ("loss", "sum_sq", "grad_norm", "update_norm"):
        np.testing.assert_allclose(committed[f"{k}_{dt}"], fresh[f"{k}_{dt}"],
                                   rtol=rtol, err_msg=k)


def test_train_fixture_gamma_fit_is_current(train_pair):
    committed, fresh = train_pair
    np.testing.assert_allclose(committed["gamma_fit_alphas"],
                               fresh["gamma_fit_alphas"], rtol=0, atol=1e-5)


def test_train_fixture_is_small():
    assert fixtures.TRAIN_FIXTURE.stat().st_size < 1 << 17
