"""The port's evaluators (``ops.rdf``, ``ops.angles``, ``evals``) against the
JAX package's, on the flagship's test conditions and on noised copies of
them (numpy seeds).

Tolerances: RDF bin counts exactly; RDF curves rtol 1e-5 / atol 1e-6 of
the curve's max (the 41-tap smoothing sums in another order); the metrics
of one pair of curves rtol 1e-12 (float64 numpy on both sides); the numpy
CN2 readout bit for bit; ``cn2_statistics`` (float32 on a device) rtol
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.evals import cn2 as jcn2
from diffusion_model_tpu.evals import rdf as jrdf
from diffusion_model_tpu.ops import angles as jangles
from diffusion_model_tpu.ops import rdf as jops
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.evals import cn2, rdf
from diffusion_model_tpu_torch.ops import angles
from diffusion_model_tpu_torch.ops import rdf as ops
from torch_port_fixtures import FIXTURE

torch.set_num_threads(4)

NOISE = (0.0, 0.05, 0.3, 1.0)   # A, std of the position noise
COPIES = 5


@pytest.fixture(scope="module")
def conditions():
    with np.load(FIXTURE) as fx:
        return fx["cond_pos"], fx["cond_mask"], fx["cond_species"]


def noised(pos, mask, std, seed):
    rng = np.random.default_rng(seed)
    return (pos + rng.normal(size=pos.shape) * std * mask[..., None]
            ).astype(np.float32)


def jax_counts(pos, mask, r_max=5.0, dr=0.01):
    """The counting lines of ``diffusion_model_tpu.ops.rdf.rdf_from_exo``
    (which returns only the smoothed curve), one graph."""
    nbins = int(round(r_max / dr))
    d = jnp.linalg.norm(pos[1:] - pos[0], axis=-1)
    bin_idx = jnp.floor(d / dr).astype(jnp.int32) - 1
    weights = mask[1:] * mask[0] * ((bin_idx >= 0) & (bin_idx < nbins))
    return jnp.zeros((nbins,), jnp.float32).at[
        jnp.clip(bin_idx, 0, nbins - 1)].add(weights)


def assert_curves_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("std", NOISE)
def test_bin_counts_equal_jax_exactly(conditions, std):
    pos, mask, _ = conditions
    pos = noised(pos, mask, std, 1)
    want = np.asarray(jax.jit(jax.vmap(jax_counts))(pos, mask))
    got = ops.rdf_bin_counts(torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("sigma", [5.0, 2.0])
@pytest.mark.parametrize("std", NOISE)
def test_rdf_matches_jax(conditions, std, sigma):
    pos, mask, _ = conditions
    pos = noised(pos, mask, std, 2)
    fn = jax.jit(jax.vmap(lambda p, m: jops.rdf_from_exo(p, m, sigma=sigma)))
    want = np.asarray(fn(pos, mask))
    got = ops.rdf_from_exo(torch.from_numpy(pos), torch.from_numpy(mask),
                           sigma=sigma).numpy()
    assert_curves_close(got, want)


def test_rdf_without_a_mask_and_normalised_matches_jax(conditions):
    pos, mask, _ = conditions
    real = int(mask[0].sum())
    pos = noised(pos, mask, 0.3, 3)[:, :real]
    fn = jax.jit(jax.vmap(lambda p: jops.rdf_from_exo(p, normalize=True)))
    want = np.asarray(fn(pos))
    got = ops.rdf_from_exo(torch.from_numpy(pos), normalize=True).numpy()
    assert_curves_close(got, want)
    sim = ops.rdf_cos_similarity(torch.from_numpy(got[:-1]),
                                 torch.from_numpy(got[1:]))
    want_sim = jax.vmap(jops.rdf_cos_similarity)(want[:-1], want[1:])
    np.testing.assert_allclose(sim.numpy(), np.asarray(want_sim), rtol=1e-6)


@pytest.mark.parametrize("sigma", [5.0, 1.5])
def test_smoothing_matches_jax(sigma):
    y = np.random.default_rng(4).random((3, 500)).astype(np.float32)
    want = np.asarray(jops.gaussian_smooth_1d(jnp.asarray(y), sigma))
    got = ops.gaussian_smooth_1d(torch.from_numpy(y), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("std", NOISE[1:])
def test_evaluate_rdf_lists_matches_jax(conditions, std):
    pos, mask, _ = conditions
    gen = noised(pos, mask, std, 5)
    want = jrdf.evaluate_rdf_lists(pos, mask, gen, mask)
    got = rdf.evaluate_rdf_lists(pos, mask, gen, mask, device="cpu")
    assert len(got) == len(want) == len(pos)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert_curves_close(g["rdf_original"], w["rdf_original"])
        assert_curves_close(g["rdf_generated"], w["rdf_generated"])
        for k in ("cos", "euclidean", "mse", "wasserstein"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("std", NOISE)
def test_rdf_metrics_match_jax_on_the_same_curves(conditions, std):
    pos, mask, _ = conditions
    fn = jax.jit(jax.vmap(jops.rdf_from_exo))
    a = np.asarray(fn(pos, mask))
    b = np.asarray(fn(noised(pos, mask, std, 6), mask))
    for i in range(len(a)):
        got, want = rdf.rdf_metrics(a[i], b[i]), jrdf.rdf_metrics(a[i], b[i])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       err_msg=k)
    zero = np.zeros(500, np.float32)
    assert rdf.rdf_metrics(zero, a[0]) == jrdf.rdf_metrics(zero, a[0])


def cn2_results(seed: int) -> dict:
    """A result dict of ``api.generate``'s form: the flagship's 27 test
    conditions (2-shell, 5-atom CN2) and 9 one-shell graphs (3-atom CN2),
    5 samples each, positions noised, species rows permuted within the real
    rows (so the Si move, to row 0 too), some samples rejected."""
    rng = np.random.default_rng(seed)
    with np.load(FIXTURE) as fx:
        pos, species, mask = fx["cond_pos"], fx["cond_species"], \
            fx["cond_mask"]
    one_shell = collate(synthetic_sio2_dataset(seed, 9, 16, 200, shells=1),
                        16, "cpu")
    pos = np.concatenate([pos, one_shell.pos.numpy()])
    species = np.concatenate([species, one_shell.species.numpy()])
    mask = np.concatenate([mask, one_shell.mask.numpy()])
    rep = lambda a: np.repeat(a, COPIES, axis=0)
    orig_pos, orig_species, mask = rep(pos), rep(species), rep(mask)
    gen_pos = noised(orig_pos, mask, 0.2, seed + 1)
    gen_species = orig_species.copy()
    for i in range(len(mask)):
        real = int(mask[i].sum())
        if rng.random() < 0.4:
            perm = rng.permutation(real) if rng.random() < 0.3 else \
                np.concatenate([[0], 1 + rng.permutation(real - 1)])
            gen_pos[i, :real] = gen_pos[i, perm]
            gen_species[i, :real] = gen_species[i, perm]
    accepted = rng.random(len(mask)) > 0.15
    n_real = mask.sum(-1)
    assert {3.0, 5.0} <= set(n_real) and (~accepted).any()
    return {"original_pos": orig_pos, "original_species": orig_species,
            "mask": mask, "generated_pos": gen_pos,
            "generated_species": gen_species, "accepted": accepted,
            "finite": np.ones(len(mask), bool)}


def assert_same_bits(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_bits(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_bits(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cn2_readout_equals_jax_bit_for_bit(seed):
    res = cn2_results(seed)
    geo = cn2._cn2_sample_geometry(res)
    assert_same_bits(geo, jcn2._cn2_sample_geometry(res))
    assert 0 < (~geo["invalid"]).sum() < len(geo["invalid"])
    angle = cn2.conditional_angle_parity(res, COPIES)
    assert_same_bits(angle, jcn2.conditional_angle_parity(res, COPIES))
    assert_same_bits(cn2.conditional_bond_parity(res, COPIES),
                     jcn2.conditional_bond_parity(res, COPIES))
    assert_same_bits(cn2.conditional_angle_parity(res, COPIES, geo=geo),
                     angle)
    assert_same_bits(cn2.r2score(*angle), jcn2.r2score(*angle))
    assert len(angle[0]) >= 3


@pytest.mark.parametrize("group", [1, 2, 5, 7])
def test_group_means_equal_jax_bit_for_bit(group):
    rng = np.random.default_rng(group)
    a = rng.normal(size=40)
    b = rng.normal(size=40)
    a[[3, 17]] = np.nan
    b[25] = np.inf
    invalid = rng.random(40) < 0.1
    assert_same_bits(cn2.per_graph_group_means(a, group),
                     jcn2.per_graph_group_means(a, group))
    assert_same_bits(cn2.aligned_group_means(a, b, group, invalid),
                     jcn2.aligned_group_means(a, b, group, invalid))
    assert_same_bits(cn2.aligned_group_means(a, b, group),
                     jcn2.aligned_group_means(a, b, group))


@pytest.mark.parametrize("x,y", [
    ([], []), ([1.0, 1.0, 1.0], [1.0, 2.0, 3.0]),
    ([1.0, 2.0, 3.0], [2.0, 2.0, 2.0]),
    ([1.0, 2.0, 3.0, 4.0], [1.1, 1.9, 3.2, 3.9]),
])
def test_r2score_edge_cases_equal_jax(x, y):
    got, want = cn2.r2score(x, y), jcn2.r2score(x, y)
    assert (np.isnan(got) and np.isnan(want)) or got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_si_o_si_filter_equals_jax_bit_for_bit(seed):
    res = cn2_results(seed)
    args = (res["generated_pos"], res["generated_species"], res["mask"])
    keep, triplets = cn2.filter_si_o_si(*args)
    want_keep, want_triplets = jcn2.filter_si_o_si(*args)
    assert keep == want_keep and len(keep) > 0
    assert_same_bits(triplets, want_triplets)
    empty = cn2.filter_si_o_si(*(a[:0] for a in args))
    assert empty[0] == [] and empty[1].shape == (0, 3, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_cn2_statistics_match_jax(seed):
    res = cn2_results(seed)
    _, triplets = cn2.filter_si_o_si(res["generated_pos"],
                                     res["generated_species"], res["mask"])
    got = cn2.cn2_statistics(triplets, device="cpu")
    want = jcn2.cn2_statistics(triplets)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_angle_ops_match_jax(conditions):
    pos, mask, _ = conditions
    pos = noised(pos, mask, 0.1, 8)
    t = torch.from_numpy(pos)
    np.testing.assert_allclose(angles.cn2_angle_deg(t).numpy(),
                               np.asarray(jangles.cn2_angle_deg(pos)),
                               rtol=1e-6)
    for got, want in zip(angles.cn2_bond_lengths(t),
                         jangles.cn2_bond_lengths(pos)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
