"""``evals/amorphous.py`` of the port against the JAX package's, on stacks of
G=4 network cells of 48-64 atoms padded to 64 (CPU).

What is numpy on both sides (pair distances, bond lists, coordination and
angle statistics, the radial envelope, the envelope-matched cloud's draws,
the high-pass, every panel entry not fed by an RDF curve) is held bit for
bit. The RDF curves are ``ops.rdf.rdf_from_exo`` (torch) against the JAX
package's (jnp), whose bin of a distance can move with one ulp of it: the
aggregate curves and the unrounded ``excess_rdf_cos`` are held at rtol 1e-5 /
atol 1e-6 of the curve's scale, as ``test_torch_evals.py`` holds RDF curves,
and the panel's and the ceiling's RDF-fed numbers, which both modules round
to 4 decimals, to one unit of that rounding (1e-4).
"""

import numpy as np
import pytest

from diffusion_model_tpu.evals import amorphous as jam
from diffusion_model_tpu_torch import evals
from diffusion_model_tpu_torch.data.synthetic import amorphous_network_cell
from diffusion_model_tpu_torch.evals import amorphous as tam

SIZES = (48, 56, 60, 64)
RDF_FED = ("aggregate_rdf_cos", "aggregate_rdf_cos_structureless_floor",
           "excess_rdf_cos", "excess_rdf_cos_structureless_floor")
ROUNDED = 1e-4


def stacks(seed=0):
    """(original pos, species, generated pos, generated species, mask):
    network cells, and a generated stack that moves every real atom and
    swaps a few species."""
    rng = np.random.default_rng(seed)
    g, n = len(SIZES), max(SIZES)
    pos = np.zeros((g, n, 3), np.float32)
    species = np.zeros((g, n, 2), np.float32)
    mask = np.zeros((g, n), np.float32)
    for i, size in enumerate(SIZES):
        cell = amorphous_network_cell(100 + seed + i, size)
        pos[i, :size], species[i, :size] = cell["pos"], cell["species"]
        mask[i, :size] = 1.0
    m3 = mask[..., None]
    gen = (pos + rng.normal(0, 0.15, pos.shape) * m3).astype(np.float32)
    gen_species = species.copy()
    for i, size in enumerate(SIZES):
        swap = rng.choice(np.arange(1, size), 3, replace=False)
        gen_species[i, swap] = gen_species[i, swap, ::-1]
    return pos, species, gen, gen_species, mask


def assert_rdf_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_the_package_exports_the_panel():
    for name in ("aggregate_exo_rdf", "bond_angle_samples",
                 "coordination_stats", "envelope_matched_cloud",
                 "excess_rdf_cos", "exo_rdf_resampling_ceiling",
                 "pair_distances", "radial_envelope", "structure_panel"):
        assert getattr(evals, name) is getattr(tam, name), name
        assert name in evals.__all__


@pytest.mark.parametrize("r_max", [None, 4.0])
def test_pair_distances_equal_jax(r_max):
    pos, _, gen, _, mask = stacks()
    for p_, m_ in zip(np.concatenate([pos, gen]), np.concatenate([mask,
                                                                  mask])):
        np.testing.assert_array_equal(tam.pair_distances(p_, m_, r_max),
                                      jam.pair_distances(p_, m_, r_max))


@pytest.mark.parametrize("cutoff", [2.0, 2.4])
def test_bonds_coordination_and_angles_equal_jax(cutoff):
    pos, species, gen, gen_species, mask = stacks(1)
    for p_, s_, m_ in zip(np.concatenate([pos, gen]),
                          np.concatenate([species, gen_species]),
                          np.concatenate([mask, mask])):
        is_o, nbrs = tam._bond_lists(p_, s_, m_, cutoff)
        want_o, want_nbrs = jam._bond_lists(p_, s_, m_, cutoff)
        np.testing.assert_array_equal(is_o, want_o)
        assert len(nbrs) == len(want_nbrs)
        for a, b in zip(nbrs, want_nbrs):
            np.testing.assert_array_equal(a, b)
        assert tam.coordination_stats(p_, s_, m_, cutoff) == \
            jam.coordination_stats(p_, s_, m_, cutoff)
        for a, b in zip(tam.bond_angle_samples(p_, s_, m_, cutoff),
                        jam.bond_angle_samples(p_, s_, m_, cutoff)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_radial_envelope_equals_jax():
    pos, _, gen, _, mask = stacks()
    for p in (pos, gen):
        assert tam.radial_envelope(p, mask) == jam.radial_envelope(p, mask)
        assert tam.radial_envelope(p, mask, (10, 90)) == \
            jam.radial_envelope(p, mask, (10, 90))


@pytest.mark.parametrize("seed", [0, 3])
def test_envelope_matched_cloud_draws_as_jax(seed):
    pos, _, _, _, mask = stacks()
    got = tam.envelope_matched_cloud(pos, mask, np.random.default_rng(seed))
    want = jam.envelope_matched_cloud(pos, mask, np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[mask == 0], pos[mask == 0])


@pytest.mark.parametrize("dr", [0.01, 0.02])
def test_aggregate_exo_rdf_matches_jax(dr):
    pos, _, gen, _, mask = stacks()
    for p in (pos, gen):
        got = tam.aggregate_exo_rdf(p, mask, dr=dr, device="cpu")
        want = np.asarray(jam.aggregate_exo_rdf(p, mask, dr=dr))
        assert got.shape == want.shape == (int(round(5.0 / dr)),)
        assert got.dtype == np.float32
        assert_rdf_close(got, want)


def test_highpass_equals_jax():
    v = np.random.default_rng(4).random(500).astype(np.float32)
    for sigma_bins in (50.0, 12.5):
        np.testing.assert_array_equal(tam._highpass(v, sigma_bins),
                                      jam._highpass(v, sigma_bins))


def test_excess_rdf_cos_matches_jax():
    pos, _, gen, _, mask = stacks(2)
    got = tam.excess_rdf_cos(pos, mask, gen, mask, device="cpu")
    want = jam.excess_rdf_cos(pos, mask, gen, mask)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # on the same curves, the readout is the JAX module's bit for bit
    a = jam.aggregate_exo_rdf(pos, mask)
    b = jam.aggregate_exo_rdf(gen, mask)
    assert tam.excess_rdf_cos(None, None, None, None, agg_a=a, agg_b=b) == \
        jam.excess_rdf_cos(None, None, None, None, agg_a=a, agg_b=b)


@pytest.mark.parametrize("seed", [0, 5])
def test_structure_panel_matches_jax(seed):
    pos, species, gen, gen_species, mask = stacks(seed)
    got = tam.structure_panel(pos, species, gen, gen_species, mask,
                              seed=seed, device="cpu")
    want = jam.structure_panel(pos, species, gen, gen_species, mask,
                               seed=seed)
    assert list(got) == list(want)
    for k, v in want.items():
        if k in RDF_FED:
            assert abs(got[k] - v) <= ROUNDED, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)
    # the generated stack is a perturbed original: its numbers are sane
    assert got["cn_si_mean_original"] > 3.0
    assert 140 < got["angle_siosi_mean_original"] < 155


def test_resampling_ceiling_matches_jax():
    def cell(s):
        return amorphous_network_cell(s, 48 + s % 3 * 8)

    got = tam.exo_rdf_resampling_ceiling(cell, num_cells=3, pairs=2,
                                         device="cpu")
    want = jam.exo_rdf_resampling_ceiling(cell, num_cells=3, pairs=2)
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("pairs", "num_cells"):
            assert got[k] == v
        else:
            assert abs(got[k] - v) <= ROUNDED, (k, got[k], v)
