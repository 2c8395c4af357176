"""The port's host evaluators (``evals/fingerprint.py``, ``baseline.py``,
``soap.py``, ``template.py``) against the JAX package's, on the CPU.

``fingerprint``, ``baseline`` and ``soap`` are numpy (and scipy) on both
sides and held bit for bit. ``template.local_descriptor`` is jnp in the JAX
package and torch in the port: the descriptors agree to 1e-5 of their
largest entry except where an angle lies on a histogram bin's edge to float32
rounding (none does here), and ``template_match`` gives the same rankings
(spectrum MSE, computed on the host by both) with similarities to 1e-5.
"""

import numpy as np
import pytest
import torch

from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.evals import baseline as jax_baseline
from diffusion_model_tpu.evals import fingerprint as jax_fingerprint
from diffusion_model_tpu.evals import soap as jax_soap
from diffusion_model_tpu.evals import template as jax_template
from diffusion_model_tpu_torch.evals import (
    baseline,
    fingerprint,
    soap,
    template,
)

torch.set_num_threads(4)

SYMBOLS = {0: "O", 1: "Si"}


def structures(count: int = 6, n_max: int = 16, shells: int = 2) -> list:
    return synthetic_sio2_dataset(3, count, n_max, spectrum_size=24,
                                  shells=shells)


def symbols(g: dict) -> list:
    return [SYMBOLS[int(i)] for i in np.argmax(g["species"], axis=-1)]


@pytest.mark.parametrize("method", ["atom_pair", "morgan"])
def test_fingerprints_match_jax(method):
    gs = structures()
    for a in gs[:3]:
        assert (fingerprint.atom_pair_fingerprint(a["pos"], symbols(a))
                == jax_fingerprint.atom_pair_fingerprint(a["pos"],
                                                         symbols(a)))
        assert (fingerprint.morgan_fingerprint(a["pos"], symbols(a))
                == jax_fingerprint.morgan_fingerprint(a["pos"], symbols(a)))
        for b in gs[3:]:
            assert fingerprint.fingerprint_similarity(
                a["pos"], symbols(a), b["pos"], symbols(b),
                method=method) == jax_fingerprint.fingerprint_similarity(
                a["pos"], symbols(a), b["pos"], symbols(b), method=method)
    np.testing.assert_array_equal(
        fingerprint.guess_bonds(gs[0]["pos"], symbols(gs[0])),
        jax_fingerprint.guess_bonds(gs[0]["pos"], symbols(gs[0])))
    assert fingerprint.COVALENT_RADII == jax_fingerprint.COVALENT_RADII
    with pytest.raises(ValueError, match="fingerprint method"):
        fingerprint.fingerprint_similarity(gs[0]["pos"], symbols(gs[0]),
                                           gs[0]["pos"], symbols(gs[0]),
                                           method="x")


@pytest.mark.parametrize("dims", [1, 2])
def test_nn_baseline_matches_jax(dims):
    rng = np.random.default_rng(dims)
    tr, te = rng.random((30, 12)), rng.random((10, 12))
    shape = (30,) if dims == 1 else (30, dims)
    values = rng.normal(size=shape)
    test_values = rng.normal(size=(10,) + shape[1:])
    np.testing.assert_array_equal(
        baseline.spectrum_nn_predict(tr, values, te),
        jax_baseline.spectrum_nn_predict(tr, values, te))
    assert (baseline.nn_ceiling_r2(tr, values, te, test_values)
            == jax_baseline.nn_ceiling_r2(tr, values, te, test_values))


@pytest.mark.parametrize("settings", [dict(n_max=4, l_max=3),
                                      dict(n_max=6, l_max=4, r_cut=5.0,
                                           sigma=0.3, n_quad=512)])
def test_soap_matches_jax_bit_for_bit(settings):
    for g in structures(3):
        mask = np.ones(len(g["pos"]))
        mask[-1] = 0
        for m in (None, mask):
            np.testing.assert_array_equal(
                soap.soap_descriptor(g["pos"], g["species"], mask=m,
                                     **settings),
                jax_soap.soap_descriptor(g["pos"], g["species"], mask=m,
                                         **settings))


def test_soap_at_the_reference_settings_matches_jax():
    g = structures(1)[0]
    got = soap.soap_descriptor(g["pos"], g["species"])
    assert got.shape == (5115,)
    np.testing.assert_array_equal(
        got, jax_soap.soap_descriptor(g["pos"], g["species"]))


def test_local_descriptor_matches_jax():
    import jax.numpy as jnp

    for g in structures(2, shells=3):
        pos, species = g["pos"], g["species"]
        mask = np.ones(len(pos), np.float32)
        mask[-2:] = 0
        for m in (None, mask):
            want = np.asarray(jax_template.local_descriptor(
                jnp.asarray(pos), jnp.asarray(species),
                None if m is None else jnp.asarray(m)))
            got = template.local_descriptor(
                torch.from_numpy(pos), torch.from_numpy(species),
                None if m is None else torch.from_numpy(m)).numpy()
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            # the angle histogram counts pairs: equal counts
            np.testing.assert_array_equal(got[64:], want[64:])


@pytest.mark.parametrize("descriptor", ["histogram", "soap"])
def test_template_match_matches_jax(descriptor):
    gs = structures(8, shells=3)
    targets, refs = gs[:3], gs
    got = template.template_match(targets, refs, descriptor=descriptor,
                                  device="cpu")
    want = jax_template.template_match(targets, refs, descriptor=descriptor)
    assert list(got) == list(want)
    for tid in want:
        assert [list(d) for d in got[tid]] == [list(d) for d in want[tid]]
        for g, w in zip(got[tid], want[tid]):
            (rid, (mse, sim)), = g.items()
            (_, (w_mse, w_sim)), = w.items()
            assert mse == w_mse
            if descriptor == "soap":
                assert sim == w_sim
            else:
                np.testing.assert_allclose(sim, w_sim, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="descriptor"):
        template.template_match(targets, refs, descriptor="x", device="cpu")
