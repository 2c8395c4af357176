"""The flagship denoiser in the port against ``DiffusionDenoiser.apply`` of
the JAX package (its XLA dense path), on the ``q_predef_r5.npz`` weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu_torch.api import denoiser_from_params
from diffusion_model_tpu_torch.config import from_dict
from torch_port_fixtures import (
    T_FRACS,
    flagship,
    flagship_conditions,
    noisy_inputs,
)

torch.set_num_threads(4)

NUM_CONDITIONS = 6


@pytest.fixture(scope="module")
def setup():
    from diffusion_model_tpu.diffusion.process import predefined_schedule

    jcfg, params = flagship()
    batch = jax_collate(flagship_conditions(jcfg)[:NUM_CONDITIONS], jcfg.n_max)
    alphas = np.asarray(predefined_schedule(jcfg).alphas)
    inputs = [noisy_inputs(alphas, np.asarray(batch.pos),
                           np.asarray(batch.species), np.asarray(batch.mask),
                           frac, seed=7 + k)
              for k, frac in enumerate(T_FRACS)]
    return jcfg, params, batch, inputs


def _run_both(setup, dtype_name):
    jcfg, params, batch, inputs = setup
    jcfg = jcfg.replace(compute_dtype=dtype_name)
    apply = jax.jit(JaxDenoiser(jcfg).apply)
    model = denoiser_from_params(from_dict(jcfg.to_dict()), params, "cpu")
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    for species_t, pos_t, t_norm in inputs:
        want = apply(params["denoiser"], jnp.asarray(species_t),
                     jnp.asarray(pos_t), batch.spectrum, batch.exo,
                     jnp.asarray(t_norm), batch.mask, batch.pair_mask())
        got = model(t(species_t), t(pos_t), t(batch.spectrum), t(batch.exo),
                    t(t_norm), t(batch.mask))
        yield ([np.asarray(w, np.float32) for w in want],
               [g.float().numpy() for g in got], np.asarray(batch.mask))


def test_float32_matches_jax(setup):
    for want, got, _ in _run_both(setup, "float32"):
        scale = max(np.abs(w).max() for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5 * scale)


def test_bfloat16_matches_jax_in_relative_l2(setup):
    for want, got, _ in _run_both(setup, "bfloat16"):
        for g, w in zip(got, want):
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2e-2


def test_outputs_masked_and_com_free(setup):
    for _, (eps_x, eps_h), mask in _run_both(setup, "float32"):
        assert np.all(eps_x[mask == 0] == 0) and np.all(eps_h[mask == 0] == 0)
        com = eps_x.sum(axis=1) / mask.sum(axis=1, keepdims=True)
        assert np.abs(com).max() < 1e-5
