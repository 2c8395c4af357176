"""Whole reverse chains of the port against ``diffusion_model_tpu``'s sampler.

JAX's threefry and torch's Philox never give the same numbers, so the
port's sampler is handed the draws JAX makes from its key splits
(``torch_port_fixtures.jax_sample_draws``). The flagship runs in float32 on
both sides over 10 strided steps on the snr grid (the uniform 10-step grid
jumps from t=1000 to t=900, alpha 1e-5 to 0.036, and the flagship's chain
is NaN on both sides there) and over 100 uniform steps.

Tolerance: species exactly, positions rtol 1e-3 / atol 1e-2 (A). The
trained chain amplifies the two frameworks' float32 rounding (about 1e-6
relative per denoiser call) step by step: on the 10-step snr chain the
difference grows from 1.5e-5 after the first step to 6.2e-3 at the end,
and it is 6.0e-3 to 7.4e-3 for every grid and length tried, so the
1e-4 atol of a single step cannot hold over a chain.
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.diffusion import sampler as js
from diffusion_model_tpu.diffusion.process import (
    predefined_schedule as jax_schedule,
)
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu_torch.api import denoiser_from_params
from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion import sampler as ts
from diffusion_model_tpu_torch.diffusion.process import predefined_schedule
from torch_port_fixtures import (
    Replay,
    flagship,
    flagship_conditions,
    jax_sample_draws,
)

torch.set_num_threads(4)

STEPS = 10
COPIES = 2
POS_TOL = dict(rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def flagship_f32():
    jcfg, params = flagship()
    jcfg = jcfg.replace(compute_dtype="float32", sample_steps=STEPS,
                        sample_grid="snr")
    graphs = flagship_conditions(jcfg)[:2]
    return jcfg, params, graphs


@pytest.mark.parametrize("variant", [
    dict(deterministic_sampling=True),
    dict(),
    dict(sample_noise_scale=0.5),
    dict(deterministic_sampling=True, sample_grid="uniform", sample_steps=100),
])
def test_chain_matches_jax(flagship_f32, variant):
    jcfg, params, graphs = flagship_f32
    jcfg = jcfg.replace(**variant)
    steps = jcfg.sample_steps
    cfg = from_dict(jcfg.to_dict())
    key = jax.random.key(17)

    jmodel = JaxDenoiser(jcfg)
    jcond = js.tile_batch(jax_collate(graphs, jcfg.n_max), COPIES)
    denoise = lambda *a: jmodel.apply(params["denoiser"], *a)
    want = jax.jit(lambda k, c: js.sample(denoise, jax_schedule(jcfg), jcfg,
                                          k, c))(key, jcond)
    assert bool(np.all(want.accepted)), "a chain that fails proves nothing"

    b, n = jcond.mask.shape
    stochastic = not cfg.deterministic_sampling
    draws = jax_sample_draws(key, b, n, cfg.atom_type_size, steps,
                             stochastic)
    noise = Replay(draws)
    model = denoiser_from_params(cfg, params, "cpu")
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    got = ts.sample(model, predefined_schedule(cfg), cfg, None, cond, noise)
    assert not noise.draws, "the port drew fewer numbers than JAX"

    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **POS_TOL)
    np.testing.assert_array_equal(got.species.numpy(),
                                  np.asarray(want.species))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **POS_TOL)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    np.testing.assert_array_equal(got.finite.numpy(), np.asarray(want.finite))


@pytest.mark.parametrize("deterministic", [True, False])
def test_guidance_matches_jax(flagship_f32, deterministic):
    """Classifier-free guidance, with the same closed-form stand-in for the
    denoiser on both sides (the flagship was trained without condition
    dropout, so its unconditional branch is off its training data)."""
    import jax.numpy as jnp

    jcfg, _, graphs = flagship_f32
    jcfg = jcfg.replace(guidance_scale=0.5,
                        deterministic_sampling=deterministic)
    cfg = from_dict(jcfg.to_dict())

    def stand_in(lib):
        def denoise(species, pos, spectrum, exo, t_norm, mask, *_):
            m3 = mask[..., None]
            cond = spectrum.mean(-1, keepdims=True) if lib is jnp else \
                spectrum.mean(-1, keepdim=True)
            return ((0.9 * pos + 0.3 * cond + 0.1 * t_norm) * m3,
                    (0.8 * species - 0.2 * exo) * m3)
        return denoise

    key = jax.random.key(5)
    jcond = js.tile_batch(jax_collate(graphs, jcfg.n_max), COPIES)
    want = js.sample(stand_in(jnp), jax_schedule(jcfg), jcfg, key, jcond)
    b, n = jcond.mask.shape
    noise = Replay(jax_sample_draws(key, b, n, cfg.atom_type_size, STEPS,
                                    not deterministic))
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    got = ts.sample(stand_in(torch), predefined_schedule(cfg), cfg, None,
                    cond, noise)
    assert bool(np.all(want.accepted))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **POS_TOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **POS_TOL)


@pytest.mark.parametrize("steps", [1, 10, 100, 250, 999])
def test_snr_grid_matches_jax(steps):
    cfg = Config()
    want = js.snr_grid(jax_schedule(cfg).alphas, steps)
    got = ts.snr_grid(predefined_schedule(cfg).alphas, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tile_batch_matches_jax(flagship_f32):
    jcfg, _, graphs = flagship_f32
    want = js.tile_batch(jax_collate(graphs, jcfg.n_max), 3)
    got = ts.tile_batch(collate(graphs, jcfg.n_max, "cpu"), 3)
    for field in ("pos", "species", "spectrum", "exo", "mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


def test_too_many_steps_refused(flagship_f32):
    jcfg, params, graphs = flagship_f32
    cfg = from_dict(jcfg.to_dict()).replace(sample_steps=1001)
    cond = collate(graphs, cfg.n_max, "cpu")
    with pytest.raises(ValueError, match="sample_steps"):
        ts.sample(lambda *a: None, predefined_schedule(cfg), cfg, None, cond)


def test_retry_keeps_accepted_and_redraws_rejected(flagship_f32):
    jcfg, params, graphs = flagship_f32
    cfg = from_dict(jcfg.to_dict())
    model = denoiser_from_params(cfg, params, "cpu")
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    schedule = predefined_schedule(cfg)
    calls_per_chain = STEPS + 1
    calls = [0]

    def poisoned(*args):
        eps_x, eps_h = model(*args)
        if calls[0] < calls_per_chain:   # the first chain only
            eps_x[1] = float("nan")
        calls[0] += 1
        return eps_x, eps_h

    gen = torch.Generator().manual_seed(3)
    first = ts.sample(model, schedule, cfg, gen, cond)
    second = ts.sample(model, schedule, cfg, gen, cond)
    assert bool(first.accepted.all()) and bool(second.accepted.all())

    got = ts.sample_with_retry(poisoned, schedule, cfg,
                               torch.Generator().manual_seed(3), cond)
    assert calls[0] == 2 * calls_per_chain
    assert bool(got.accepted.all()) and bool(got.finite.all())
    keep = torch.tensor([True, False, True, True])
    for field in ("pos", "species", "h"):
        assert torch.equal(getattr(got, field)[keep],
                           getattr(first, field)[keep])
        assert torch.equal(getattr(got, field)[1], getattr(second, field)[1])
