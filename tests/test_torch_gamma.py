"""The learned noise schedule of the port against the JAX package's, from
the gamma network of ``artifacts/q_learned_r5_s2025.npz``, and a chain
sampled with it.

Tolerances: ``gamma_tilde`` rtol 1e-6; gamma rtol 1e-5 of the table's
scale, max |gamma|, and alphas atol 5e-6. The table's float32 floor sets
the last two: the sum over the 1024 hidden units runs in another order,
and XLA's sigmoid and softplus differ from PyTorch's in the last place, so
``gamma_tilde`` (24.8 to 34.2) differs by an ulp or two, 3.8e-6 each; the
normalisation over g1 - g0 = 9.4 multiplies that by 3.6 into gamma (2.1e-5
measured, where gamma crosses zero near t = 0.05 no elementwise relative
tolerance holds) and by up to 0.2 more into alpha (3.6e-6 measured, near
alpha 0.7). The chain as in
``test_torch_sampler.py`` (species exactly, positions and trajectory
frames rtol 1e-3 / atol 1e-2 A).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.diffusion import sampler as js
from diffusion_model_tpu.diffusion.process import (
    learned_schedule as jax_learned_schedule,
)
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.nn.gamma import GammaNetwork as JaxGamma
from diffusion_model_tpu.train import checkpoint as jax_ckpt
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion import sampler as ts
from diffusion_model_tpu_torch.diffusion.process import (
    final_denoise_step,
    learned_schedule,
    predefined_schedule,
    reverse_diffuse_one_step,
)
from diffusion_model_tpu_torch.evals.restore_check import held_out_conditions
from diffusion_model_tpu_torch.nn.gamma import GammaNetwork
from diffusion_model_tpu_torch.ops.com import remove_mean
from diffusion_model_tpu_torch.train import checkpoint as port_ckpt
from torch_port_fixtures import SNAPSHOT, Replay, jax_sample_draws

torch.set_num_threads(4)

LEARNED = SNAPSHOT.parent / "q_learned_r5_s2025.npz"
STEPS = 10
COPIES = 2
EVERY = 2
POS_TOL = dict(rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def learned():
    jcfg = jax_ckpt.load_config_npz(str(LEARNED))
    params = jax_ckpt.load_params_npz(str(LEARNED))
    return jcfg, params


def port_gamma(params, device="cpu"):
    """The snapshot's gamma network, frozen as ``api.schedule_for`` serves
    it (a trainable one keeps its table's graph)."""
    gamma = GammaNetwork(device=device).requires_grad_(False)
    gamma.load_state_dict(port_ckpt.gamma_state_dict_from_flax(params))
    return gamma


@pytest.mark.parametrize("steps", [1000, 250, 7])
def test_gamma_table_and_alphas_match_jax(learned, steps):
    _, params = learned
    net = JaxGamma()
    t = jnp.linspace(0.0, 1.0, steps + 1)[:, None]
    want_gamma = np.asarray(net.apply(params["gamma"], t))
    want = np.asarray(jax_learned_schedule(net.apply, params["gamma"],
                                           steps).alphas)
    gamma = port_gamma(params)
    with torch.no_grad():
        got_gamma = gamma(torch.from_numpy(np.array(t))).numpy()
    np.testing.assert_allclose(got_gamma, want_gamma, rtol=1e-5,
                               atol=1e-5 * np.abs(want_gamma).max())
    got = learned_schedule(gamma, steps)
    assert got.alphas.dtype == torch.float32 and got.num_timesteps == steps
    np.testing.assert_allclose(got.alphas.numpy(), want, rtol=0, atol=5e-6)
    # the stored endpoints, unscaled: gamma_0 = -0.3684 x 25
    assert abs(float(got_gamma[0, 0]) + 9.21) < 0.01


def test_gamma_tilde_matches_jax(learned):
    _, params = learned
    t = np.linspace(0.0, 1.0, 33, dtype=np.float32)[:, None]
    want = np.asarray(JaxGamma().apply(params["gamma"], jnp.asarray(t),
                                       method=JaxGamma.gamma_tilde))
    with torch.no_grad():
        got = port_gamma(params).gamma_tilde(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_for_picks_the_table_from_the_config(learned):
    jcfg, params = learned
    cfg = from_dict(jcfg.to_dict())
    got = api.schedule_for(cfg, params, "cpu").alphas
    want = learned_schedule(port_gamma(params), cfg.num_diffusion_timestep)
    assert torch.equal(got, want.alphas)
    poly = cfg.replace(noise_schedule="predefined")
    assert torch.equal(api.schedule_for(poly, params, "cpu").alphas,
                       predefined_schedule(poly).alphas)
    assert not torch.allclose(got, predefined_schedule(poly).alphas,
                              atol=1e-3)
    with pytest.raises(ValueError, match="gamma"):
        api.schedule_for(cfg, {"denoiser": params["denoiser"]}, "cpu")


def test_a_learned_model_without_its_schedule_is_refused(learned):
    jcfg, params = learned
    cfg = from_dict(jcfg.to_dict())
    model = api.denoiser_from_params(cfg, params, "cpu")
    graphs = held_out_conditions(cfg)[:1]
    with pytest.raises(ValueError, match="noise_schedule"):
        api.generate(cfg, model, graphs, gen_num_per_spectrum=1,
                     batch_size=1)


@pytest.fixture(scope="module")
def learned_f32(learned):
    jcfg, params = learned
    jcfg = jcfg.replace(compute_dtype="float32", sample_steps=STEPS,
                        sample_grid="snr")
    graphs = held_out_conditions(from_dict(jcfg.to_dict()))[:2]
    return jcfg, params, graphs


@pytest.mark.parametrize("variant", [dict(),
                                     dict(deterministic_sampling=True)])
def test_learned_chain_matches_jax(learned_f32, variant):
    """Step by step: every reverse step of the port, taken from JAX's state
    entering that step (JAX's trajectory at ``snapshot_every`` 1) with the
    same draws, lands within POS_TOL of JAX's next state, and so does the
    epilogue. The chain run free is chaotic in both packages: over its last
    six steps a difference grows ~5x a step, and JAX's own chain moves
    further (0.095 A, ``test_torch_restore_check.py``) when its denoiser's
    output is perturbed by 1e-6 relative than the port's run free ends from
    it (0.020 A); so the free run is held to species, acceptance and the
    trajectory's frames (``snapshot_every`` 2): shapes, count and the
    pure-noise frame 0."""
    jcfg, params, graphs = learned_f32
    jcfg = jcfg.replace(snapshot_every=1, **variant)
    cfg = from_dict(jcfg.to_dict())
    stochastic = not cfg.deterministic_sampling
    key = jax.random.key(31)

    net = JaxGamma()
    jschedule = jax_learned_schedule(net.apply, params["gamma"],
                                     jcfg.num_diffusion_timestep)
    jmodel = JaxDenoiser(jcfg)
    jcond = js.tile_batch(jax_collate(graphs, jcfg.n_max), COPIES)
    denoise = lambda *a: jmodel.apply(params["denoiser"], *a)
    want = jax.jit(lambda k, c: js.sample(denoise, jschedule, jcfg, k, c,
                                          return_trajectory=True))(key, jcond)
    assert bool(np.all(want.accepted)), "a chain that fails proves nothing"
    states = [torch.from_numpy(np.array(a)) for a in want.trajectory]

    b, n = jcond.mask.shape
    draws = jax_sample_draws(key, b, n, cfg.atom_type_size, STEPS,
                             stochastic)
    model = api.denoiser_from_params(cfg, params, "cpu")
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    schedule = api.schedule_for(cfg, params, "cpu")

    free_cfg = cfg.replace(snapshot_every=EVERY)
    noise = Replay(draws)
    got = ts.sample(model, schedule, free_cfg, None, cond, noise,
                    return_trajectory=True)
    assert not noise.draws, "the port drew fewer numbers than JAX"
    np.testing.assert_array_equal(got.species.numpy(),
                                  np.asarray(want.species))
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    for frames, width in zip(got.trajectory, (3, cfg.atom_type_size)):
        assert tuple(frames.shape) == (STEPS // EVERY, b, n, width)
    for g, w in zip(got.trajectory, states):
        np.testing.assert_allclose(g[0].numpy(), w[0].numpy(), atol=1e-6)
    np.testing.assert_array_equal(
        got.trajectory[0][0].numpy(),
        remove_mean(torch.from_numpy(np.array(draws[0])), cond.mask).numpy())

    grid, t_norm, _ = ts._strided(schedule, cfg)
    m3 = cond.mask.unsqueeze(-1)
    kw = dict(mask=cond.mask, deterministic=cfg.deterministic_sampling,
              noise_scale=cfg.sample_noise_scale)
    step_draws = iter(draws[2:])

    def step(pos, h, t, last):
        eps_x, eps_h = model(h, pos, cond.spectrum, cond.exo,
                             m3 * t_norm[t], cond.mask)
        dx, dh = ((torch.from_numpy(np.array(next(step_draws))),
                   torch.from_numpy(np.array(next(step_draws))))
                  if stochastic else (None, None))
        if last:
            return (final_denoise_step(grid, dx, pos, eps_x, "pos", **kw),
                    final_denoise_step(grid, dh, h, eps_h, "h", **kw))
        return (reverse_diffuse_one_step(grid, dx, pos, eps_x, t, "pos",
                                         **kw),
                reverse_diffuse_one_step(grid, dh, h, eps_h, t, "h", **kw))

    assert cfg.onehot_scaling_factor == 1.0
    for k in range(STEPS):
        pos, h = step(states[0][k], states[1][k], STEPS - k, last=False)
        if k + 1 < STEPS:
            want_pos, want_h = states[0][k + 1], states[1][k + 1]
        else:   # the last step and the epilogue: JAX keeps no state between
            pos, h = step(pos, h, 0, last=True)
            want_pos, want_h = (torch.from_numpy(np.array(a)) for a in
                                (want.pos, want.h))
        np.testing.assert_allclose(pos.numpy(), want_pos.numpy(), **POS_TOL,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(h.numpy(), want_h.numpy(), **POS_TOL,
                                   err_msg=f"step {k}")
