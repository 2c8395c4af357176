"""The port's forward process and training loss (``diffusion.process.
diffuse_zero_to_t``, ``train.loss``, ``Trainer._gamma_boundary``) against
the JAX package, on the same batches with the JAX package's draws replayed
through the port's noise source."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.split import batch_iterator
from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.diffusion import process as jax_process
from diffusion_model_tpu.nn.gamma import GammaNetwork as JaxGamma
from diffusion_model_tpu.train import loss as jax_loss
from diffusion_model_tpu.train.trainer import Trainer as JaxTrainer
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.diffusion import process
from diffusion_model_tpu_torch.nn.gamma import GammaNetwork
from diffusion_model_tpu_torch.train import loss
from diffusion_model_tpu_torch.train.checkpoint import (
    gamma_state_dict_from_flax,
)
from diffusion_model_tpu_torch.train.trainer import Trainer
from torch_port_fixtures import (
    ReplayDraws,
    flat_leaves,
    jax_loss_draws,
    port_batch,
)

torch.set_num_threads(4)

BASE = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=50, batch_size=4, lr=1e-3)


def cfgs(**kw):
    d = {**BASE, **kw}
    return JaxConfig(**d), Config(**d)


def jax_batch(jcfg, seed=0):
    data = synthetic_sio2_dataset(seed, 6, jcfg.n_max,
                                  spectrum_size=jcfg.spectrum_size)
    return next(batch_iterator(data, jcfg.batch_size, jcfg.n_max, seed=1))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["pos", "h"])
def test_diffuse_zero_to_t_per_graph(mode):
    jcfg, cfg = cfgs()
    jb = jax_batch(jcfg)
    b = port_batch(jb)
    z = b.pos if mode == "pos" else b.species
    t = np.array([1, 17, 50, 33], np.int32)
    key = jax.random.key(3)
    want_z, want_eps = jax_process.diffuse_zero_to_t(
        jax_process.predefined_schedule(jcfg), key, jnp.asarray(z.numpy()),
        jnp.asarray(t), mode=mode, mask=jb.mask)
    raw = np.asarray(jax.random.normal(key, z.shape))
    got_z, got_eps = process.diffuse_zero_to_t(
        process.predefined_schedule(cfg), torch.from_numpy(raw), z,
        torch.from_numpy(t).long(), mode=mode, mask=b.mask)
    close(got_z, want_z)
    close(got_eps, want_eps)


@pytest.mark.parametrize("kw", [dict(), dict(t_bias_frac=0.5, t_bias_lo=10,
                                              t_bias_hi=40),
                                dict(diffuse_species=False)])
def test_diffuse_batch_on_replayed_draws(kw):
    jcfg, cfg = cfgs(**kw)
    jb = jax_batch(jcfg)
    key = jax.random.key(7)
    # Trainer._loss hands diffuse_batch the first of three keys
    k_diff = jax.random.split(key, 3)[0]
    want = jax_loss.diffuse_batch(jax_process.predefined_schedule(jcfg),
                                  jcfg, k_diff, jb)
    noise = ReplayDraws(jax_loss_draws(key, jcfg, 4, jcfg.n_max))
    got = loss.diffuse_batch(process.predefined_schedule(cfg), cfg, noise,
                             port_batch(jb))
    for g, w in zip(got, want):
        close(g, w)
    if kw.get("t_bias_frac"):
        t = got[2].numpy()
        assert ((t >= 10) & (t <= 40)).any()


def test_t_bias_band_is_validated():
    _, cfg = cfgs(t_bias_frac=0.5)      # band 100..600 outside T=50
    with pytest.raises(ValueError, match="t_bias band"):
        loss.diffuse_batch(process.predefined_schedule(cfg), cfg,
                           loss.TrainNoise(0, "cpu"),
                           port_batch(jax_batch(cfgs()[0])))


@pytest.mark.parametrize("weight", [1.0, 3.0, 0.5])
def test_t_band_weights(weight):
    jcfg, cfg = cfgs(t_loss_weight=weight, t_bias_lo=10, t_bias_hi=30)
    t = np.array([1, 10, 20, 30, 31, 50], np.int32)
    want = jax_loss.t_band_weights(jcfg, jnp.asarray(t))
    got = loss.t_band_weights(cfg, torch.from_numpy(t).long())
    if weight == 1.0:
        assert got is None and want is None
    else:
        close(got, want)


@pytest.mark.parametrize("include_h,weighted", [(True, False), (False, False),
                                                (True, True)])
def test_epsilon_loss(include_h, weighted):
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((4, 8, 3), (4, 8, 2), (4, 8, 3), (4, 8, 2))]
    mask = np.ones((4, 8), np.float32)
    mask[1, 5:] = 0
    mask[3] = 0                                 # a padded batch row
    w = np.array([0.5, 1.0, 2.0, 1.5], np.float32) if weighted else None
    want = jax_loss.epsilon_loss(*map(jnp.asarray, arrays), jnp.asarray(mask),
                                 include_h=include_h,
                                 weights=None if w is None else jnp.asarray(w))
    got = loss.epsilon_loss(*map(torch.from_numpy, arrays),
                            torch.from_numpy(mask), include_h=include_h,
                            weights=None if w is None
                            else torch.from_numpy(w))
    for g, wv in zip(got, want):
        close(g, wv)


def test_gamma_boundary_and_its_gamma_gradients():
    jcfg, cfg = cfgs(noise_schedule="learned")
    jb = jax_batch(jcfg)
    gamma_params = JaxGamma().init(jax.random.key(11), jnp.zeros((1, 1)))
    jt = JaxTrainer(jcfg)

    def boundary(gp):
        schedule = jax_process.learned_schedule(
            jt.gamma.apply, gp, jcfg.num_diffusion_timestep)
        return jt._gamma_boundary(schedule, jb)

    want, want_grads = jax.value_and_grad(boundary)(gamma_params)
    gamma = GammaNetwork()
    gamma.load_state_dict(gamma_state_dict_from_flax(
        {"gamma": gamma_params}))
    trainer = Trainer(cfg, device="cpu")
    got = trainer._gamma_boundary(
        process.learned_schedule(gamma, cfg.num_diffusion_timestep),
        port_batch(jb))
    got.backward()
    close(got, want)
    for name, w in flat_leaves(want_grads["params"]).items():
        g = dict(gamma.named_parameters())[name.replace("/", ".")].grad
        # the hinged prior term holds gamma_1 still at these endpoints
        assert (float(g.abs().max()) > 0) == bool(np.abs(w).max() > 0), name
        close(g, w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()))


def test_learned_schedule_keeps_its_graph():
    gamma = GammaNetwork()
    alphas = process.learned_schedule(gamma, 50).alphas
    assert alphas.requires_grad
    with torch.no_grad():
        assert not process.learned_schedule(gamma, 50).alphas.requires_grad
