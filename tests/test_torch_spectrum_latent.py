"""The spectrum-latent conditioning path (``nn.spectrum_latent``, the
``spectrum_to_latent`` config) against the JAX package's: the encoder and
decoder forward, ``pretrain_autoencoder`` from JAX's initialisation,
``encode_dataset``, the node width of a latent config, and one
latent-conditioned train step's loss and gradients on JAX's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.nn import spectrum_latent as jax_latent
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.nn import spectrum_latent
from diffusion_model_tpu_torch.train.trainer import Trainer
from test_torch_trainer import (
    assert_leaves_close,
    jax_step,
    np_tree,
    port_names,
)
from torch_port_fixtures import ReplayDraws, jax_loss_draws, port_batch

torch.set_num_threads(4)

S, LATENT = 40, 8


def jax_init(spectra, latent_dim=LATENT, seed=0):
    """The initial (encoder, decoder) flax trees of JAX's
    ``pretrain_autoencoder(seed=seed)``."""
    x = jnp.asarray(spectra, jnp.float32)
    k1, k2 = jax.random.split(jax.random.key(seed))
    enc = jax_latent.SpectrumEncoder(latent_dim=latent_dim)
    dec = jax_latent.SpectrumDecoder(spectrum_dim=x.shape[-1])
    return (np_tree(enc.init(k1, x[:1])),
            np_tree(dec.init(k2, jnp.zeros((1, latent_dim)))))


def spectra(num=32, seed=3):
    return np.random.default_rng(seed).random((num, S)).astype(np.float32)


def test_encoder_and_decoder_forward_match_flax():
    x = spectra()
    enc_p, dec_p = jax_init(x)
    enc = spectrum_latent.SpectrumEncoder(S, LATENT, device="cpu")
    dec = spectrum_latent.SpectrumDecoder(LATENT, S, device="cpu")
    enc.load_flax(enc_p)
    dec.load_flax(dec_p)
    z = jax_latent.SpectrumEncoder(latent_dim=LATENT).apply(enc_p, x)
    rec = jax_latent.SpectrumDecoder(spectrum_dim=S).apply(dec_p, z)
    with torch.no_grad():
        got_z = enc(torch.from_numpy(x))
        got_rec = dec(torch.from_numpy(np.array(z)))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(z), atol=1e-5)
    np.testing.assert_allclose(got_rec.numpy(), np.asarray(rec), atol=1e-5)
    assert [n for n, _ in enc.named_children()] == ["enc0", "enc1", "enc_out"]
    assert [n for n, _ in dec.named_children()] == ["dec0", "dec1", "dec_out"]
    for want, got in ((enc_p, enc), (dec_p, dec)):
        for name, leaves in want["params"].items():
            layer = getattr(got, name)
            np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                          leaves["kernel"])
            np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                          leaves["bias"])


def test_pretrain_from_jax_init_matches_jax():
    """50 full-batch Adam steps from JAX's initialisation: the final MSE
    (the last step's, before its update) at rtol 1e-4, and the trained
    encoder close to JAX's."""
    x = spectra()
    _, enc_p, _, _, mse = jax_latent.pretrain_autoencoder(
        x, latent_dim=LATENT, steps=50, seed=0)
    enc, dec, got = spectrum_latent.pretrain_autoencoder(
        x, latent_dim=LATENT, steps=50, device="cpu", init=jax_init(x))
    np.testing.assert_allclose(got, mse, rtol=1e-4)
    assert got < float(np.var(x))   # beats predicting the mean
    for name, want in np_tree(enc_p)["params"].items():
        np.testing.assert_allclose(
            getattr(enc, name).weight.detach().numpy().T, want["kernel"],
            rtol=1e-3, atol=1e-5, err_msg=name)


def test_pretrain_draws_its_own_init_from_the_seed():
    x = spectra()
    a = spectrum_latent.pretrain_autoencoder(x, LATENT, steps=3, seed=1,
                                             device="cpu")
    b = spectrum_latent.pretrain_autoencoder(x, LATENT, steps=3, seed=1,
                                             device="cpu")
    assert a[2] == b[2] and np.isfinite(a[2])


def test_encode_dataset_matches_jax():
    graphs = synthetic_sio2_dataset(0, 6, 8, spectrum_size=S)
    x = np.stack([g["spectrum"][0] for g in graphs])
    enc_p, _ = jax_init(x)
    want = jax_latent.encode_dataset(
        graphs, jax_latent.SpectrumEncoder(latent_dim=LATENT), enc_p)
    enc = spectrum_latent.SpectrumEncoder(S, LATENT, device="cpu")
    got = spectrum_latent.encode_dataset(graphs, enc.load_flax(enc_p))
    assert len(got) == len(want)
    for g, w, src in zip(got, want, graphs):
        assert g["spectrum"].shape == w["spectrum"].shape == (
            src["pos"].shape[0], LATENT)
        np.testing.assert_allclose(g["spectrum"], w["spectrum"], atol=1e-5)
        assert not g["spectrum"][1:].any()
        np.testing.assert_array_equal(g["pos"], src["pos"])


def test_latent_config_widths_and_refusal():
    kw = dict(spectrum_to_latent=True, to_compress_spectrum=False,
              latent_dim=LATENT, spectrum_size=S)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    assert cfg.cond_spectrum_size == jcfg.cond_spectrum_size == LATENT
    assert cfg.h_size == jcfg.h_size
    assert cfg.spectrum_input_size == LATENT
    both = dict(kw, to_compress_spectrum=True)
    with pytest.raises(AssertionError):
        JaxConfig(**both).h_size
    with pytest.raises(ValueError, match="to_compress_spectrum"):
        Config(**both).h_size


def test_latent_conditioned_train_step_matches_jax():
    """One train step of a latent-conditioned model (the node features
    carry the latent on node 0), from JAX's init on JAX's draws: loss and
    ``sum_sq`` at rtol 1e-5, every gradient leaf at 5e-3."""
    d = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
             x_hidden_size=32, m_size=16, spectrum_size=S,
             num_diffusion_timestep=50, batch_size=4, lr=1e-3,
             optimizer="Adam", spectrum_to_latent=True,
             to_compress_spectrum=False, latent_dim=LATENT)
    jcfg, cfg = JaxConfig(**d), Config(**d)
    graphs = synthetic_sio2_dataset(0, 8, 8, spectrum_size=S)
    x = np.stack([g["spectrum"][0] for g in graphs])
    enc_p, _ = jax_init(x)
    encoded = jax_latent.encode_dataset(
        graphs, jax_latent.SpectrumEncoder(latent_dim=LATENT), enc_p)
    jb = next(jax_split.batch_iterator(encoded, 4, 8, seed=1))
    assert jb.spectrum.shape[-1] == LATENT
    key = jax.random.key(5)
    params, loss, sum_sq, grads, _ = jax_step(jcfg, jb, key)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=np_tree(params))
    assert trainer.model.spectrum_compressor is None
    got_loss, got_sq, _, got_grads = trainer.loss_and_grads(
        state, ReplayDraws(jax_loss_draws(key, jcfg, 4, 8)), port_batch(jb))
    np.testing.assert_allclose(float(got_loss), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got_sq), sum_sq, rtol=1e-5)
    assert_leaves_close(got_grads, port_names(grads), 5e-3)
