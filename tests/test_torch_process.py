"""The port's schedule and reverse-process steps against the JAX package.

The JAX steps draw their noise inside (``process._noise_like``); the port's
take it as a tensor. Each case hands the port the raw normals JAX draws from
the same key, so both sides use the same numbers (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.diffusion import process as jp
from diffusion_model_tpu.ops import schedules as js
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.diffusion import process as tp
from diffusion_model_tpu_torch.ops import schedules as ts

torch.set_num_threads(4)

RTOL = 1e-6


def _schedules(T=1000, precision=1e-5, power=2.0):
    want = jp.predefined_schedule(JaxConfig(
        num_diffusion_timestep=T, noise_precision=precision,
        noise_schedule_power=power))
    got = tp.predefined_schedule(Config(
        num_diffusion_timestep=T, noise_precision=precision,
        noise_schedule_power=power))
    return want, got


@pytest.mark.parametrize("T,precision,power", [
    (1000, 1e-5, 2.0), (1000, 1e-4, 3.0), (50, 1e-5, 2.0), (7, 1e-3, 1.5)])
def test_schedule_table(T, precision, power):
    want, got = _schedules(T, precision, power)
    assert got.alphas.dtype == torch.float32
    assert got.num_timesteps == want.num_timesteps == T
    np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("start,stop,num", [
    (0.0, 1000.0, 1001), (0.0, 1000.0, 11), (0.0, 1000.0, 251),
    (0.0, 1000.0, 17), (0.0, 50.0, 51), (0.0, 7.0, 8)])
def test_linspace_matches_jnp(start, stop, num):
    np.testing.assert_array_equal(
        ts.linspace_f32(start, stop, num).numpy(),
        np.asarray(jnp.linspace(start, stop, num)))


@pytest.mark.parametrize("n", [5, 16, 64, 1001])
def test_clip_noise_schedule(n):
    a2 = np.random.default_rng(n).uniform(0.9, 1.0, n).astype(np.float32)
    np.testing.assert_allclose(
        ts.clip_noise_schedule(torch.from_numpy(a2)).numpy(),
        np.asarray(js.clip_noise_schedule(jnp.asarray(a2))), rtol=RTOL)


def _state(mode, seed=0, b=3, n=6, d=3):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[0, 4:] = 0.0
    mask[2, 2:] = 0.0
    z = rng.normal(size=(b, n, d)).astype(np.float32) * mask[..., None]
    eps = rng.normal(size=(b, n, d)).astype(np.float32) * mask[..., None]
    return z, eps, mask


T_CASES = [1, 2, 137, 500, 999, 1000]


@pytest.mark.parametrize("t", T_CASES)
def test_calculate_mu(t):
    want_s, got_s = _schedules()
    z, eps, _ = _state("pos", seed=t)
    want = jp.calculate_mu(want_s, jnp.asarray(z), jnp.asarray(eps), t)
    got = tp.calculate_mu(got_s, torch.from_numpy(z), torch.from_numpy(eps), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("mode", ["pos", "h"])
@pytest.mark.parametrize("t", T_CASES)
@pytest.mark.parametrize("deterministic,noise_scale", [
    (False, 1.0), (False, 0.5), (True, 1.0)])
def test_reverse_step(mode, t, deterministic, noise_scale):
    want_s, got_s = _schedules()
    d = 3 if mode == "pos" else 2
    z, eps, mask = _state(mode, seed=t, d=d)
    key = jax.random.key(t)
    want = jp.reverse_diffuse_one_step(
        want_s, key, jnp.asarray(z), jnp.asarray(eps), t, mode=mode,
        mask=jnp.asarray(mask), deterministic=deterministic,
        noise_scale=noise_scale)
    noise = torch.from_numpy(np.array(jax.random.normal(key, z.shape)))
    got = tp.reverse_diffuse_one_step(
        got_s, noise, torch.from_numpy(z), torch.from_numpy(eps), t,
        mode=mode, mask=torch.from_numpy(mask), deterministic=deterministic,
        noise_scale=noise_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)
    assert np.all(got.numpy()[mask == 0] == 0.0)


@pytest.mark.parametrize("mode", ["pos", "h"])
@pytest.mark.parametrize("deterministic", [False, True])
def test_final_denoise_step(mode, deterministic):
    want_s, got_s = _schedules()
    d = 3 if mode == "pos" else 2
    z, eps, mask = _state(mode, seed=7, d=d)
    key = jax.random.key(11)
    want = jp.final_denoise_step(
        want_s, key, jnp.asarray(z), jnp.asarray(eps), mode=mode,
        mask=jnp.asarray(mask), deterministic=deterministic)
    noise = torch.from_numpy(np.array(jax.random.normal(key, z.shape)))
    got = tp.final_denoise_step(
        got_s, noise, torch.from_numpy(z), torch.from_numpy(eps), mode=mode,
        mask=torch.from_numpy(mask), deterministic=deterministic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)


def test_position_noise_is_com_free_and_masked():
    _, _, mask = _state("pos")
    noise = torch.from_numpy(
        np.random.default_rng(3).normal(size=mask.shape + (3,)).astype(
            np.float32))
    m = torch.from_numpy(mask)
    shaped = tp.shape_noise(noise, "pos", m)
    assert torch.all(shaped[m == 0] == 0)
    com = (shaped * m[..., None]).sum(1) / m.sum(1, keepdim=True)
    assert float(com.abs().max()) < 1e-6
