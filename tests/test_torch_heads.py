"""The x0 and v coordinate heads (``x_parameterization``) in the port
against the JAX package, on the CPU at tiny widths.

* The conversions (``x0_out_to_eps``, ``v_out_to_eps``) against JAX's,
  float32, rtol 1e-6 (atol 1e-6 of the terms' scale), on the polynomial
  table, the learned snapshot's gamma table and strided tables, at
  t in {0, 1, T/2, T} and at a per-graph t; the oracle identities.
* Whole chains replayed from JAX's draws against JAX's ``sample``, on the
  full and strided grids, with and without guidance: positions at atol
  1e-2 A (the chain tolerance of ``test_torch_sampler.py``), species
  exactly; and teacher-forced, each step started from JAX's state, at
  rtol 1e-5 of the state's scale.
* The species channel stays epsilon.

Training with a head is ``test_torch_heads_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.diffusion import process as jp
from diffusion_model_tpu.diffusion import sampler as js
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu.train import checkpoint as jax_ckpt
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion import process as tp
from diffusion_model_tpu_torch.diffusion import sampler as ts
from test_torch_trainer import np_tree, tiny_data
from torch_port_fixtures import LEARNED, Replay, jax_sample_draws

torch.set_num_threads(4)

MODES = ("x0", "v")
TINY = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=20, batch_size=4, lr=1e-3,
            optimizer="Adam", noise_precision=0.05, zero_init_x=False)
POS_TOL = dict(rtol=1e-3, atol=1e-2)
COPIES = 2
X_HEAD_SCALE = 0.03


def cfgs(**kw):
    d = {**TINY, **kw}
    return JaxConfig(**d), Config(**d)


# -- the conversions ----------------------------------------------------

def _tables():
    """name -> (JAX alphas, port alphas) of the tables a head reads."""
    cfg = Config()
    poly = tp.predefined_schedule(cfg).alphas
    jpoly = jp.predefined_schedule(JaxConfig()).alphas
    lcfg = jax_ckpt.load_config_npz(str(LEARNED))
    lparams = jax_ckpt.load_params_npz(str(LEARNED))
    jlearned = JaxTrainer(lcfg).schedule_for(lparams).alphas
    learned = api.schedule_for(Config(noise_schedule="learned"),
                               np_tree(lparams), "cpu").alphas
    out = {"predefined": (jpoly, poly), "learned": (jlearned, learned)}
    for grid in ("uniform", "snr"):
        scfg = cfg.replace(sample_steps=250, sample_grid=grid)
        idx = (js.snr_grid(jpoly, 250) if grid == "snr" else
               jnp.round(jnp.linspace(0.0, 1000, 251)).astype(jnp.int32))
        out[f"strided_{grid}"] = (jpoly[idx],
                                  ts._strided(tp.Schedule(poly), scfg)[0]
                                  .alphas)
    return out


@pytest.fixture(scope="module")
def tables():
    return _tables()


@pytest.mark.parametrize("table", ["predefined", "learned",
                                   "strided_uniform", "strided_snr"])
@pytest.mark.parametrize("mode", MODES)
def test_conversion_matches_jax(tables, table, mode):
    jalphas, alphas = tables[table]
    if table == "learned":
        # the gamma network's own table differs in float32 rounding
        # (test_torch_gamma.py holds it); the conversion reads JAX's
        alphas = torch.from_numpy(np.array(jalphas))
    np.testing.assert_array_equal(alphas.numpy(), np.asarray(jalphas))
    T = alphas.shape[0] - 1
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 8, 3)).astype(np.float32)
    out = rng.normal(size=(4, 8, 3)).astype(np.float32)
    jfn = jp.x0_out_to_eps if mode == "x0" else jp.v_out_to_eps
    fn = tp.x0_out_to_eps if mode == "x0" else tp.v_out_to_eps
    ts_ = [0, 1, T // 2, T]
    cases = [(t, t) for t in ts_] + [(jnp.asarray(ts_),
                                      torch.tensor(ts_))]
    for jt, t in cases:
        want = np.asarray(jfn(jp.Schedule(alphas=jalphas), jt,
                              jnp.asarray(z), jnp.asarray(out)))
        got = fn(tp.Schedule(alphas=alphas), t, torch.from_numpy(z),
                 torch.from_numpy(out)).numpy()
        assert got.dtype == np.float32
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=f"{table} t={t}")


@pytest.mark.parametrize("mode", MODES)
def test_oracle_identity(mode):
    """The mode's oracle output gives back the exact forward noise:
    out = x0 - z_t for "x0", out = alpha eps - sigma x0 for "v"."""
    _, cfg = cfgs()
    schedule = tp.predefined_schedule(cfg)
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(4, 8, 3, generator=g)
    mask = torch.ones(4, 8)
    mask[1, 6:] = 0
    x0 = x0 * mask[..., None]
    t = torch.tensor([1, 7, 13, 20])
    z, eps = tp.diffuse_zero_to_t(schedule, torch.randn(4, 8, 3, generator=g),
                                  x0, t, mode="pos", mask=mask)
    if mode == "x0":
        back = tp.x0_out_to_eps(schedule, t, z, x0 - z)
    else:
        alpha = schedule.alpha(t)[:, None, None]
        sigma = schedule.sigma(t)[:, None, None]
        back = tp.v_out_to_eps(schedule, t, z, alpha * eps - sigma * x0)
    np.testing.assert_allclose(back.numpy(), eps.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("value", ["eps", "x0", "v", "foo"])
def test_head_validation(value):
    if value == "foo":
        with pytest.raises(ValueError, match="x_parameterization"):
            Config(x_parameterization=value)
        return
    cfg = Config(x_parameterization=value)
    assert tp.x_param_is_x0(cfg) == (value != "eps")


# -- chains -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model():
    """A tiny denoiser's random weights (JAX init, x output not zeroed),
    the conditions and their JAX batch."""
    jcfg, _ = cfgs()
    graphs = tiny_data(jcfg, num=2, seed=4)
    jcond = js.tile_batch(jax_collate(graphs, jcfg.n_max), COPIES)
    params = JaxDenoiser(jcfg).init(
        jax.random.key(0), jcond.species, jcond.pos, jcond.spectrum,
        jcond.exo, jnp.zeros(jcond.mask.shape + (1,)), jcond.mask,
        jcond.pair_mask())
    # the coordinate head's last layer scaled down: a random x0 head at
    # full scale drives every chain past 1000 A in both packages
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * X_HEAD_SCALE
        if "mlp_x_dense2" in jax.tree_util.keystr(path) else a, params)
    return graphs, jcond, {"denoiser": params}


def _jax_chain(jcfg, params, jcond, key, trajectory=False):
    model = JaxDenoiser(jcfg)
    denoise = lambda *a: model.apply(params["denoiser"], *a)  # noqa: E731
    return jax.jit(lambda k, c: js.sample(
        denoise, jp.predefined_schedule(jcfg), jcfg, k, c,
        return_trajectory=trajectory))(key, jcond)


GRIDS = {"full": dict(), "uniform": dict(sample_steps=7),
         "snr": dict(sample_steps=7, sample_grid="snr")}


@pytest.mark.parametrize("guidance", [0.0, 1.5])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("mode", MODES)
def test_chain_matches_jax(tiny_model, mode, grid, guidance):
    graphs, jcond, params = tiny_model
    jcfg, cfg = cfgs(x_parameterization=mode, guidance_scale=guidance,
                     **GRIDS[grid])
    key = jax.random.key(17)
    want = _jax_chain(jcfg, params, jcond, key)
    assert bool(np.all(want.accepted)), "a chain that fails proves nothing"
    b, n = jcond.mask.shape
    steps = cfg.sample_steps or cfg.num_diffusion_timestep
    noise = Replay(jax_sample_draws(key, b, n, cfg.atom_type_size, steps,
                                    True))
    model = api.denoiser_from_params(cfg, np_tree(params), "cpu")
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    got = ts.sample(model, tp.predefined_schedule(cfg), cfg, None, cond,
                    noise)
    assert not noise.draws, "the port drew fewer numbers than JAX"
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **POS_TOL)
    np.testing.assert_array_equal(got.species.numpy(),
                                  np.asarray(want.species))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **POS_TOL)


@pytest.mark.parametrize("grid", ["full", "snr"])
@pytest.mark.parametrize("mode", MODES)
def test_teacher_forced_steps_match_jax(tiny_model, mode, grid):
    """Every reverse step and the epilogue of the port started from JAX's
    state with JAX's draws lands on JAX's next state, rtol 1e-5 of the
    state's scale; the epilogue's species equal JAX's."""
    graphs, jcond, params = tiny_model
    jcfg, cfg = cfgs(x_parameterization=mode, snapshot_every=1,
                     **GRIDS[grid])
    key = jax.random.key(23)
    want = _jax_chain(jcfg, params, jcond, key, trajectory=True)
    b, n = jcond.mask.shape
    steps = cfg.sample_steps or cfg.num_diffusion_timestep
    draws = [torch.from_numpy(np.array(d)) for d in jax_sample_draws(
        key, b, n, cfg.atom_type_size, steps, True)]
    model = api.denoiser_from_params(cfg, np_tree(params), "cpu")
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    chain = ts.ReverseChain(model, tp.predefined_schedule(cfg), cfg, cond)
    frames_pos, frames_h = (np.array(a) for a in want.trajectory)

    def close(got, ref):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))

    with torch.no_grad():
        for k in range(steps - 1):
            pos, h = chain.step(torch.from_numpy(frames_pos[k]),
                                torch.from_numpy(frames_h[k]), steps - k,
                                draws[2 + 2 * k], draws[3 + 2 * k])
            close(pos.numpy(), frames_pos[k + 1])
            close(h.numpy(), frames_h[k + 1])
        # the last step, then the epilogue from the port's state: JAX keeps
        # no frame of the state entering its epilogue
        pos, h = chain.step(torch.from_numpy(frames_pos[-1]),
                            torch.from_numpy(frames_h[-1]), 1,
                            draws[-4], draws[-3])
        pos, h, species = chain.epilogue(pos, h, draws[-2], draws[-1])
    close(pos.numpy(), np.asarray(want.pos))
    close(h.numpy(), np.asarray(want.h))
    np.testing.assert_array_equal(species.numpy(), np.asarray(want.species))


@pytest.mark.parametrize("guidance", [0.0, 1.5])
@pytest.mark.parametrize("mode", MODES)
def test_species_channel_stays_eps(mode, guidance):
    """The chain converts the coordinate output after the guidance blend
    and hands the species output on as it came."""
    _, cfg = cfgs(x_parameterization=mode, guidance_scale=guidance,
                  sample_steps=5)
    g = torch.Generator().manual_seed(1)
    raw = {}

    def denoise(species, pos, spectrum, exo, t_norm, mask, edges):
        c = spectrum.mean(-1, keepdim=True)
        out = (0.7 * pos + 0.2 * c, 0.5 * species - 0.1 * c)
        raw.setdefault("calls", []).append(out)
        return out

    b, n = 3, cfg.n_max
    mask = torch.ones(b, n)
    cond = ts.GraphBatch(pos=torch.zeros(b, n, 3),
                         species=torch.zeros(b, n, 2),
                         spectrum=torch.rand(b, n, cfg.spectrum_size,
                                             generator=g),
                         exo=torch.zeros(b, n, 1), mask=mask)
    chain = ts.ReverseChain(denoise, tp.predefined_schedule(cfg), cfg, cond)
    pos = torch.randn(b, n, 3, generator=g)
    h = torch.randn(b, n, 2, generator=g)
    eps_x, eps_h = chain.denoise(pos, h, 3)
    calls = raw["calls"]
    w = cfg.guidance_scale
    bx, bh = calls[0]
    if w > 0:
        bx = (1 + w) * calls[0][0] - w * calls[1][0]
        bh = (1 + w) * calls[0][1] - w * calls[1][1]
    torch.testing.assert_close(eps_h, bh, rtol=0, atol=0)
    torch.testing.assert_close(
        eps_x, tp.head_out_to_eps(cfg, chain.schedule, 3, pos, bx),
        rtol=0, atol=0)
    assert not torch.equal(eps_x, bx)
