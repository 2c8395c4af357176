"""The serving export (``serve.py``, ``cli/export.py``) against the JAX
package's: the served chain (the exported pieces and the loader's loop)
and its redraw rounds on JAX's draws, a written artifact bit for bit the
port's live sampler on every topology and option, the sidecar's keys, the
refusals, and ``cli.export`` with ``--calibrate`` on a run the port
trained. ``tests/test_torch_serve_export.py`` holds the artifact in a
process that cannot import the model code."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu import serve as jax_serve
from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.diffusion.process import Schedule as JaxSchedule
from diffusion_model_tpu.ops.schedules import (
    polynomial_alpha_schedule as jax_poly,
)
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch import api, serve
from diffusion_model_tpu_torch.cli import export
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.diffusion.process import Schedule
from diffusion_model_tpu_torch.diffusion.sampler import sample
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
from torch_port_fixtures import Replay, jax_sample_draws

torch.set_num_threads(4)

# tests/test_serve.py's widths
TINY = dict(n_max=6, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=10, batch_size=4, lr=1e-3,
            optimizer="Adam", noise_precision=0.05)


def tiny(**kw):
    return Config(**{**TINY, **kw})


def inputs(b, n, s=8, a=2):
    return (np.zeros((b, n, s), np.float32), np.zeros((b, n, 1), np.float32),
            np.ones((b, n), np.float32), np.zeros((b, n, a), np.float32))


# -- the served chain and its rounds on JAX's draws ----------------------------

def amplifying(factor):
    """The denoisers of tests/test_serve.py: ``eps_x = factor * pos``
    blows a row past the 1000 A bound or not by its initial draw."""
    def jax_fn(h, pos, spec, exo, t, mask, pm):
        return pos * factor, jnp.zeros_like(h)

    def port_fn(h, pos, spec, exo, t, mask, edges):
        return pos * factor, torch.zeros_like(h)

    return jax_fn, port_fn


def run_both(factor, retry_rounds, seed=7, b=8, n=4):
    """(JAX's (pos, accepted), the port's) of the served chain at ``seed``,
    the port's exported pieces driven by its loader, its rounds replaying
    JAX's draws (round 0 ``PRNGKey(seed)``, round i ``fold_in`` of it)."""
    d = {**TINY, "n_max": n, "num_diffusion_timestep": 3}
    jcfg, cfg = JaxConfig(**d), Config(**d)
    alphas = np.array(jax_poly(3, s=0.05, power=2.0))
    jax_fn, port_fn = amplifying(factor)
    # the exported pieces take the config's spectrum width
    spectrum, exo, mask, species = inputs(b, n, s=cfg.spectrum_input_size)
    fn = jax.jit(jax_serve._sampler_fn(
        jcfg, jax_fn, JaxSchedule(alphas=jnp.asarray(alphas)),
        retry_rounds=retry_rounds))
    jpos, _, jacc = fn(jnp.uint32(seed), spectrum, exo, mask, species)
    base = jax.random.PRNGKey(jnp.uint32(seed))

    def noise_for_round(i):
        key = base if i == 0 else jax.random.fold_in(base, i)
        return Replay(jax_sample_draws(key, b, n, 2, 3, True))

    programs, layout = serve.chain_programs(
        cfg, port_fn, Schedule(alphas=torch.from_numpy(alphas)), b, "cpu")
    port = serve._sampler_fn({k: ep.module() for k, ep in programs.items()},
                             layout, retry_rounds, noise_for_round)
    pos, _, acc = port(seed, *(torch.from_numpy(a) for a in
                               (spectrum, exo, mask, species)))
    return (np.asarray(jpos), np.asarray(jacc)), (pos.numpy(), acc.numpy())


@pytest.mark.parametrize("retry_rounds", [0, 8])
def test_served_chain_and_rounds_match_jax_on_its_draws(retry_rounds):
    (jpos, jacc), (pos, acc) = run_both(6.0, retry_rounds)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_allclose(pos[acc], jpos[acc], atol=1e-2, rtol=1e-5)
    if retry_rounds:
        assert acc.all()   # the rounds recovered every row, as in JAX
    else:
        assert 0 < acc.sum() < len(acc)   # a genuine mix


def test_rows_still_rejected_after_the_last_round_surface():
    (_, jacc), (_, acc) = run_both(8.0, 3)
    assert not jacc.any() and not acc.any()


def test_round_seeds():
    assert serve.round_generator(7, 0, "cpu").initial_seed() == 7
    seeds = {serve.retry_seed(7, i) for i in range(1, 9)}
    assert len(seeds) == 8 and 7 not in seeds
    assert serve.retry_seed(7, 3) == serve.retry_seed(7, 3)


# -- a written artifact against the live sampler --------------------------------

def trained(cfg, steps: int = 1):
    """(trainer, state, cond) of a tiny model a train step from init."""
    data = synthetic_sio2_dataset(0, 8, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size)
    cond = collate(data[:2], cfg.n_max, "cpu")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    noise = TrainNoise(3, "cpu")
    for _ in range(steps):
        state, _ = trainer.train_step(state, noise, cond)
    return trainer, state, cond


@pytest.mark.parametrize("kw", [
    dict(),
    dict(neighbor_k=3),
    dict(noise_schedule="learned"),
    dict(h_residual=True, virtual_node=True),
    dict(diffuse_species=False),
    dict(sample_steps=5, deterministic_sampling=True, retry_rounds=2),
], ids=["dense", "knn3", "learned", "hres_vn", "pos_only",
        "strided_det_retry"])
def test_artifact_is_bit_for_bit_the_live_sampler(kw, tmp_path):
    kw = dict(kw)
    rounds = kw.pop("retry_rounds", 0)
    cfg = tiny(**kw)
    trainer, state, cond = trained(cfg)
    path = str(tmp_path / "sampler.pt")
    serve.export_sampler(cfg, trainer, state, path, batch_size=2,
                         platforms=("cpu",), retry_rounds=rounds)
    served = serve.ServedSampler(path, device="cpu")
    species = None if cfg.diffuse_species else cond.species.numpy()
    pos, sp, acc = served(7, cond.spectrum.numpy(), cond.exo.numpy(),
                          cond.mask.numpy(), species)
    params = params_tree(state.eval_params(cfg))
    live = sample(api.denoiser_from_params(cfg, params, "cpu"),
                  api.schedule_for(cfg, params, "cpu"), cfg,
                  torch.Generator().manual_seed(7), cond)
    assert live.accepted.all()   # the rounds then never run
    np.testing.assert_array_equal(pos, live.pos.numpy())
    np.testing.assert_array_equal(sp, live.species.numpy())
    np.testing.assert_array_equal(acc, live.accepted.numpy())
    assert served.meta["in_graph_retry_rounds"] == rounds
    if not cfg.diffuse_species:
        np.testing.assert_array_equal(sp, cond.species.numpy())
        with pytest.raises(ValueError, match="position-only"):
            served(7, cond.spectrum.numpy(), cond.exo.numpy(),
                   cond.mask.numpy())


def test_sidecar_keys_are_jax_s_and_a_jax_artifact_is_refused(tmp_path):
    d = {**TINY, "L": 1, "num_diffusion_timestep": 2}
    jcfg, cfg = JaxConfig(**d), Config(**d)
    data = synthetic_sio2_dataset(1, 2, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size)
    jtrainer = JaxTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.key(0),
                                 jax_collate(data, cfg.n_max))
    jpath = str(tmp_path / "jax.bin")
    stats = {"single_draw_accepted_fraction": 1.0}
    jax_serve.export_sampler(jcfg, jtrainer, jstate, jpath, batch_size=2,
                             platforms=("cpu",), retry_rounds=1,
                             acceptance_stats=stats)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    path = str(tmp_path / "port.pt")
    serve.export_sampler(cfg, trainer, state, path, batch_size=2,
                         platforms=("cpu",), retry_rounds=1,
                         acceptance_stats=stats)
    with open(jpath + ".json") as f:
        want = json.load(f)
    with open(path + ".json") as f:
        got = json.load(f)
    assert list(got) == list(want)
    assert got == want
    with pytest.raises(ValueError, match="not a serving artifact of the port"):
        serve.ServedSampler(jpath, device="cpu")


def test_refusals(tmp_path):
    cfg = tiny()
    trainer, state, cond = trained(cfg, steps=0)
    path = str(tmp_path / "s.pt")
    with pytest.raises(ValueError, match="tpu"):
        serve.export_sampler(cfg, trainer, state, path, 2,
                             platforms=("cpu", "tpu"))
    serve.export_sampler(cfg, trainer, state, path, 2, platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for"):
        serve.ServedSampler(path, device="cpu")
    serve.export_sampler(cfg, trainer, state, path, 2, platforms=("cpu",))
    served = serve.ServedSampler(path, device="cpu")
    args = [cond.spectrum.numpy(), cond.exo.numpy(), cond.mask.numpy()]
    with pytest.raises(ValueError, match="shape"):
        served(1, *(np.concatenate([a, a]) for a in args))
    with pytest.raises(ValueError, match="shape"):
        served(1, args[0][:, :-1], args[1][:, :-1], args[2][:, :-1])
    for seed in (-1, 2 ** 32):
        with pytest.raises(ValueError, match="seed"):
            served(seed, *args)
    torch.save({"format": "something else"}, path)
    with pytest.raises(ValueError, match="format"):
        serve.ServedSampler(path, device="cpu")


# -- the CLI ---------------------------------------------------------------------

def test_cli_export_with_calibrate_on_a_run_the_port_trained(tmp_path):
    cfg = Config(L=1, m_hidden_size=16, h_hidden_size=16, x_hidden_size=16,
                 m_size=8, spectrum_size=16, compressed_spectrum_size=8,
                 compressor_hidden_dim=(8,), num_diffusion_timestep=4,
                 batch_size=8, lr=1e-3, optimizer="Adam",
                 noise_precision=0.05, gen_num_per_spectrum=1, num_epochs=2,
                 n_max=16)
    run = str(tmp_path / "run")
    data = synthetic_sio2_dataset(cfg.seed, 16, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size)
    api.train(cfg, data, run, device="cpu")
    out = str(tmp_path / "sampler.pt")
    export.main(["--run_dir", run, "--out", out, "--batch_size", "2",
                 "--sample_steps", "2", "--platforms", "cpu",
                 "--calibrate", "2", "--device", "cpu"])
    served = serve.ServedSampler(out, device="cpu")
    meta = served.meta
    assert meta["sample_steps"] == 2 and meta["platforms"] == ["cpu"]
    acc = meta["acceptance"]
    assert sorted(acc) == ["calls", "conditions", "samples",
                           "single_draw_accepted_fraction"]
    assert (acc["calls"], acc["samples"], acc["conditions"]) == (
        2, 4, "synthetic_sio2")
    assert 0.0 <= acc["single_draw_accepted_fraction"] <= 1.0
    n, s = meta["n_max"], meta["spectrum_size"]
    pos, species, accepted = served(1, np.zeros((2, n, s), np.float32),
                                    np.zeros((2, n, 1), np.float32),
                                    np.ones((2, n), np.float32))
    assert pos.shape == (2, n, 3) and species.shape == (2, n, 2)
    assert accepted.dtype == bool
