"""Progressive distillation (``train.distill``, ``api.distill``) against the
JAX package's ``train/distill.py``: the step coefficients, the dyadic grids
against the strided sampler's, ``distill_loss`` and its every gradient leaf
on JAX's draws (dense and kNN, with and without diffused species), the
refusals, one phase of ``progressive_distill`` replayed on JAX's draws, and
the student ``api.distill`` returns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.diffusion import predefined_schedule as jax_predef
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu.train import distill as jax_distill
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.diffusion.process import (
    Schedule,
    predefined_schedule,
    reverse_diffuse_one_step,
)
from diffusion_model_tpu_torch.diffusion.sampler import _strided
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.train import distill
from diffusion_model_tpu_torch.train.checkpoint import state_dict_from_flax
from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
from jax_replay_training import drift_bounds
from test_torch_trainer import assert_leaves_close, np_tree, port_names
from torch_port_fixtures import port_batch

torch.set_num_threads(4)

# as the JAX package's tests/test_distill.py: noise_precision 0.05 tames
# the toy schedule's alpha tail, zero_init_x=False makes the coordinate
# head answer from init
TINY = dict(n_max=5, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=8, batch_size=4, lr=2e-3,
            optimizer="Adam", zero_init_x=False, noise_precision=0.05)


def cfgs(**kw):
    d = {**TINY, **kw}
    return JaxConfig(**d), Config(**d)


def jax_batches(jcfg, num=8, seed=0):
    graphs = synthetic_sio2_dataset(seed, num, jcfg.n_max,
                                    spectrum_size=jcfg.spectrum_size)
    return graphs, list(jax_split.batch_iterator(graphs, jcfg.batch_size,
                                                 jcfg.n_max, seed=1))


def jax_params(jcfg, jb, seed):
    """A fresh JAX denoiser's variables ``{"params": ...}``."""
    state = JaxTrainer(jcfg).init_state(jax.random.key(seed), jb,
                                        skip_gamma_fit=True)
    return state.params["denoiser"]


def port_model(cfg, variables, trainable: bool):
    model = DiffusionDenoiser(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(np_tree(variables)))
    return model.requires_grad_(trainable)


def jax_draws(key, jcfg, jb, student_steps):
    """``distill_loss``'s draws from ``key``, as the JAX package makes them
    (``k_j, k_pos, k_h = split(key, 3)``)."""
    k_j, k_pos, k_h = jax.random.split(key, 3)
    b = jb.mask.shape[0]
    j = jax.random.randint(k_j, (b,), 1, student_steps + 1)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype))

    return distill.DistillDraws(
        j=t(j, np.int64),
        pos=t(jax.random.normal(k_pos, jb.pos.shape)),
        h=(t(jax.random.normal(k_h, jb.species.shape))
           if jcfg.diffuse_species else None))


def phases(jcfg, cfg):
    jt = jax_distill.full_phase(jax_predef(jcfg))
    pt = distill.full_phase(predefined_schedule(cfg))
    np.testing.assert_array_equal(pt.alphas.numpy(), np.asarray(jt.alphas))
    return (jt, jt.halve()), (pt, pt.halve())


# -- step coefficients and grids ----------------------------------------------

def test_step_coeffs_match_jax_and_the_deterministic_reverse_step():
    jcfg, cfg = cfgs(onehot_scaling_factor=4.0)
    sched = predefined_schedule(cfg)
    t = torch.tensor([3, 5, 1, 8])
    a, b = distill.step_coeffs(sched.alphas, t)
    ja, jb = jax_distill.step_coeffs(jnp.asarray(sched.alphas.numpy()),
                                     jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(4, 5, 3, generator=gen)
    eps = torch.randn(4, 5, 3, generator=gen)
    got = a[:, None, None] * z + b[:, None, None] * eps
    want = reverse_diffuse_one_step(sched, None, z, eps, t, mode="h",
                                    deterministic=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    # the species channel: the sampler steps scale * h and stores it back
    h = torch.randn(4, 5, 2, generator=gen)
    eps_h = torch.randn(4, 5, 2, generator=gen)
    scale = cfg.onehot_scaling_factor
    got = (a * scale)[:, None, None] * h + b[:, None, None] * eps_h
    want = reverse_diffuse_one_step(sched, None, scale * h, eps_h, t,
                                    mode="h", deterministic=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_flat_learned_segment_keeps_coeffs_finite_as_jax():
    alphas = torch.tensor([0.9999999, 0.9999999, 0.5, 0.5000001, 0.1])
    for t in range(1, 5):
        a, b = distill.step_coeffs(alphas, torch.tensor([t]))
        ja, jb = jax_distill.step_coeffs(jnp.asarray(alphas.numpy()),
                                         jnp.array([t]))
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        assert float(b[0]) <= 0.0
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        # where the reverse step's sigma2_ts rounds below zero its
        # coefficient turns positive; the clamp keeps B at 0 there
        want = reverse_diffuse_one_step(Schedule(alphas), None,
                                        torch.zeros(1, 1, 1),
                                        torch.ones(1, 1, 1), torch.tensor([t]),
                                        mode="h", deterministic=True)
        assert float(b[0]) == pytest.approx(min(float(want), 0.0),
                                            abs=1e-6)


@pytest.mark.parametrize("steps", [500, 250, 125])
def test_halving_is_the_strided_sampler_grid(steps):
    """For K dividing T the strided sampler's ``round(linspace)`` grid is
    the dyadic phase grid the student trained on (T = 1000)."""
    _, cfg = cfgs(num_diffusion_timestep=1000, noise_precision=1e-5)
    sched = predefined_schedule(cfg)
    phase = distill.full_phase(sched)
    while phase.num_steps > steps:
        phase = phase.halve()
    assert phase.num_steps == steps
    grid, t_norm, k = _strided(sched, cfg.replace(sample_steps=steps))
    assert k == steps
    torch.testing.assert_close(phase.alphas, grid.alphas, rtol=0, atol=0)
    torch.testing.assert_close(phase.t_norm, t_norm, rtol=0, atol=0)
    jphase = jax_distill.full_phase(jax_predef(
        JaxConfig(num_diffusion_timestep=1000)))
    while jphase.num_steps > steps:
        jphase = jphase.halve()
    np.testing.assert_array_equal(phase.t_norm.numpy(),
                                  np.asarray(jphase.t_norm))


def test_odd_count_does_not_halve():
    with pytest.raises(ValueError, match="odd"):
        distill.PhaseSchedule(torch.ones(4), torch.ones(4)).halve()


# -- the loss -------------------------------------------------------------------

@pytest.mark.parametrize("neighbor_k", [0, 3], ids=["dense", "knn3"])
@pytest.mark.parametrize("diffuse_species", [True, False],
                         ids=["joint", "pos_only"])
def test_distill_loss_and_grads_match_jax(neighbor_k, diffuse_species):
    """The loss at rtol 1e-5 and every gradient leaf of the student at 5e-3
    (the one-step tolerances of ``test_torch_size_gen_check.py``), a
    teacher and a student of different weights, the 8 -> 4 phase, on the
    JAX package's draws."""
    jcfg, cfg = cfgs(neighbor_k=neighbor_k, diffuse_species=diffuse_species,
                     onehot_scaling_factor=2.0)
    _, batches = jax_batches(jcfg)
    jb = batches[0]
    teacher, student = jax_params(jcfg, jb, 0), jax_params(jcfg, jb, 1)
    (jtp, jsp), (tp, sp) = phases(jcfg, cfg)
    key = jax.random.key(4)
    apply_fn = JaxTrainer(jcfg).model.apply
    loss, grads = jax.jit(jax.value_and_grad(
        lambda s: jax_distill.distill_loss(s, teacher, apply_fn, jcfg, jtp,
                                           jsp, key, jb)))(student)
    t_model = port_model(cfg, teacher, trainable=False)
    s_model = port_model(cfg, student, trainable=True)
    draws = jax_draws(key, jcfg, jb, sp.num_steps)
    got = distill.distill_loss(s_model, t_model, cfg, tp, sp, port_batch(jb),
                               draws=draws)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    names = dict(s_model.named_parameters())
    parts = torch.autograd.grad(got, list(names.values()), allow_unused=True)
    got_grads = {f"denoiser.{k}": torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(names.items(), parts)}
    assert_leaves_close(got_grads, port_names({"denoiser": grads}), 5e-3)
    # the teacher took no gradient and the student's casts carried it
    assert all(p.grad is None for p in t_model.parameters())
    assert float(sum(g.abs().sum() for g in parts if g is not None)) > 0


def test_draws_come_from_the_generator_in_order():
    _, cfg = cfgs()
    batch = port_batch(jax_batches(JaxConfig(**TINY))[1][0])
    d = distill.draw(torch.Generator().manual_seed(3), 4, batch, True)
    gen = torch.Generator().manual_seed(3)
    j = torch.randint(1, 5, (4,), generator=gen)
    pos = torch.randn(tuple(batch.pos.shape), generator=gen)
    h = torch.randn(tuple(batch.species.shape), generator=gen)
    assert torch.equal(d.j, j) and torch.equal(d.pos, pos)
    assert torch.equal(d.h, h)
    assert d.j.min() >= 1 and d.j.max() <= 4


def test_non_eps_heads_and_non_power_of_two_ratios_are_refused():
    jcfg, cfg = cfgs(x_parameterization="x0")
    _, batches = jax_batches(jcfg)
    (jtp, jsp), (tp, sp) = phases(jcfg, cfg)
    with pytest.raises(NotImplementedError, match="eps"):
        jax_distill.distill_loss({}, {}, None, jcfg, jtp, jsp,
                                 jax.random.key(0), batches[0])
    model = DiffusionDenoiser(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="eps"):
        distill.distill_loss(model, model, cfg, tp, sp,
                             port_batch(batches[0]),
                             torch.Generator().manual_seed(0))
    _, cfg12 = cfgs(num_diffusion_timestep=12)
    sched = predefined_schedule(cfg12)
    with pytest.raises(ValueError, match="power of 2"):
        distill.progressive_distill(cfg12, model, sched, lambda: [], 4,
                                    generator=torch.Generator())
    with pytest.raises(ValueError, match="power of 2"):
        jax_distill.progressive_distill(
            JaxConfig(**{**TINY, "num_diffusion_timestep": 12}), None, {},
            jax_predef(JaxConfig(**{**TINY, "num_diffusion_timestep": 12})),
            lambda: [], jax.random.key(0), final_steps=4)


# -- the phases -------------------------------------------------------------------

def test_one_phase_replayed_on_jax_draws_stays_within_float32_drift():
    """The 8 -> 4 phase, 2 epochs of 2 batches, from the same teacher on the
    JAX package's key chain: every student parameter within the float32
    drift bound of the training replay (``jax_replay_training.drift_bounds``)
    of JAX's after the 4 steps, the same log lines."""
    jcfg, cfg = cfgs()
    _, batches = jax_batches(jcfg)
    teacher = jax_params(jcfg, batches[0], 0)
    lr, epochs = 1e-3, 2
    jlog, log = [], []
    result = jax_distill.progressive_distill(
        jcfg, JaxTrainer(jcfg).model.apply, teacher, jax_predef(jcfg),
        lambda: batches, jax.random.key(2), final_steps=4,
        epochs_per_phase=epochs, lr=lr, log_fn=jlog.append)
    chain = [jax.random.key(2)]

    def noise(student_steps, batch):
        chain[0], sub = jax.random.split(chain[0])
        jb = batches[noise.count % len(batches)]
        noise.count += 1
        return jax_draws(sub, jcfg, jb, student_steps)

    noise.count = 0
    port_batches = [port_batch(b) for b in batches]
    got = distill.progressive_distill(
        cfg, port_model(cfg, teacher, trainable=False),
        predefined_schedule(cfg), lambda: port_batches, final_steps=4,
        epochs_per_phase=epochs, lr=lr, log_fn=log.append, noise=noise)
    assert got.num_steps == result.num_steps == 4
    steps = epochs * len(batches)
    assert noise.count == steps
    want = port_names({"denoiser": np_tree(result.params)})
    bound = drift_bounds(steps, lr)["param_abs"]
    gaps = {k: float((got.params[k[len("denoiser."):]] - w).abs().max())
            for k, w in want.items()}
    assert max(gaps.values()) <= bound, max(gaps.items(), key=lambda x: x[1])
    moved = max(float(np.abs(np.asarray(w) - np.asarray(v)).max())
                for w, v in zip(jax.tree.leaves(np_tree(result.params)),
                                jax.tree.leaves(np_tree(teacher))))
    assert moved > 10 * bound   # the phase trained
    assert [line.split(": loss")[0] for line in log] == [
        line.split(": loss")[0] for line in jlog]
    for a, b in zip(log, jlog):
        np.testing.assert_allclose(float(a.split()[-1]),
                                   float(b.split()[-1]), rtol=2e-3)


def test_api_distill_returns_the_student_config_and_state():
    """``api.distill`` on the CPU from a learned-schedule run: the student
    config pins the dyadic grid, its state keeps the teacher's gamma
    network, ``eval_params`` is the identity, and the student samples
    through the strided sampler on its own grid."""
    _, cfg = cfgs(noise_schedule="learned", optimizer="RAdamScheduleFree",
                  ema_decay=0.0)
    graphs = synthetic_sio2_dataset(0, 8, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    log = []
    student_cfg, student = api.distill(cfg, trainer, state, graphs,
                                       final_steps=2, epochs_per_phase=1,
                                       log_fn=log.append)
    assert student_cfg == cfg.replace(
        sample_steps=2, deterministic_sampling=True, sample_grid="uniform",
        optimizer="Adam", ema_decay=0.0)
    assert student.opt_state is None and student.step == 0
    assert [line.split(": loss")[0] for line in log] == [
        "phase 8->4 epoch 0", "phase 4->2 epoch 0"]
    teacher = state.eval_params(cfg)
    assert sorted(student.params) == sorted(teacher)
    for k, v in teacher.items():
        if k.startswith("gamma."):
            assert torch.equal(student.params[k], v), k
    assert any(not torch.equal(student.params[k], v)
               for k, v in teacher.items() if k.startswith("denoiser."))
    ev = student.eval_params(student_cfg)
    assert all(torch.equal(ev[k], v) for k, v in student.params.items())
    out = api.generate(student_cfg, params_tree(ev), graphs[:2],
                       gen_num_per_spectrum=1, device="cpu")
    assert out["generated_pos"].shape == (2, cfg.n_max, 3)


def test_distill_check_scores_the_three_regimes(tmp_path):
    """``evals.distill_check`` on the CPU from a tiny snapshot: the student
    distilled 8 -> 2, and full, strided and distilled sampling scored on
    the snapshot's test split, each regime at its steps."""
    from diffusion_model_tpu_torch.evals import distill_check
    from diffusion_model_tpu_torch.train.checkpoint import save_params_npz

    _, cfg = cfgs(n_max=16, batch_size=8, gen_num_per_spectrum=2)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(cfg.seed)
    npz = str(tmp_path / "tiny.npz")
    save_params_npz(params_tree(state.eval_params(cfg)), npz,
                    dtype="float32", cfg=cfg)
    out = distill_check.distill_check(npz, final_steps=2,
                                      epochs_per_phase=1, num=20,
                                      device="cpu")
    assert out["card"] == "cpu" and out["test_conditions"] == 2
    assert [line.split(": loss")[0] for line in out["distill_log"]] == [
        "phase 8->4 epoch 0", "phase 4->2 epoch 0"]
    for regime, steps, det in (("full", 8, False), ("strided", 2, False),
                               ("distilled", 2, True)):
        row = out[regime]
        assert (row["sample_steps"], row["deterministic"]) == (steps, det)
        assert row["samples"] == 4 and 0 <= row["accepted"] <= 4
