"""The x0 and v coordinate heads in the port's training, against the JAX
package on the CPU at tiny widths (the conversions and chains are
``test_torch_heads.py``).

* One train step against JAX in float32, dense and kNN, polynomial and
  learned schedule, for each head and for eps beside them: the loss at rtol 1e-5 and every leaf's gradient
  through ``test_torch_trainer.assert_leaves_close`` at its 5e-3, from a
  zero-initialised coordinate head as ``test_torch_trainer.py``'s (with a
  random one the gamma network's ``l1`` gradient parts from JAX's in
  every mode, the eps head's too: ROADMAP.md section 3).
* The loss from a fresh init is finite and falls; a run trained with a
  head reloads and samples with it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.diffusion import process as tp
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
from test_torch_heads import MODES, cfgs
from test_torch_trainer import (
    assert_leaves_close,
    jax_step,
    np_tree,
    port_names,
    tiny_data,
)
from torch_port_fixtures import ReplayDraws, jax_loss_draws, port_batch

torch.set_num_threads(4)

ROUTES = {"dense": dict(), "knn": dict(neighbor_k=3)}
SCHEDULES = {"predefined": dict(),
             "learned": dict(noise_schedule="learned",
                             optimizer="RAdamScheduleFree")}


def pin_table(trainer, jax_alphas):
    """Make ``trainer``'s learned table hold JAX's values, its gradient
    still the port's gamma network's: the two networks' tables differ in
    float32 rounding (1.5e-5 relative where alpha is 5e-6; held by
    test_torch_gamma.py), which sigma = sqrt(1 - alpha^2) amplifies near
    alpha = 1 until the eps-head loss itself parts by 3.5e-5."""
    want = torch.from_numpy(np.array(jax_alphas))
    table = trainer.schedule_for

    def pinned(gamma):
        alphas = table(gamma).alphas
        return tp.Schedule(alphas=alphas + (want - alphas).detach())

    trainer.schedule_for = pinned


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mode", ("eps",) + MODES)
def test_train_step_matches_jax(mode, route, schedule):
    jcfg, cfg = cfgs(x_parameterization=mode, num_diffusion_timestep=50,
                     zero_init_x=True, **ROUTES[route], **SCHEDULES[schedule])
    jb = next(jax_split.batch_iterator(tiny_data(jcfg), 4, jcfg.n_max,
                                       seed=1))
    key = jax.random.key(5)
    params, loss, sum_sq, grads, _ = jax_step(jcfg, jb, key)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=np_tree(params))
    if schedule == "learned":
        pin_table(trainer, JaxTrainer(jcfg).schedule_for(params).alphas)
    got_loss, got_sq, _, got_grads = trainer.loss_and_grads(
        state, ReplayDraws(jax_loss_draws(key, jcfg, 4, jcfg.n_max)),
        port_batch(jb))
    np.testing.assert_allclose(float(got_loss), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got_sq), sum_sq, rtol=1e-5)
    want = port_names(grads)
    if schedule == "learned":
        assert any(k.startswith("gamma.") for k in want)
    assert_leaves_close(got_grads, want, 5e-3)


@pytest.mark.parametrize("mode", MODES)
def test_loss_finite_at_init_and_decreases(mode):
    """As the JAX package's test of the same name: 40 steps from a fresh
    init on one batch; the first loss stays O(1) (the z-term keeps the
    conversion from blowing up) and the loss falls."""
    jcfg, cfg = cfgs(x_parameterization=mode, zero_init_x=True)
    jb = next(jax_split.batch_iterator(tiny_data(jcfg), 4, jcfg.n_max,
                                       seed=1))
    batch = port_batch(jb)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    losses = []
    for i in range(40):
        state, m = trainer.train_step(state, TrainNoise(i, "cpu"), batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] < 1e3
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("mode", MODES)
def test_load_trained_samples_with_its_head(tmp_path, mode):
    """A run trained with a head keeps it in its checkpoint's config; it
    reloads with that head and samples (the chain reads the same head:
    it equals the sample of the run's own parameters), and refuses a
    config with another head."""
    jcfg, cfg = cfgs(x_parameterization=mode, num_diffusion_timestep=10,
                     batch_size=4, checkpoint_every=1)
    graphs = tiny_data(jcfg, num=10)
    run = str(tmp_path / "run")
    _, state, (_, _, test) = api.train(cfg, graphs, run, num_epochs=2,
                                       device="cpu")
    step_dir = os.path.join(run, "checkpoints", "2")
    with open(os.path.join(step_dir, "config.json")) as f:
        assert json.load(f)["x_parameterization"] == mode
    trainer, loaded = api.load_trained(run, cfg, device="cpu")
    params = params_tree(loaded.eval_params(cfg))
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    out = api.generate(cfg, params, test[:1], g1, device="cpu")
    ref = api.generate(cfg, params_tree(state.eval_params(cfg)), test[:1],
                       g2, device="cpu")
    assert np.isfinite(out["generated_pos"]).all()
    np.testing.assert_array_equal(out["generated_pos"], ref["generated_pos"])
    eps = api.generate(cfg.replace(x_parameterization="eps"), params,
                       test[:1], torch.Generator().manual_seed(0),
                       device="cpu")
    assert not np.array_equal(eps["generated_pos"], out["generated_pos"])
    with pytest.raises(ValueError, match="x_parameterization"):
        api.load_trained(run, cfg.replace(x_parameterization="eps"),
                         device="cpu")
