"""The x0 and v coordinate heads in the port's training, against the JAX
package on the CPU at tiny widths (the conversions and chains are
``test_torch_heads.py``).

* One train step against JAX in float32, dense and kNN, polynomial and
  learned schedule, for each head and for eps beside them: the loss at
  rtol 1e-5 and every leaf's gradient through
  ``test_torch_trainer.assert_leaves_close`` at its 5e-3, from a
  zero-initialised coordinate head as ``test_torch_trainer.py``'s, and
  from a random one (``-random_x``). With a random head and the learned
  schedule the gamma network's ``l1`` gradient is a sum over the table
  that cancels to 1e-5 of its terms, and float32 cannot resolve it in
  either package (ROADMAP.md section 3, F8): the test splits the chain
  rule at the table, holds the loss's gradient in each table entry to
  JAX's, the two networks' ``d gamma / d l1`` to each other in float64,
  and each package's float32 ``l1`` gradient to the float64 contraction
  within ``l1_rounding_bound``.
* The loss from a fresh init is finite and falls; a run trained with a
  head reloads and samples with it.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.diffusion import process as jp
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.diffusion import process as tp
from diffusion_model_tpu_torch.nn.gamma import ENDPOINT_SCALE, GammaNetwork
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


def table_grads(jcfg, params, key, jb, trainer, draws, batch):
    """The loss's gradient in each entry of the learned gamma table
    ``[T+1]``, float32, from JAX's ``Trainer._loss`` and the port's
    ``Trainer._loss``, both at JAX's table."""
    jtr = JaxTrainer(jcfg)
    T = jcfg.num_diffusion_timestep
    table = jtr.gamma.apply(params["gamma"],
                            jnp.linspace(0.0, 1.0, T + 1)[:, None])[:, 0]

    def jax_loss(g):
        jtr.schedule_for = lambda p: jp.Schedule(
            alphas=jnp.sqrt(jax.nn.sigmoid(-g)))
        return jtr._loss(params, key, jb)[0]

    want = np.asarray(jax.grad(jax_loss)(table))
    leaf = torch.from_numpy(np.array(table)).requires_grad_()
    schedule_for = trainer.schedule_for
    trainer.schedule_for = lambda gamma: tp.Schedule(
        alphas=torch.sqrt(torch.sigmoid(-leaf)))
    try:
        loss, _, _ = trainer._loss(trainer.model, trainer.gamma, draws, batch)
    finally:
        trainer.schedule_for = schedule_for
    return torch.autograd.grad(loss, leaf)[0].numpy(), want


def dgamma_dl1(jcfg, params, gamma) -> tuple:
    """``d gamma_t / d l1`` over the table ``[T+1]`` in float64: the port's
    network in torch float64, JAX's under the scoped x64 context (never
    process-wide: later tests in the worker run in float32)."""
    T = jcfg.num_diffusion_timestep
    g64 = GammaNetwork().double()
    g64.load_state_dict({k: v.double() for k, v in gamma.state_dict().items()})
    t64 = torch.linspace(0.0, 1.0, T + 1, dtype=torch.float64)[:, None]
    w = g64.l1.weight
    port = torch.autograd.functional.jacobian(
        lambda l1: torch.func.functional_call(
            g64, {"l1.weight": l1}, (t64,))[:, 0], w).reshape(T + 1)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           params["gamma"])
        tj = jnp.linspace(0.0, 1.0, T + 1, dtype=jnp.float64)[:, None]

        def table(l1):
            p = {"params": {**p64["params"], "l1": {"weight": l1}}}
            return JaxTrainer(jcfg).gamma.apply(p, tj)[:, 0]

        jac = jax.jacobian(table)(p64["params"]["l1"]["weight"])
        assert jac.dtype == jnp.float64
        want = np.asarray(jac).reshape(T + 1)
    return port.detach().numpy(), want, g64, t64


def l1_rounding_bound(g64, t64, G, u: float) -> float:
    """First-order bound of rounding at unit ``u`` (2^-24 float32, 2^-53
    float64) on ``l1``'s gradient ``sum_t G_t d gamma_t / d l1``, from the
    float64 network.

    gamma_t = gamma_0 + (gamma_1 - gamma_0) (g_t - g_0) / (g_1 - g_0) with
    g = gamma_tilde, so the gradient is k [sum_t G_t dg_t - (sum_t G_t
    n_t)(dg_1 - dg_0)], with k = (gamma_1 - gamma_0) / (g_1 - g_0), n_t
    the normalised table and dg_t = d g_t / d l1: two terms that cancel
    (to 1e-5 of their size at these widths). Each g_t is a sum of
    ``hidden`` positive terms (~65 while g_1 - g_0 is ~0.29), which a
    pairwise sum rounds by at most log2(hidden) u |g_t|; the forward
    differences g_t - g_0 carry that into the backward, and the two terms
    their own u log2(hidden) times their size."""
    hidden = g64.l2.weight.shape[0]
    c = u * math.ceil(math.log2(hidden))
    tt = torch.cat([t64, torch.zeros(1, 1, dtype=t64.dtype),
                    torch.ones(1, 1, dtype=t64.dtype)])
    dg = torch.autograd.functional.jacobian(
        lambda l1: _gamma_tilde_at(g64, l1, tt)[:, 0],
        g64.l1.weight.detach()).reshape(-1)
    with torch.no_grad():
        G = torch.from_numpy(np.asarray(G, np.float64))
        gs = g64.gamma_tilde(tt)[:, 0]
        g, g0, g1 = gs[:-2], gs[-2], gs[-1]
        dgt, dg_ends = dg[:-2], dg[-2].abs() + dg[-1].abs()
        k = ((g64.gamma_1 - g64.gamma_0)[0] * ENDPOINT_SCALE
             / (g1 - g0)).abs()
        terms = ((G.abs() * dgt.abs()).sum()
                 + (G * (g - g0) / (g1 - g0)).sum().abs() * dg_ends)
        forward = dg_ends * (G.abs() * (g.abs() + g0.abs())).sum() / (
            g1 - g0).abs()
        return float(c * k * (terms + forward))


def _gamma_tilde_at(g64, l1, t):
    """``g64.gamma_tilde(t)`` with ``l1``'s weight given."""
    l1_t = (t.unsqueeze(-2) * torch.nn.functional.softplus(l1)).sum(dim=-1)
    return l1_t + g64.l3(torch.sigmoid(g64.l2(l1_t)))


def check_l1_by_table(jcfg, params, key, jb, trainer, batch, got, want):
    """F8: the loss's gradient agrees entry by entry over the table, the
    two networks' float64 ``d gamma / d l1`` agree, and each package's
    float32 ``l1`` gradient lies within ``l1_rounding_bound`` of the float64
    contraction."""
    G_port, G_jax = table_grads(
        jcfg, params, key, jb, trainer,
        ReplayDraws(jax_loss_draws(key, jcfg, 4, jcfg.n_max)), batch)
    np.testing.assert_allclose(G_port, G_jax, rtol=1e-4,
                               atol=1e-5 * float(np.abs(G_jax).max()))
    J_port, J_jax, g64, t64 = dgamma_dl1(jcfg, params, trainer.gamma)
    G = np.asarray(G_jax, np.float64)
    exact, exact_jax = float(G @ J_port), float(G @ J_jax)
    assert abs(exact - exact_jax) <= l1_rounding_bound(
        g64, t64, G, 2.0 ** -53)
    bound = l1_rounding_bound(g64, t64, G, 2.0 ** -24)
    for name, value in (("port", got), ("jax", want)):
        err = abs(float(np.asarray(value).reshape(-1)[0]) - exact)
        assert err <= bound, (name, value, exact, bound)


HEADS = [pytest.param(mode, True, id=mode) for mode in ("eps",) + MODES] + [
    pytest.param(mode, False, id=f"{mode}-random_x")
    for mode in ("eps",) + MODES]


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mode,zero_init_x", HEADS)
def test_train_step_matches_jax(mode, zero_init_x, route, schedule):
    jcfg, cfg = cfgs(x_parameterization=mode, num_diffusion_timestep=50,
                     zero_init_x=zero_init_x, **ROUTES[route],
                     **SCHEDULES[schedule])
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
    if schedule == "learned" and not zero_init_x:
        l1 = "gamma.l1.weight"
        check_l1_by_table(jcfg, params, key, jb, trainer, port_batch(jb),
                          got_grads.pop(l1), want.pop(l1))
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
