"""The port's optimizers (``train.optim``, ``train.trainer.make_optimizer``)
against optax and the JAX package's ``make_optimizer``: three steps on a
small tree with fixed gradients, the parameters and ``eval_params`` after
each, clipping that clips, the EMA tail, and the refusal of EMA with
schedule-free."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.train.trainer import TrainState as JaxState
from diffusion_model_tpu.train.trainer import _ema_tail
from diffusion_model_tpu.train.trainer import make_optimizer as jax_make
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.train import optim
from diffusion_model_tpu_torch.train.trainer import TrainState, make_optimizer

torch.set_num_threads(4)

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, scale):
    return _tree(100 + step, scale)


def _run_both(jax_opt, port_opt, steps=3, scale=1.0, eval_fn=None):
    """Parameters (and eval parameters) after each step, JAX then port.
    The optax update runs jitted, as the JAX package's train step runs it
    (XLA's float32 ``b2 ** count`` under jit is not eager JAX's)."""
    p0 = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jax_opt.init(jp), port_opt.init(tp)
    jax_update = jax.jit(jax_opt.update)
    out = []
    for step in range(steps):
        g = _grads(step, scale)
        upd, js = jax_update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = port_opt.update({k: torch.from_numpy(v) for k, v in
                                  g.items()}, ts, tp)
        optim.apply_updates(tp, tu)
        rec = [(jp, {k: v.clone() for k, v in tp.items()})]
        if eval_fn is not None:
            want, got = eval_fn(js, jp, ts, tp)
            rec.append((want, {k: v.clone() for k, v in got.items()}))
        out.append(rec)
    return out


def _close(jtree, ttree, rtol=1e-6, atol=1e-7):
    for k in SHAPES:
        np.testing.assert_allclose(ttree[k].numpy(), np.asarray(jtree[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name,jax_opt,port_opt", [
    ("adam", optax.adam(1e-2),
     optim.chain(optim.scale_by_adam(), optim.scale(-1e-2))),
    ("amsgrad", optax.chain(optax.scale_by_amsgrad(),
                            optax.scale_by_learning_rate(1e-2)),
     optim.chain(optim.scale_by_amsgrad(), optim.scale(-1e-2))),
    ("radam", optax.radam(1e-2),
     optim.chain(optim.scale_by_radam(), optim.scale(-1e-2))),
    ("adam_cosine", optax.adam(optax.cosine_decay_schedule(1e-2, 5)),
     optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
         lambda k: -optim.cosine_decay(1e-2, 5, k)))),
])
def test_transform_matches_optax(name, jax_opt, port_opt):
    for (jp, tp), in _run_both(jax_opt, port_opt, steps=4):
        _close(jp, tp)


def test_radam_rectifier_follows_optax_over_the_threshold():
    """The rectified step starts where optax's float32 rho first reaches
    5: compare a radam with b1=0 step by step past that point."""
    jax_opt = optax.radam(1e-2, b1=0.0)
    port_opt = optim.chain(optim.scale_by_radam(b1=0.0), optim.scale(-1e-2))
    for (jp, tp), in _run_both(jax_opt, port_opt, steps=8):
        _close(jp, tp)


def _cfgs(**kw):
    return JaxConfig(**kw), Config(**kw)


@pytest.mark.parametrize("kw", [
    dict(optimizer="Adam", lr=1e-2, weight_decay=0.0),
    dict(optimizer="Adam", lr=1e-2, weight_decay=1e-2),
    dict(optimizer="AdamW", lr=1e-2, weight_decay=1e-2),
    dict(optimizer="RAdamScheduleFree", lr=2e-4),
    dict(optimizer="RAdamScheduleFree", lr=1e-2, max_grad_norm=1.0),
    dict(optimizer="Adam", lr=1e-2, ema_decay=0.9),
    dict(optimizer="AdamW", lr=1e-2, weight_decay=1e-2, ema_decay=0.5,
         max_grad_norm=2.0),
])
def test_make_optimizer_matches_the_jax_package(kw):
    jcfg, cfg = _cfgs(**kw)

    def evals(js, jp, ts, tp):
        want = JaxState(params=jp, opt_state=js, step=0).eval_params(jcfg)
        got = TrainState(tp, ts).eval_params(cfg)
        return want, got

    # scale 30: the global norm (~ 30 sqrt(31)) is above every
    # max_grad_norm tried, so clipping acts on each step
    for (jp, tp), (we, ge) in _run_both(jax_make(jcfg), make_optimizer(cfg),
                                        scale=30.0, eval_fn=evals):
        _close(jp, tp)
        _close(we, ge)


def test_clipping_clips():
    g = {k: torch.from_numpy(v) for k, v in _grads(0, 30.0).items()}
    norm = float(optim.global_norm(g))
    assert norm > 100.0
    clipped, _ = optim.chain(optim.clip_by_global_norm(100.0)).update(
        g, ((),), {})
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 100.0,
                               rtol=1e-6)
    kept, _ = optim.chain(optim.clip_by_global_norm(2 * norm)).update(
        g, ((),), {})
    for k in g:
        assert torch.equal(kept[k], g[k])


def test_amsgrad_is_not_torch_amsgrad():
    """optax takes the running maximum after the bias correction; torch's
    AdamW(amsgrad=True) before it. From the second step on they differ,
    and the port follows optax."""
    p0 = _tree(0)
    w = torch.from_numpy(p0["a"].copy()).requires_grad_()
    torch_opt = torch.optim.AdamW([w], lr=1e-2, weight_decay=0.0,
                                  amsgrad=True)
    port = {"a": torch.from_numpy(p0["a"].copy())}
    port_opt = optim.chain(optim.scale_by_amsgrad(), optim.scale(-1e-2))
    state = port_opt.init(port)
    for step, scale in enumerate((1.0, 0.1)):
        g = torch.from_numpy(_grads(step, scale)["a"])
        w.grad = g.clone()
        torch_opt.step()
        upd, state = port_opt.update({"a": g}, state, port)
        optim.apply_updates(port, upd)
    assert not torch.allclose(port["a"], w.detach(), rtol=1e-5, atol=0)


def test_ema_tail_matches_the_jax_package():
    jax_opt = optax.chain(optax.sgd(0.1), _ema_tail(0.8))
    port_opt = optim.chain(optim.scale(-0.1), optim.ema(0.8))

    def evals(js, jp, ts, tp):
        return js[-1].ema, ts[-1].ema

    for (jp, tp), (we, ge) in _run_both(jax_opt, port_opt, eval_fn=evals):
        _close(jp, tp)
        _close(we, ge)


def test_schedule_free_refuses_ema():
    with pytest.raises(ValueError, match="redundant"):
        make_optimizer(Config(optimizer="RAdamScheduleFree", ema_decay=0.9))
    with pytest.raises(ValueError, match="redundant"):
        jax_make(JaxConfig(optimizer="RAdamScheduleFree", ema_decay=0.9))


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(Config(optimizer="SGD"))
