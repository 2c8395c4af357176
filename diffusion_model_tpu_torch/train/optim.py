"""optax's update rules over dicts of tensors, for the optimizers the JAX
package trains with (``diffusion_model_tpu/train/trainer.py``
``make_optimizer``).

Written to optax's rules, not to ``torch.optim``'s, which differ in places:
``torch.optim.AdamW(amsgrad=True)`` keeps the running maximum of the raw
second moment, optax's ``scale_by_amsgrad`` that of the bias-corrected one;
torch's Adam adds ``eps`` after dividing the root by the bias correction,
optax after the division. There is no schedule-free package here either, so
``schedule_free`` and ``scale_by_radam`` are optax's own rules.

A transform is ``(init(params) -> state, update(grads, state, params) ->
(updates, state))`` over dicts of name -> tensor, as an optax
``GradientTransformation`` over a pytree; ``chain`` composes them and runs
their updates where autograd does not record; ``apply_updates`` adds the
updates to the parameters in place. Step counts and the scalars made from
them (bias corrections, the radam rectifier, the schedule-free weight) are
host numbers in float32, computed as optax computes them, so a step needs
no transfer from the device; the clipping decision stays on the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

F32 = np.float32


class Transform(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple]


class MomentState(NamedTuple):
    count: int
    mu: dict
    nu: dict


class AmsgradState(NamedTuple):
    count: int
    mu: dict
    nu: dict
    nu_max: dict


class ScheduleFreeState(NamedTuple):
    b1: float
    weight_sum: float
    step_count: int
    max_lr: float
    base: Any
    z: dict


class EmaState(NamedTuple):
    ema: dict


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _clone(params: dict) -> dict:
    return {k: p.detach().clone() for k, p in params.items()}


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    @torch.no_grad()
    def update(grads, state, params):
        states = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            states.append(s)
        return grads, tuple(states)

    return Transform(init, update)


def global_norm(tree: dict) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, on the leaves' device."""
    return torch.sqrt(sum((g * g).sum() for g in tree.values()))


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale every leaf by ``max_norm / norm`` where the global norm is at
    least ``max_norm`` (the test stays on the device)."""
    def update(grads, state, params):
        norm = global_norm(grads)
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm) * max_norm)
                for k, g in grads.items()}, state

    return Transform(lambda params: (), update)


def _moments(grads, state, b1, b2):
    mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
    return mu, nu, state.count + 1


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32."""
    return float(F32(1) - F32(decay) ** F32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def update(grads, state, params):
        mu, nu, count = _moments(grads, state, b1, b2)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
               for k in grads}
        return out, MomentState(count, mu, nu)

    return Transform(lambda p: MomentState(0, _zeros(p), _zeros(p)), update)


def scale_by_amsgrad(b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8) -> Transform:
    """Adam over the running maximum of the bias-corrected second moment."""
    def update(grads, state, params):
        mu, nu, count = _moments(grads, state, b1, b2)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        nu_max = {k: torch.maximum(state.nu_max[k], nu[k] / c2)
                  for k in grads}
        out = {k: (mu[k] / c1) / (torch.sqrt(nu_max[k]) + eps)
               for k in grads}
        return out, AmsgradState(count, mu, nu, nu_max)

    return Transform(
        lambda p: AmsgradState(0, _zeros(p), _zeros(p), _zeros(p)), update)


def radam_rho(count: int, b2: float = 0.999) -> float:
    """RAdam's length of the approximated SMA at step ``count``, in float32
    as ``optax.scale_by_radam`` computes it."""
    b2t = F32(b2) ** F32(count)
    return float(F32(2.0 / (1.0 - b2) - 1.0)
                 - F32(2 * count) * b2t / (F32(1) - b2t))


def radam_rectifier(rho: float, b2: float = 0.999) -> float:
    """RAdam's variance rectification term at ``rho`` (above 4), float32."""
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    ro = F32(rho)
    return float(np.sqrt((ro - F32(4.0)) * (ro - F32(2.0)) * F32(rho_inf)
                         / (F32((rho_inf - 4.0) * (rho_inf - 2.0)) * ro)))


def scale_by_radam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   threshold: float = 5.0) -> Transform:
    """RAdam: the rectified Adam step where the variance estimate is
    tractable (``rho >= threshold``), the bias-corrected momentum before."""
    def update(grads, state, params):
        mu, nu, count = _moments(grads, state, b1, b2)
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        rho = radam_rho(count, b2)
        if rho >= threshold:
            r = radam_rectifier(rho, b2)
            out = {k: r * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                   for k in grads}
        else:
            out = {k: mu[k] / c1 for k in grads}
        return out, MomentState(count, mu, nu)

    return Transform(lambda p: MomentState(0, _zeros(p), _zeros(p)), update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params):
        return ({k: g + weight_decay * params[k] for k, g in grads.items()},
                state)

    return Transform(lambda params: (), update)


def scale(step: float) -> Transform:
    def update(grads, state, params):
        return {k: step * g for k, g in grads.items()}, state

    return Transform(lambda params: (), update)


def scale_by_schedule(step_fn: Callable[[int], float]) -> Transform:
    """Multiply by ``step_fn(count)``, count 0 at the first update."""
    def update(grads, count, params):
        step = step_fn(count)
        return {k: step * g for k, g in grads.items()}, count + 1

    return Transform(lambda params: 0, update)


def cosine_decay(init_value: float, decay_steps: int, count: int) -> float:
    """``optax.cosine_decay_schedule(init_value, decay_steps)(count)`` in
    float32 (alpha 0, exponent 1)."""
    c = F32(min(count, decay_steps))
    decay = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * c / F32(decay_steps)))
    return float(F32(init_value) * decay)


def schedule_free(base: Transform, learning_rate: float, b1: float = 0.9,
                  weight_lr_power: float = 2.0) -> Transform:
    """``optax.contrib.schedule_free``: the base optimizer (run without
    momentum) steps z; the parameters are ``y = b1 x + (1 - b1) z`` with x
    the average of the z's weighted by ``lr ** weight_lr_power``. Evaluate
    at x (``schedule_free_eval_params``)."""
    def init(params):
        return ScheduleFreeState(float(F32(b1)), 0.0, 1, 0.0,
                                 base.init(params), _clone(params))

    def update(grads, state, params):
        max_lr = max(F32(state.max_lr), F32(learning_rate))
        weight = max_lr ** F32(weight_lr_power)
        total = F32(state.weight_sum) + weight
        ck = float(weight / total)
        base_updates, base_state = base.update(grads, state.base, params)
        out, z = {}, {}
        for k, y in params.items():
            z[k] = state.z[k] + base_updates[k]
            prev_x = (y - (1.0 - b1) * state.z[k]) / b1
            x = (1.0 - ck) * prev_x + ck * z[k]
            out[k] = (b1 * x + (1.0 - b1) * z[k]) - y
        return out, ScheduleFreeState(state.b1, float(total),
                                      state.step_count + 1, float(max_lr),
                                      base_state, z)

    return Transform(init, update)


def schedule_free_eval_params(state: ScheduleFreeState,
                              params: dict) -> dict:
    """x = ``(y - (1 - b1) z) / b1``."""
    b1 = state.b1
    return {k: (y.detach() - (1.0 - b1) * state.z[k]) / b1
            for k, y in params.items()}


def ema(decay: float) -> Transform:
    """The last element of a chain: an exponential moving average of the
    parameters after the update (the JAX package's ``_ema_tail``)."""
    def update(updates, state, params):
        avg = {k: decay * state.ema[k]
               + (1.0 - decay) * (params[k].detach() + u)
               for k, u in updates.items()}
        return updates, EmaState(avg)

    return Transform(lambda params: EmaState(_clone(params)), update)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> None:
    """``p += u`` in place for every parameter."""
    for k, p in params.items():
        p.add_(updates[k])
