"""Replayed training of the large-cell recipe: the JAX package's trainer and
the port's, from the same initialisation on the same batches and draws, on
the CPU in float32, compared step by step.

    JAX_PLATFORMS=cpu python tests/jax_replay_training.py
    JAX_PLATFORMS=cpu python tests/jax_replay_training.py --steps 20 \\
        --out build/train_replay_trial.json

The recipe is the ``h_residual+virtual_node`` arm of
``docs/quality/size192net_lever_sweep.json`` as ``evals/size_gen_check.py``
``recipe`` sets it (kNN-32, ``h_residual``, ``virtual_node``,
``h_init_scale`` 1e-3, schedule-free RAdam at lr 2e-4, clip 1, the
predefined schedule, 1000 timesteps), at small widths (``FLAGS``: L=5,
64-wide MLPs, m 32) and in float32, on eight network cells of 40-48
atoms, batch 4. Both packages start from the JAX package's initialisation
(``Trainer.init_state(jax.random.key(seed), .)``; the port holds the same
tree). Step k takes the JAX package's batch (``data.split.batch_iterator``,
seed ``cfg.seed + epoch`` as ``api.train`` orders an epoch) and the draws of
the key ``fold_in(key(seed), k)``, which the port receives through
``torch_port_fixtures.ReplayDraws`` / ``jax_loss_draws``.

Recorded in ``tests/fixtures/torch_port/train_replay_hres_vn.json``:

  * each package's loss and gradient norm at every step, and the L2 norm of
    the parameter gap after it;
  * every ``GAP_EVERY`` steps the largest leaf gap of the parameters
    (absolute, and relative to the JAX leaf's largest entry);
  * the same gaps of the final eval parameters (the schedule-free average).

``tests/test_torch_train_replay.py`` replays the first steps live against
this file and holds its whole track to the drift bound ``drift_bounds``
states. Cost: about 1.5 min on an 8-core CPU for 200 steps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / \
    "train_replay_hres_vn.json"
FLAGS = ["--generator", "network", "--train_cells", "8", "--train_min",
         "40", "--train_max", "48", "--neighbor_k", "32", "--L", "5",
         "--hidden", "64", "--m_size", "32", "--batch_size", "4",
         "--h_init_scale", "1e-3", "--h_residual", "--virtual_node",
         "--cell_cache", ""]
STEPS = 200
GAP_EVERY = 20
# the one-step tolerances of tests/test_torch_size_gen_check.py
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-3


def drift_bounds(step: int, lr: float, b1: float = 0.9,
                 b2: float = 0.999) -> dict:
    """How far float32 rounding alone may move the two tracks apart after
    ``step`` updates, from the one-step tolerances.

    A gradient leaf that agrees to ``GRAD_RTOL`` gives an update that
    agrees to ``GRAD_RTOL`` of its own size; clipping to a global norm can
    double that (the norm moves too). RAdam's update of an entry is at most
    ``(1 - b1) / sqrt(1 - b2)`` (its normalised step) or, while rectification
    is off, the clipped momentum, at most 1; schedule-free moves the
    gradient's point ``y`` and the average ``x`` by at most the base step
    times ``lr``. So after k steps each parameter entry lies within
    ``k * lr * 2 * GRAD_RTOL * (1 - b1) / sqrt(1 - b2)`` of JAX's
    (``param_abs``). The loss at the same draws then moves by at most its
    own rounding plus the first-order term: ``LOSS_RTOL * |loss| +
    grad_norm * ||param gap||_2``, with the measured gap
    (``loss_bound``)."""
    base = max(1.0, (1 - b1) / (1 - b2) ** 0.5)
    return {"param_abs": step * lr * 2 * GRAD_RTOL * base}


def loss_bound(loss: float, grad_norm: float, l2_gap: float) -> float:
    """The loss's drift bound at one step (``drift_bounds``)."""
    return LOSS_RTOL * abs(loss) + grad_norm * l2_gap


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def setup(flags=FLAGS):
    """(JAX config, port config, the train cells)."""
    from diffusion_model_tpu.config import Config as JaxConfig
    from diffusion_model_tpu_torch.config import from_dict
    from diffusion_model_tpu_torch.evals import size_gen_check

    args = size_gen_check.parser().parse_args(flags)
    cfg = size_gen_check.recipe(args).replace(compute_dtype="float32")
    jcfg = JaxConfig(**cfg.to_dict())
    assert from_dict(jcfg.to_dict()) == cfg
    cells = size_gen_check.train_cells(
        args, cfg, size_gen_check.cell_maker(args, cfg.spectrum_size))
    return jcfg, cfg, cells


def batches(jcfg, cells):
    """The JAX package's batches, epoch after epoch."""
    from diffusion_model_tpu.data import split as jax_split

    epoch = 0
    while True:
        yield from jax_split.batch_iterator(cells, jcfg.batch_size,
                                            jcfg.n_max,
                                            seed=jcfg.seed + epoch)
        epoch += 1


def port_names(tree: dict) -> dict:
    """A JAX params tree's denoiser leaves by the port's names (numpy)."""
    from diffusion_model_tpu_torch.train.checkpoint import (
        state_dict_from_flax,
    )

    jax = _jax()
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return {f"denoiser.{k}": v.numpy()
            for k, v in state_dict_from_flax(tree).items()}


def gaps(port: dict, jax_tree: dict) -> dict:
    """The largest leaf gap (absolute and relative to the JAX leaf's
    largest entry), the leaf it is in, and the L2 norm of the whole gap."""
    want = port_names(jax_tree)
    assert sorted(want) == sorted(port)
    worst_abs, worst_rel, total = (0.0, ""), (0.0, ""), 0.0
    for k, w in want.items():
        d = np.abs(port[k].detach().cpu().numpy().astype(np.float64) - w)
        total += float((d * d).sum())
        a = float(d.max())
        r = a / max(float(np.abs(w).max()), 1e-30)
        worst_abs = max(worst_abs, (a, k))
        worst_rel = max(worst_rel, (r, k))
    return {"max_abs": worst_abs[0], "max_abs_leaf": worst_abs[1],
            "max_rel": worst_rel[0], "max_rel_leaf": worst_rel[1],
            "l2": total ** 0.5}


def replay(steps: int, gap_every: int = GAP_EVERY, flags=FLAGS,
           log=None) -> dict:
    """Both trainers ``steps`` steps; the record described above."""
    import torch

    from diffusion_model_tpu.train import Trainer as JaxTrainer
    from diffusion_model_tpu_torch.train.trainer import Trainer
    from torch_port_fixtures import ReplayDraws, jax_loss_draws, port_batch

    jax = _jax()
    jcfg, cfg, cells = setup(flags)
    it = batches(jcfg, cells)
    first = next(it)
    it = batches(jcfg, cells)
    jtrainer = JaxTrainer(jcfg)
    # jitted: the same values as the eager init, in half its time
    jstate = jax.jit(jtrainer.init_state)(jax.random.key(cfg.seed), first)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=jax.tree.map(
        lambda a: np.asarray(a, np.float32), jstate.params))
    base = jax.random.key(cfg.seed)
    rec = {"loss_jax": [], "loss_port": [], "grad_norm_jax": [],
           "grad_norm_port": [], "param_l2_gap": [], "leaf_gaps": []}
    t0 = time.perf_counter()
    for k in range(steps):
        jb = next(it)
        key = jax.random.fold_in(base, k)
        jstate, jm = jtrainer.train_step(jstate, key, jb)
        draws = jax_loss_draws(key, jcfg, jb.pos.shape[0], jcfg.n_max)
        state, m = trainer.train_step(state, ReplayDraws(draws),
                                      port_batch(jb))
        g = gaps(state.params, jstate.params)
        rec["loss_jax"].append(float(jm["loss"]))
        rec["loss_port"].append(float(m["loss"]))
        rec["grad_norm_jax"].append(float(jm["grad_norm"]))
        rec["grad_norm_port"].append(float(m["grad_norm"]))
        rec["param_l2_gap"].append(g["l2"])
        if (k + 1) % gap_every == 0 or k + 1 == steps:
            rec["leaf_gaps"].append({"step": k + 1, **g})
            if log:
                log(f"step {k + 1}: loss {rec['loss_jax'][-1]:.6f} / "
                    f"{rec['loss_port'][-1]:.6f}, largest leaf gap "
                    f"{g['max_abs']:.3e} ({g['max_rel']:.3e} relative), "
                    f"{time.perf_counter() - t0:.0f} s")
    with torch.no_grad():
        rec["eval_params_gap"] = gaps(state.eval_params(cfg),
                                      jstate.eval_params(jcfg))
    rec["seconds"] = time.perf_counter() - t0
    return {"recipe": "h_residual+virtual_node", "flags": list(flags),
            "compute_dtype": cfg.compute_dtype, "steps": steps,
            "gap_every": gap_every, "lr": cfg.lr,
            "max_grad_norm": cfg.max_grad_norm,
            "optimizer": cfg.optimizer, "neighbor_k": cfg.neighbor_k,
            "cells": len(cells), "batch_size": cfg.batch_size,
            "n_max": cfg.n_max, **rec}


def verdict(rec: dict) -> dict:
    """The track against ``drift_bounds``: every recorded leaf gap within
    ``param_abs`` at its step, every step's loss gap within its bound."""
    params_within = all(
        r["max_abs"] <= drift_bounds(r["step"], rec["lr"])["param_abs"]
        for r in rec["leaf_gaps"])
    # step k's loss is taken at the parameters after step k - 1
    before = [0.0] + rec["param_l2_gap"][:-1]
    loss_off = [k for k, (a, b, gn, l2) in enumerate(zip(
        rec["loss_jax"], rec["loss_port"], rec["grad_norm_jax"], before))
        if abs(a - b) > loss_bound(a, gn, l2)]
    return {"params_within_drift": params_within,
            "loss_steps_off": loss_off,
            "held": params_within and not loss_off}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--out", default=str(FIXTURE))
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO / "tests"))
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    rec = replay(args.steps, log=lambda s: print(s, flush=True))
    rec["verdict"] = verdict(rec)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"out": args.out, **rec["verdict"],
                      "eval_params_gap": rec["eval_params_gap"],
                      "seconds": rec["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
