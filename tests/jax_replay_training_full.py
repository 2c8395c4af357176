"""Replayed training of the large-cell recipe at full width, the JAX side:
the JAX package's trainer in float32 and in bfloat16 for 150 steps from one
numpy start, on the same batches and draws, on the CPU. The port's side is
``tests/torch_replay_training_full.py``, which reads what this writes and
imports no JAX.

    JAX_PLATFORMS=cpu python tests/jax_replay_training_full.py
    JAX_PLATFORMS=cpu python tests/jax_replay_training_full.py --steps 2 \\
        --out build/train_replay_full_trial

The recipe is the ``h_residual+virtual_node`` arm of
``docs/quality/size192net_lever_sweep.json`` at its own widths
(``torch_replay_training_full.FLAGS``: kNN-32, L=5, 1024-wide MLPs, m 256,
``h_init_scale`` 1e-3, ``h_residual``, ``virtual_node``, schedule-free RAdam
at lr 2e-4, clip 1), on eight network cells of 160-192 atoms at batch 4.
Both tracks start from ``numpy_start`` (each leaf a seeded numpy normal with
the standard deviation of that leaf in ``Trainer.init_state``, a constant
leaf kept). Step k takes the JAX package's batch (``data.split.
batch_iterator``, seed ``cfg.seed + epoch``; the port's batch is checked to
be the same) and the draws of ``fold_in(key(cfg.seed), k)``.

Recorded in ``tests/fixtures/torch_port/train_replay_full_hres_vn.json`` and
``.npz``: the leaf specification of the start and its checksum, the cells'
checksums and each step's batch, the draws, each track's loss and gradient
norm at every step, and at steps 1, 10, 20, ..., 150 each track's
``Sketch`` (leaf norms and seeded Gaussian projections of the distance from
the start), with the exact L2 gap between the two tracks (whole tree and
each leaf) beside the sketch's estimate of it.

Cost: about 40 min on an 8-core CPU (5-7 s a bfloat16 step and ~5 s a
float32 step, ~10 s a sketch).
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
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO))

import torch_replay_training_full as full  # noqa: E402


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def start_spec(jcfg, example) -> list:
    """Each denoiser leaf of the JAX package's ``init_state`` at
    ``key(cfg.seed)``: its path under ``params``, shape and standard
    deviation, and its value where the leaf is constant."""
    from diffusion_model_tpu.train import Trainer as JaxTrainer
    from torch_port_fixtures import flat_leaves

    jax = _jax()
    trainer = JaxTrainer(jcfg)
    state = jax.jit(trainer.init_state)(jax.random.key(jcfg.seed), example)
    leaves = flat_leaves(jax.tree.map(np.asarray,
                                      state.params["denoiser"]["params"]))
    spec = []
    for path in sorted(leaves):
        a = np.asarray(leaves[path], np.float64)
        const = float(a.flat[0]) if np.all(a == a.flat[0]) else None
        spec.append({"path": path, "shape": list(a.shape),
                     "std": float(a.std()), "const": const})
    return spec


def replay(steps: int, log=None) -> tuple:
    """Both JAX tracks ``steps`` steps: (the record's JSON, its arrays)."""
    import jax.numpy as jnp

    from diffusion_model_tpu.config import Config as JaxConfig
    from diffusion_model_tpu.train import Trainer as JaxTrainer
    from diffusion_model_tpu.train.trainer import TrainState
    from jax_replay_training import batches
    from torch_port_fixtures import jax_loss_draws

    jax = _jax()
    cfg, cells = full.setup()
    jcfg = {d: JaxConfig(**cfg.replace(compute_dtype=d).to_dict())
            for d in full.TRACKS}
    first = next(batches(jcfg["float32"], cells))
    spec = start_spec(jcfg["float32"], first)
    start_tree = full.numpy_start(spec, full.START_SEED)
    start = full.port_leaves(start_tree)
    names = sorted(start)
    sketch = full.Sketch(start, full.SKETCH_SEED, full.SKETCH_K)
    trainers = {d: JaxTrainer(jcfg[d]) for d in full.TRACKS}
    states = {}
    for d, t in trainers.items():
        params = jax.tree.map(jnp.asarray, start_tree)
        states[d] = TrainState(params=params,
                               opt_state=t.optimizer.init(params),
                               step=jnp.zeros((), jnp.int32))
    records = full.record_steps(steps)
    order = full.batch_indices(cfg, len(cells), steps)
    it, port_it = batches(jcfg["float32"], cells), full.port_batches(
        cfg, cells)
    base = jax.random.key(cfg.seed)
    tracks = {d: {"loss": [], "grad_norm": []} for d in full.TRACKS}
    arrays = {"batches": order, "sketch_head": sketch.head()}
    draws, jax_gap = {}, []
    t0 = time.perf_counter()
    for k in range(steps):
        jb, pb = next(it), next(port_it)
        for f in ("pos", "species", "spectrum", "exo", "mask"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jb, f), np.float32),
                getattr(pb, f).numpy(), err_msg=f"step {k + 1} batch {f}")
        key = jax.random.fold_in(base, k)
        for name, v in jax_loss_draws(key, jcfg["float32"],
                                      jb.pos.shape[0], cfg.n_max).items():
            draws.setdefault(name, []).append(v[0])
        for d, t in trainers.items():
            states[d], m = t.train_step(states[d], key, jb)
            tracks[d]["loss"].append(float(m["loss"]))
            tracks[d]["grad_norm"].append(float(m["grad_norm"]))
        if k + 1 in records:
            leaves = {d: full.port_leaves(jax.tree.map(np.asarray,
                                                       states[d].params))
                      for d in full.TRACKS}
            s = {d: sketch(leaves[d]) for d in full.TRACKS}
            for d in full.TRACKS:
                arrays.update(full.sketch_arrays(f"{d}_{k + 1}", s[d]))
            exact = full.exact_gap(leaves["bfloat16"], leaves["float32"])
            est = sketch.gap(s["bfloat16"], s["float32"])
            jax_gap.append({"step": k + 1, "exact": exact,
                            "sketch": {"tree": est["tree"],
                                       "top": est["top"]}})
            if log:
                log(f"step {k + 1}: loss f32 {tracks['float32']['loss'][-1]:.6f}"
                    f" bf16 {tracks['bfloat16']['loss'][-1]:.6f}; bf16-f32 "
                    f"gap {exact['tree']:.4e} (sketch {est['tree']:.4e}), "
                    f"{time.perf_counter() - t0:.0f} s")
    arrays.update({f"draw_{n}": np.stack(v) for n, v in draws.items()})
    meta = {
        "recipe": "h_residual+virtual_node", "flags": full.FLAGS,
        "steps": steps, "records": records, "lr": cfg.lr,
        "max_grad_norm": cfg.max_grad_norm, "optimizer": cfg.optimizer,
        "neighbor_k": cfg.neighbor_k, "batch_size": cfg.batch_size,
        "n_max": cfg.n_max, "hidden": cfg.m_hidden_size, "L": cfg.L,
        "m_size": cfg.m_size,
        "parameters": int(sum(v.size for v in start.values())),
        "cells": full.cell_checksum(cells),
        "start": {"seed": full.START_SEED, "spec": spec,
                  "checksum": [float(start[n].astype(np.float64).sum())
                               for n in names]},
        "sketch": {"seed": full.SKETCH_SEED, "k": full.SKETCH_K,
                   "k_small": full.SKETCH_K_SMALL, "names": names,
                   "top": sketch.top},
        "tracks": tracks, "jax_gap": jax_gap,
        "jax": jax.__version__, "seconds": time.perf_counter() - t0}
    return meta, arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=full.STEPS)
    p.add_argument("--out", default=str(full.FIXTURE),
                   help="path of the record without its .json / .npz")
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    meta, arrays = replay(args.steps, log=lambda s: print(s, flush=True))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(f"{args.out}.npz", **arrays)
    with open(f"{args.out}.json", "w") as f:
        json.dump(meta, f, indent=1)
    last = meta["jax_gap"][-1]
    print(json.dumps({"out": args.out, "step": last["step"],
                      "bf16_f32_gap": last["exact"]["tree"],
                      "sketch": last["sketch"]["tree"],
                      "seconds": meta["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
