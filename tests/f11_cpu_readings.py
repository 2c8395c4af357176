"""What the CPU can and cannot show of F11 (``ROADMAP.md`` §3) against the
JAX package's bfloat16 training, on small widths:

  * ``layer``: one EGCL (kNN with the virtual node, and dense) on inputs
    from numpy seeds, the port on three edge statements under plain
    autograd: ``compute`` (``egcl_*_edges_compute``, the repaired
    backward's), ``reference`` (the float32 statement, the backward before
    the repair) and ``fused`` (the compute statement with torch's one-op
    SiLU and sigmoid). Each reading is the relative L2 distance from JAX's
    bfloat16 value over JAX's own bfloat16-to-float32 distance: the message
    sum, the coordinate update, and the VJP pooled over every leaf
    (``tests/test_torch_compute_statement.py`` holds seed 2).
  * ``step``: one bfloat16 train step of ``test_torch_compute_statement.
    TRAIN`` (virtual node, kNN-3) from JAX's initialisation with live
    virtual-node leaves, on JAX's batch and draws: the virtual-node
    gradients of every layer but the last (the last layer's do not pass
    through an edge function's backward) against JAX's bfloat16 step,
    pooled, for the repaired route (``port``) and the one before it
    (``as_is``), over JAX's own bfloat16-to-float32 distance.
  * ``replay``: ``tests/jax_replay_training.py``'s small-width recipe with
    ``m_size`` 64 (so the kNN edge function, not the plain route, runs)
    in bfloat16 for ``--steps`` steps, JAX's tracks in both dtypes and the
    port's two routes, read by ``vnode_group_gaps`` against JAX's float32
    track.

    JAX_PLATFORMS=cpu python tests/f11_cpu_readings.py --out build/f11.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def _pooled(got: dict, j16: dict, j32: dict, keys) -> float:
    num = sum(float(np.sum((got[k] - j16[k]) ** 2)) for k in keys)
    den = sum(float(np.sum((j16[k] - j32[k]) ** 2)) for k in keys)
    return (num / den) ** 0.5


def layer(seeds) -> list:
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_compute_statement as T
    import train_step_times
    from diffusion_model_tpu.nn.egnn import EGCL as JaxEGCL
    from diffusion_model_tpu.ops.edges import dense_pair_mask, knn_edges
    from test_torch_rbf import VNODE, live

    out = []
    for topology in ("knn", "dense"):
        for seed in seeds:
            h, x, mask = T._layer_inputs(seed)
            edges = (knn_edges(jnp.asarray(x), jnp.asarray(mask), T.K)
                     if topology == "knn"
                     else dense_pair_mask(jnp.asarray(mask)))
            params = live(JaxEGCL(**T.LAYER).init(
                jax.random.key(0), h, x, edges, mask), VNODE)
            rng = np.random.default_rng(5)
            cot = (rng.normal(size=h.shape).astype(np.float32),
                   rng.normal(size=x.shape).astype(np.float32))
            j16 = T._jax_layer(params, h, x, edges, mask, cot, jnp.bfloat16)
            j32 = T._jax_layer(params, h, x, edges, mask, cot, jnp.float32)
            rec = {"topology": topology, "seed": seed}
            for form in ("compute", "reference", "fused"):
                with train_step_times.route_context(form):
                    got = T._port_layer(
                        params, h, x, mask, topology, cot, torch.bfloat16,
                        statement="reference" if form == "reference"
                        else "compute")
                rec[form] = [T._rel(got[i], j16[i]) / T._rel(j16[i], j32[i])
                             for i in range(2)] + [
                    _pooled(got[2], j16[2], j32[2], sorted(j16[2]))]
            out.append(rec)
    return out


def step(draws) -> list:
    import jax

    import test_torch_compute_statement as T
    import torch_replay_training_full as full
    from diffusion_model_tpu.config import Config as JaxConfig
    from diffusion_model_tpu.data import split as jax_split
    from diffusion_model_tpu.train import Trainer as JaxTrainer
    from test_torch_rbf import VNODE, live
    from test_torch_trainer import port_names, tiny_data

    out = []
    for layers, seed in draws:
        jcfg = JaxConfig(**{**T.TRAIN, "L": layers})
        jb = next(jax_split.batch_iterator(tiny_data(jcfg, seed=seed), 4,
                                           jcfg.n_max, seed=1))
        params = JaxTrainer(jcfg).init_state(jax.random.key(seed), jb,
                                             skip_gamma_fit=True).params
        params = {**params, "denoiser": live(params["denoiser"], VNODE,
                                             seed=seed + 1)}
        key = jax.random.key(5 + seed)

        def jax_grads(cfg):
            trainer = JaxTrainer(cfg)
            _, g = jax.jit(jax.value_and_grad(trainer._loss, has_aux=True))(
                params, key, jb)
            return {k: np.asarray(v) for k, v in port_names(g).items()}

        j16 = jax_grads(jcfg)
        j32 = jax_grads(jcfg.replace(compute_dtype="float32"))
        keys = [k for k in j16 if ".vnode_" in k
                and f"egcl_{layers - 1}." not in k]
        rec = {"L": layers, "seed": seed}
        for route in ("port", "as_is"):
            fns = full.variant_edge_fns(route) if route == "as_is" else {}
            got = T._train_step_grads(params, jcfg, key, jb, **fns)
            rec[route] = _pooled(got, j16, j32, keys)
        out.append(rec)
    return out


def replay(steps: int) -> dict:
    import torch

    import jax_replay_training as small
    import torch_replay_training_full as full
    from diffusion_model_tpu.train import Trainer as JaxTrainer
    from diffusion_model_tpu_torch.train.trainer import Trainer
    from torch_port_fixtures import ReplayDraws, jax_loss_draws, port_batch

    jax = small._jax()
    flags = list(small.FLAGS)
    flags[flags.index("--m_size") + 1] = "64"
    jcfg, cfg, cells = small.setup(flags)
    start = jax.jit(JaxTrainer(jcfg).init_state)(
        jax.random.key(jcfg.seed), next(small.batches(jcfg, cells))).params
    base = jax.random.key(jcfg.seed)

    def jax_norms(dt):
        c = jcfg.replace(compute_dtype=dt)
        trainer = JaxTrainer(c)
        state = jax.jit(trainer.init_state)(
            jax.random.key(c.seed), next(small.batches(c, cells)))
        it = small.batches(c, cells)
        for k in range(steps):
            state, _ = trainer.train_step(state, jax.random.fold_in(base, k),
                                          next(it))
        return {k: float(np.linalg.norm(v))
                for k, v in small.port_names(state.params).items()}

    def port_norms(edge_fns):
        trainer = Trainer(cfg.replace(compute_dtype="bfloat16"),
                          device="cpu", **edge_fns)
        state = trainer.init_state(0, params=jax.tree.map(
            lambda a: np.asarray(a, np.float32), start))
        it = small.batches(jcfg, cells)
        for k in range(steps):
            jb = next(it)
            key = jax.random.fold_in(base, k)
            state, _ = trainer.train_step(state, ReplayDraws(jax_loss_draws(
                key, jcfg, jb.pos.shape[0], jcfg.n_max)), port_batch(jb))
        with torch.no_grad():
            return {k: float(v.float().norm())
                    for k, v in state.params.items()}

    ref = jax_norms("float32")
    names = sorted(ref)
    tracks = {"jax_bf16": jax_norms("bfloat16"), "port": port_norms({}),
              "as_is": port_norms(full.variant_edge_fns("as_is"))}
    return {"steps": steps, **{
        name: full.vnode_group_gaps(names, [t[n] for n in names],
                                    [ref[n] for n in names], jcfg.L)
        for name, t in tracks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="2,3,4,5,6")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE.parent), str(HERE)]
    import torch

    torch.set_num_threads(4)
    seeds = [int(s) for s in args.seeds.split(",")]
    rec = {"layer": layer(seeds),
           "step": step([(2, s) for s in range(4)] + [(3, s)
                                                       for s in range(4)]),
           "replay": replay(args.steps)}
    print(json.dumps(rec))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
