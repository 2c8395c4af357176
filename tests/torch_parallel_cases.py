"""The ranks' side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_ring.py``: each function runs on every rank of a
``torch.distributed`` world that ``parallel.launch`` spawned (gloo, CPU),
runs every case of its test module and writes what the tests read to
``out_dir`` (``<case>.npz`` from the first rank, or ``<case>_r<rank>.npz``
per rank). The processes import the port, torch and numpy, never JAX: the
JAX package's side of each comparison is computed by the test itself and
handed in as numpy (``spec``)."""

from __future__ import annotations

import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from diffusion_model_tpu_torch import api, parallel
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion.process import predefined_schedule
from diffusion_model_tpu_torch.diffusion.sampler import sample
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.parallel import ring
from diffusion_model_tpu_torch.train.checkpoint import state_dict_from_flax
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer
from torch_port_fixtures import ReplayDraws

FIELDS = ("pos", "species", "spectrum", "exo", "mask")


def as_batch(arrays: dict) -> GraphBatch:
    return GraphBatch(**{k: torch.from_numpy(np.asarray(arrays[k],
                                                        np.float32))
                         for k in FIELDS})


def batch_arrays(batch: GraphBatch) -> dict:
    return {k: getattr(batch, k).numpy() for k in FIELDS}


def _save(out_dir: str, name: str, **arrays) -> None:
    np.savez(os.path.join(out_dir, name + ".npz"), **arrays)


def _params(state) -> dict:
    return {k: p.detach().numpy() for k, p in state.params.items()}


def _raised(fn) -> str:
    """The message of the exception ``fn()`` raises ('' if none)."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _guarded(fn, rank: int, out_dir: str, *args) -> None:
    """``fn(*args)``; a failure is written to ``error_r<rank>.txt`` (a
    spawned rank's traceback is otherwise only on its stderr)."""
    try:
        fn(*args)
    except Exception:
        with open(os.path.join(out_dir, f"error_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# -- data parallelism --------------------------------------------------------

def dp_cases(rank: int, out_dir: str, spec: dict) -> None:
    _guarded(_dp_cases, rank, out_dir, rank, out_dir, spec)


def _dp_cases(rank: int, out_dir: str, spec: dict) -> None:
    mesh = parallel.make_mesh()
    world = mesh.size

    # shard_graph_batch's modes
    batch = as_batch(spec["shard_batch"])
    for mode in ("dp", "node"):
        _save(out_dir, f"shard_{mode}_r{rank}", **batch_arrays(
            parallel.shard_graph_batch(batch, mesh, mode)))
    messages = {"flat_dp_node": _raised(
        lambda: parallel.shard_graph_batch(batch, mesh, "dp_node"))}
    if world == 4:
        hybrid = parallel.make_hybrid_mesh(2)
        for mode in ("dp", "dp_node"):
            _save(out_dir, f"shard_hybrid_{mode}_r{rank}", **batch_arrays(
                parallel.shard_graph_batch(batch, hybrid, mode)))
    if rank == 0:
        with open(os.path.join(out_dir, "messages.json"), "w") as f:
            json.dump(messages, f)

    # a data-parallel step against the one-process step
    for name, cfg, arrays, seed in spec["steps"]:
        trainer = Trainer(cfg, device="cpu")
        state = trainer.replicate(trainer.init_state(0), mesh)
        state, m = trainer.train_step(state, TrainNoise(seed, "cpu"),
                                      as_batch(arrays), mesh)
        if rank == 0:
            _save(out_dir, f"step_{name}", loss=m["loss"].numpy(),
                  sum_sq=m["sum_sq"].numpy(), **_params(state))

    # the same step from the JAX package's parameters on its draws
    cfg, tree, arrays, draws = spec["jax_step"]
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=tree)
    state, m = trainer.train_step(state, ReplayDraws(draws), as_batch(arrays),
                                  mesh)
    if rank == 0:
        _save(out_dir, "jax_step", loss=m["loss"].numpy(), **_params(state))

    # api.train: 5 epochs, and 3 then resumed to 5
    if "train" in spec:
        cfg, data, run_dirs, epochs = spec["train"]
        cfg = cfg.replace(mesh_shape=(world,))
        api.train(cfg, data, run_dirs[0], num_epochs=epochs, device="cpu")
        api.train(cfg, data, run_dirs[1], num_epochs=epochs - 2,
                  device="cpu")
        _, state, _ = api.train(cfg, data, run_dirs[1], num_epochs=epochs,
                                device="cpu", resume=True)
        _save(out_dir, f"train_r{rank}", **_params(state))


# -- the ring ----------------------------------------------------------------

def _model(cfg: Config, tree: dict) -> DiffusionDenoiser:
    model = DiffusionDenoiser(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(tree))
    return model


def _summed_grads(model, loss) -> dict:
    names = [k for k, _ in model.named_parameters()]
    parts = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(model.parameters(), parts)]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    out, at = {}, 0
    for k, g in zip(names, grads):
        out[k] = flat[at:at + g.numel()].view(g.shape).numpy()
        at += g.numel()
    return out


def ring_cases(rank: int, out_dir: str, spec: dict) -> None:
    _guarded(_ring_cases, rank, out_dir, rank, out_dir, spec)


def _ring_cases(rank: int, out_dir: str, spec: dict) -> None:
    mesh = parallel.make_mesh()
    world = mesh.size

    # forwards (ring_denoise_fn gathers the blocks)
    for name, cfg, tree, args in spec["forwards"]:
        model = _model(cfg, tree).requires_grad_(False)
        fn = ring.ring_denoise_fn(cfg, model, mesh)
        with torch.no_grad():
            ex, eh = fn(*(torch.from_numpy(a) for a in args))
        if rank == 0:
            _save(out_dir, f"forward_{name}", eps_x=ex.numpy(),
                  eps_h=eh.numpy())

    # parameter gradients of a fixed contraction of the outputs
    for name, cfg, tree, args, (tx, th) in spec["grads"]:
        model = _model(cfg, tree)
        ex, eh = ring.ring_denoise_apply(cfg, mesh)(
            model, *(torch.from_numpy(a) for a in args))
        n = args[1].shape[0]
        blk = slice(rank * n // world, (rank + 1) * n // world)
        loss = ((ex * torch.from_numpy(tx)[blk]).sum()
                + (eh * torch.from_numpy(th)[blk]).sum())
        grads = _summed_grads(model, loss)
        if rank == 0:
            _save(out_dir, f"grads_{name}", **grads)

    # ring train steps (Trainer.ring_train_step_fn)
    for name, cfg, arrays, seeds in spec["train_steps"]:
        trainer = Trainer(cfg, device="cpu")
        step = trainer.ring_train_step_fn(mesh)
        for seed in seeds:
            state = trainer.init_state(0)
            state, m = step(state, TrainNoise(seed, "cpu"), as_batch(arrays))
            if rank == 0:
                _save(out_dir, f"train_{name}_{seed}",
                      loss=m["loss"].numpy(), **_params(state))
    cfg, arrays = spec["train_b2"]
    messages = {"train_b2": _raised(lambda: Trainer(
        cfg, device="cpu").ring_train_step_fn(mesh)(
            Trainer(cfg, device="cpu").init_state(0), TrainNoise(0, "cpu"),
            as_batch(arrays)))}

    # the unchanged sampler through the ring
    cfg, tree, arrays, seed = spec["sampler"]
    model = _model(cfg, tree).requires_grad_(False)
    fn = ring.ring_sampler_denoise_fn(cfg, model, mesh)
    res = sample(fn, predefined_schedule(cfg, device="cpu"), cfg,
                 torch.Generator().manual_seed(seed), as_batch(arrays))
    if rank == 0:
        _save(out_dir, "sampler", pos=res.pos.numpy(), h=res.h.numpy(),
              finite=res.finite.numpy())
    b2 = {k: np.concatenate([a, a]) for k, a in arrays.items()}
    t2 = torch.full((2, cfg.n_max, 1), 0.4)
    bb = as_batch(b2)
    messages["sampler_b2"] = _raised(lambda: fn(
        bb.species, bb.pos, bb.spectrum, bb.exo, t2, bb.mask, None))

    # a graph whose node count does not split over the ring
    cfg, tree, args = spec["indivisible"]
    model = _model(cfg, tree).requires_grad_(False)
    messages["indivisible"] = _raised(lambda: ring.ring_denoise_fn(
        cfg, model, mesh)(*(torch.from_numpy(a) for a in args)))

    # api.generate_ring, and the CLI's --ring
    cfg, tree, graphs = spec["generate"]
    out = api.generate_ring(cfg, tree, graphs, device="cpu")
    if rank == 0:
        _save(out_dir, "generate_ring", ids=np.asarray(out["ids"]),
              **{k: v for k, v in out.items() if k != "ids"})
    from diffusion_model_tpu_torch.cli import generate_amorphous

    generate_amorphous.main(spec["cli"])
    if rank == 0:
        with open(os.path.join(out_dir, "messages.json"), "w") as f:
            json.dump(messages, f)
