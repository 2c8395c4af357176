"""Library surface of the port: training, resume and reload, conditional
generation from a snapshot or a run, and the run's evaluation.

    trainer, state, (train, val, test) = train(cfg, graphs, run_dir)
    # run_dir/checkpoints/<epoch>/: the full state every checkpoint_every
    # epochs and at the end; run_dir/params.npz: the eval parameters, as the
    # JAX package saves them; run_dir/metrics.jsonl, config.json (RunLogger);
    # run_dir/profile.json: seconds per phase (utils.profiling.PhaseTimer)
    train(cfg, graphs, run_dir, resume=True)   # on from the newest epoch
    trainer, state = load_trained(run_dir, cfg)
    out = generate(cfg, params_tree(state.eval_params(cfg)), test)
    out = generate_ring(cfg, params_tree(state.eval_params(cfg)), test)
                                    # one graph a call through the ring
    evaluate(out, run_dir)          # sorted RMSD, O density, figures
    student_cfg, student = distill(cfg, trainer, state, train, 125)
    out = generate(student_cfg, params_tree(student.eval_params(student_cfg)),
                   test)            # the 125-step deterministic student

    cfg = load_config_npz(path)
    params = load_params_npz(path)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    out = generate(cfg, params, test_graphs, gen)

The noise schedule is the config's (``schedule_for``): the polynomial table,
or for ``noise_schedule="learned"`` the table of the snapshot's own gamma
network (``params["gamma"]``).

``train`` is data-parallel over a ``parallel.Mesh`` (``mesh=`` or
``cfg.mesh_shape``) in an initialised ``torch.distributed`` world, and
``generate_ring`` samples one graph a call with its node axis split over
the world's ranks (``parallel.ring``).

``generate`` follows ``diffusion_model_tpu.api.generate``: conditions are
collated in chunks of ``batch_size`` (the final chunk padded with copies of
its last condition and trimmed after sampling, so every chunk has one
shape), each tiled ``gen_num_per_spectrum`` times with the copies adjacent,
and sampled with NaN retry. With ``cfg.neighbor_k`` set, every denoiser call
runs over the kNN lists of the current positions (``knn_edge_fn``, the kNN
kernel on the card); otherwise over the dense pair grid (``edge_fn``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.split import (
    batch_iterator,
    device_batch_iterator,
    split_dataset,
)
from diffusion_model_tpu_torch.data.xyz import write_xyz_overlay
from diffusion_model_tpu_torch.diffusion.process import (
    Schedule,
    learned_schedule,
    predefined_schedule,
)
from diffusion_model_tpu_torch.diffusion.sampler import (
    NoiseSource,
    sample_with_retry,
    tile_batch,
)
from diffusion_model_tpu_torch.evals.density import (
    density_accuracy,
    o_density,
)
from diffusion_model_tpu_torch.evals.rmsd import evaluate_by_rmsd
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.gamma import GammaNetwork
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges
from diffusion_model_tpu_torch.ops.schedules import linspace_f32
from diffusion_model_tpu_torch.parallel.mesh import NO_WORLD, make_mesh
from diffusion_model_tpu_torch.train.checkpoint import (
    gamma_state_dict_from_flax,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    save_params_npz,
    state_dict_from_flax,
)
from diffusion_model_tpu_torch.train.distill import (
    DistillDraws,
    progressive_distill,
)
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import (
    EarlyStopping,
    Trainer,
    TrainState,
    params_tree,
)
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger
from diffusion_model_tpu_torch.utils.profiling import PhaseTimer

MAX_NAN_RECOVERIES = 10


def prepare_dataset(graphs: list, cfg: Config) -> list:
    """Spectra cut to ``spectrum_size``; single-atom graphs dropped."""
    out = []
    for g in graphs:
        if np.asarray(g["pos"]).shape[0] <= 1:
            continue
        g = dict(g)
        g["spectrum"] = np.asarray(g["spectrum"])[:, : cfg.spectrum_size]
        out.append(g)
    return out


def fit_n_max(graphs: list, multiple: int = 8) -> int:
    """Smallest padding size covering the dataset, rounded up to
    ``multiple``."""
    biggest = max(np.asarray(g["pos"]).shape[0] for g in graphs)
    return int(-(-biggest // multiple) * multiple)


def _device(device, what: str) -> torch.device:
    """``device``, by default the card; raises when there is no card and
    the caller did not ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the card and finds none; "
                           "pass device='cpu' to run on the CPU")
    return device


def train(cfg: Config, dataset: list, run_dir: str,
          logger: Optional[RunLogger] = None,
          num_epochs: Optional[int] = None, device=None,
          noise: Optional[Callable[[int, str], object]] = None,
          resume: bool = False, init_params_from: Optional[str] = None,
          mesh=None):
    """Train, as ``diffusion_model_tpu.api.train``: the dataset prepared
    and split 80/10/10 by ``cfg.seed``, collated once onto the device, then
    per epoch the train batches in the order of seed ``cfg.seed + epoch``
    and the validation batches in order. A non-finite epoch rolls back to
    the last good state (at most ``MAX_NAN_RECOVERIES`` times);
    ``EarlyStopping(cfg.patience)`` ends the run. Each epoch's losses and
    seconds go through ``logger`` (default ``RunLogger(run_dir, cfg)``) to
    ``run_dir/metrics.jsonl``; the full state goes to
    ``run_dir/checkpoints/<epochs done>/`` after every epoch with
    ``(epoch + 1) % cfg.checkpoint_every == 0`` and at the end (again where
    that epoch was just saved, as the JAX package does); the eval
    parameters to ``run_dir/params.npz`` (float16, config embedded) at the
    end; and the wall-clock seconds of the phases ``train_epoch`` (every
    epoch, a rolled-back one too), ``eval_epoch`` (every kept epoch) and
    ``checkpoint`` (every save) to ``run_dir/profile.json``
    (``utils.profiling.PhaseTimer.report``), as the JAX package writes it.

    ``resume=True`` restores the newest checkpoint of ``run_dir`` and goes
    on from its epoch. An epoch's batch order and its noise streams depend
    on the epoch alone, so a resumed run equals the uninterrupted run bit
    for bit (the JAX package restarts its key chain on resume). What is not
    checkpointed, in JAX neither: ``EarlyStopping``'s count, which restarts,
    and the rollback's last good state, which is the restored one.

    ``init_params_from``: a run directory whose newest checkpoint's eval
    parameters start this run, with a fresh optimizer state at epoch 0; a
    checkpoint already in ``run_dir`` wins over it when ``resume=True``.

    Runs on the card unless ``device`` names the CPU; the card's kernels
    fail loudly, never falling back. ``noise(epoch, "train" | "eval")``
    gives an epoch's noise source (default ``TrainNoise`` streams seeded
    from ``cfg.seed``, the epoch and the phase). ``cfg.debug_nans`` raises
    on a non-finite step instead of rolling back (``Trainer``).

    With ``mesh`` (a ``parallel.Mesh``), or ``cfg.mesh_shape`` set (a mesh
    of that shape and ``cfg.mesh_axis_names`` over the world, whose size
    must be its product), training is data-parallel: every rank of an
    initialised ``torch.distributed`` world calls ``train`` alike (on its
    own ``device``), the state is replicated from the first rank, each
    step's global batch is split over the mesh (``Trainer.train_step(...,
    mesh=)``), and the first rank alone writes ``metrics.jsonl``, the
    checkpoints, ``params.npz`` and ``profile.json``. Without a process
    group it raises, saying how to start one. A step equals the
    one-process step up to the order of the sums, so the run does too.

    Returns ``(trainer, state, (train_set, val_set, test_set))``.
    """
    device = _device(device, "api.train")
    if mesh is None and len(cfg.mesh_shape) > 0:
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh_shape={tuple(cfg.mesh_shape)}: api.train {NO_WORLD}, "
                "and every rank calls api.train")
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
    writer = mesh is None or dist.get_rank() == 0
    if mesh is not None and mesh.size != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size} ranks in a world of "
                         f"{dist.get_world_size()}: api.train needs them "
                         "equal")
    if noise is None:
        def noise(epoch, phase):
            return TrainNoise((cfg.seed, epoch, int(phase == "eval")),
                              device)
    if not writer:
        logger = _Silent()
    logger = logger or RunLogger(run_dir, cfg)
    dataset = prepare_dataset(dataset, cfg)
    train_set, val_set, test_set = split_dataset(dataset, cfg.seed)
    trainer = Trainer(cfg, device=device)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    newest = latest_step(ckpt_dir) if resume else None
    start_epoch, state = newest or 0, None
    if newest is not None:
        state, _ = restore_checkpoint(ckpt_dir, trainer, newest)
    elif init_params_from:
        src, src_cfg = restore_checkpoint(
            os.path.join(init_params_from, "checkpoints"), trainer)
        params = src.eval_params(src_cfg)
        state = trainer.init_state(cfg.seed, skip_gamma_fit=True)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(params[k])
        state = TrainState(state.params, trainer.optimizer.init(state.params))
        logger.log({"init_params_from": init_params_from,
                    "source_step": src.step})
    if state is None:
        state = trainer.init_state(cfg.seed)
    if mesh is not None:
        state = trainer.replicate(state, mesh)
    stopper = EarlyStopping(patience=cfg.patience)
    timer = PhaseTimer()
    epochs = cfg.num_epochs if num_epochs is None else num_epochs
    nan_recoveries = 0
    good = state.clone()
    train_data = collate(train_set, cfg.n_max, device)
    val_data = collate(val_set, cfg.n_max, device) if val_set else None
    done = start_epoch
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        batches = device_batch_iterator(train_data, cfg.batch_size,
                                        seed=cfg.seed + epoch)
        with timer.phase("train_epoch"):
            state, train_loss = trainer.train_epoch(
                state, noise(epoch, "train"), batches, mesh)
        done = epoch + 1
        if not np.isfinite(train_loss):
            nan_recoveries += 1
            logger.log({"nan_recovery": nan_recoveries}, step=epoch)
            if nan_recoveries > MAX_NAN_RECOVERIES:
                raise RuntimeError(
                    f"training diverged: {MAX_NAN_RECOVERIES} non-finite "
                    "epochs")
            state = trainer.restore(state, good)
            continue
        good = state.clone()
        val_batches = (device_batch_iterator(val_data, cfg.batch_size)
                       if val_data is not None else iter(()))
        with timer.phase("eval_epoch"):
            eval_loss = trainer.eval_epoch(state, noise(epoch, "eval"),
                                           val_batches, mesh)
        logger.log({"train_loss": train_loss, "eval_loss": eval_loss,
                    "epoch_s": time.perf_counter() - t0}, step=epoch)
        if (writer and cfg.checkpoint_every
                and done % cfg.checkpoint_every == 0):
            with timer.phase("checkpoint"):
                save_checkpoint(ckpt_dir, state, cfg, step=done)
        if stopper.validate(eval_loss):
            break
    if writer:
        with timer.phase("checkpoint"):
            save_checkpoint(ckpt_dir, state, cfg, step=done)
        logger.register_artifact("checkpoints", ckpt_dir)
        save_params_npz(params_tree(state.eval_params(cfg)),
                        os.path.join(run_dir, "params.npz"), cfg=cfg)
        with open(os.path.join(run_dir, "profile.json"), "w") as f:
            json.dump(timer.report(), f, indent=1)
    if mesh is not None:
        # no rank returns before the first has written the run
        dist.barrier(group=mesh.group)
    return trainer, state, (train_set, val_set, test_set)


class _Silent:
    """The logger of a data-parallel run's ranks but the first."""

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        pass

    def register_artifact(self, name: str, path: str) -> None:
        pass


def load_trained(run_dir: str, cfg: Config, device=None):
    """``(trainer, state)`` of the newest checkpoint of ``run_dir``, as
    ``diffusion_model_tpu.api.load_trained``: sample at
    ``state.eval_params(cfg)`` (for instance ``generate(cfg,
    params_tree(state.eval_params(cfg)), ...)``). On the card unless
    ``device`` names the CPU; a checkpoint that does not load raises, and
    so does one trained with another coordinate head
    (``x_parameterization``) than ``cfg``'s."""
    trainer = Trainer(cfg, device=_device(device, "api.load_trained"))
    state, saved = restore_checkpoint(os.path.join(run_dir, "checkpoints"),
                                      trainer)
    if saved.x_parameterization != cfg.x_parameterization:
        # the weights answer in the saved head's coordinates
        raise ValueError(
            f"the run was trained with x_parameterization="
            f"{saved.x_parameterization!r}, cfg has "
            f"{cfg.x_parameterization!r}")
    return trainer, state


def distill(cfg: Config, trainer: Trainer, state: TrainState,
            train_graphs: list, final_steps: int, epochs_per_phase: int = 50,
            lr: float = 1e-4, generator: Optional[torch.Generator] = None,
            log_fn: Callable[[str], None] = print,
            noise: Optional[Callable[[int, object], DistillDraws]] = None):
    """Progressively distil the trained model into a ``final_steps``
    deterministic student (``train.distill``), as
    ``diffusion_model_tpu.api.distill``: the teacher is
    ``state.eval_params(cfg)`` on ``trainer.device``, its schedule table
    ``schedule_for``; every epoch re-reads ``batch_iterator(train_graphs,
    cfg.batch_size, cfg.n_max, seed=cfg.seed)``; the draws come from
    ``generator`` (default seeded ``cfg.seed + 17`` on the device) unless
    ``noise`` gives them.

    Returns ``(student_cfg, student_state)`` for ``generate``: the config
    pins the grid the student was distilled on (``sample_steps``,
    ``deterministic_sampling``, ``sample_grid="uniform"``) with
    ``optimizer="Adam"`` and ``ema_decay=0``, so that
    ``student_state.eval_params`` (``opt_state`` None) is the identity; the
    state holds the student denoiser and the teacher's ``gamma.*``."""
    device = trainer.device
    if generator is None and noise is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    params = state.eval_params(cfg)
    tree = params_tree(params)
    model = denoiser_from_params(cfg, tree, device)
    with torch.no_grad():
        schedule = schedule_for(cfg, tree, device)

    def batches_fn():
        return batch_iterator(train_graphs, cfg.batch_size, cfg.n_max,
                              seed=cfg.seed, device=device)

    result = progressive_distill(
        cfg, model, schedule, batches_fn, final_steps=final_steps,
        epochs_per_phase=epochs_per_phase, lr=lr, log_fn=log_fn,
        generator=generator, noise=noise)
    student = {k: v for k, v in params.items()
               if not k.startswith("denoiser.")}
    student.update({f"denoiser.{k}": v for k, v in result.params.items()})
    student_cfg = cfg.replace(sample_steps=result.num_steps,
                              deterministic_sampling=True,
                              sample_grid="uniform", optimizer="Adam",
                              ema_decay=0.0)
    return student_cfg, TrainState(params=student, opt_state=None)


def denoiser_from_params(cfg: Config, params: dict, device,
                         edge_fn: Callable = egcl_pair_edges,
                         knn_edge_fn: Callable = egcl_knn_edges
                         ) -> DiffusionDenoiser:
    """A ``DiffusionDenoiser`` on ``device`` holding a flax parameter tree
    (as ``load_params_npz`` returns it); ``edge_fn`` and ``knn_edge_fn`` do
    the edge work of the dense and the kNN route."""
    model = DiffusionDenoiser(cfg, edge_fn=edge_fn, knn_edge_fn=knn_edge_fn,
                              device=device)
    model.load_state_dict(state_dict_from_flax(params))
    return model.requires_grad_(False)


def schedule_for(cfg: Config, params: dict, device) -> Schedule:
    """The schedule table a snapshot samples with, on ``device``: the
    polynomial one for ``noise_schedule="predefined"``, else the one of the
    gamma network in ``params["gamma"]`` (a flax parameter tree)."""
    if cfg.noise_schedule == "predefined":
        return predefined_schedule(cfg, device=device)
    if "gamma" not in params:
        raise ValueError("noise_schedule='learned' needs the gamma network's "
                         "parameters, params['gamma']")
    gamma = GammaNetwork(device=device).requires_grad_(False)
    gamma.load_state_dict(gamma_state_dict_from_flax(params))
    return learned_schedule(gamma, cfg.num_diffusion_timestep, device)


def generate(cfg: Config, params_or_model: Union[dict, DiffusionDenoiser],
             test_graphs: list, generator: Optional[torch.Generator] = None,
             gen_num_per_spectrum: Optional[int] = None, batch_size: int = 16,
             device=None, noise: Optional[NoiseSource] = None,
             return_trajectory: bool = False, size_predictor=None,
             edge_fn: Callable = egcl_pair_edges,
             knn_edge_fn: Callable = egcl_knn_edges,
             schedule: Optional[Schedule] = None) -> dict:
    """Sample ``gen_num_per_spectrum`` structures per test condition.

    Args:
      params_or_model: a flax parameter tree or a ``DiffusionDenoiser``.
      test_graphs: graph dicts (numpy ``pos``/``species``/``spectrum``/
        ``exo``/``id``).
      generator: source of the sampling noise; by default a generator on
        ``device`` seeded with ``cfg.seed``.
      device: where to sample; by default the model's, else the
        generator's, else the card (``cuda``): without one, CUDA's own
        error is raised, and the CPU is used only when asked for.
      noise: optional replacement source of standard-normal draws (see
        ``diffusion.sampler``).
      size_predictor: ``(CNPredictor, flax params or None)``: each
        condition is first re-sized to its predicted atom count
        (``predict_sizes``).
      return_trajectory: also return ``trajectory_pos`` ``[F, S, N, 3]``
        and ``trajectory_h`` ``[F, S, N, A]`` over the S samples, the state
        entering every ``cfg.snapshot_every``-th reverse step
        (``SampleResult.trajectory``).
      edge_fn, knn_edge_fn: the edge functions of a model built from
        ``params`` (see ``denoiser_from_params``).
      schedule: the schedule table; by default ``schedule_for(cfg,
        params, device)``. A model whose config has a learned schedule comes
        without its gamma network, so it needs one.

    Returns:
      dict of numpy arrays: ``ids`` (condition i repeated G times,
      adjacent), ``original_pos``/``original_species``/``mask`` repeated
      alike, and ``generated_pos``/``generated_species``/``generated_h``/
      ``finite``/``accepted`` (and the trajectory when asked for).
    """
    if size_predictor is not None:
        test_graphs = predict_sizes(cfg, size_predictor, test_graphs)
    g = gen_num_per_spectrum or cfg.gen_num_per_spectrum
    model, device, generator, schedule = _sampling(
        cfg, params_or_model, device, generator, schedule, edge_fn,
        knn_edge_fn)

    outs, ids = [], []
    orig_pos, orig_species, masks = [], [], []
    for start in range(0, len(test_graphs), batch_size):
        chunk = test_graphs[start : start + batch_size]
        n_real = len(chunk)
        if n_real < batch_size and len(test_graphs) >= batch_size:
            chunk = list(chunk) + [chunk[-1]] * (batch_size - n_real)
        cond = collate(chunk, cfg.n_max, device)
        res = sample_with_retry(model, schedule, cfg, generator,
                                tile_batch(cond, g), noise, return_trajectory)
        keep = n_real * g
        out = {k: getattr(res, k)[:keep].cpu().numpy()
               for k in ("pos", "species", "h", "finite", "accepted")}
        if return_trajectory:
            out["trajectory_pos"], out["trajectory_h"] = (
                t[:, :keep].cpu().numpy() for t in res.trajectory)
        outs.append(out)
        for gr in chunk[:n_real]:
            ids += [gr["id"]] * g
        orig_pos.append(np.repeat(cond.pos[:n_real].cpu().numpy(), g, 0))
        orig_species.append(
            np.repeat(cond.species[:n_real].cpu().numpy(), g, 0))
        masks.append(np.repeat(cond.mask[:n_real].cpu().numpy(), g, 0))

    def cat(field, axis=0):
        return np.concatenate([o[field] for o in outs], axis=axis)

    extra = {}
    if return_trajectory:
        extra = {k: cat(k, axis=1) for k in ("trajectory_pos",
                                              "trajectory_h")}
    return {
        "ids": ids,
        **extra,
        "original_pos": np.concatenate(orig_pos, axis=0),
        "original_species": np.concatenate(orig_species, axis=0),
        "mask": np.concatenate(masks, axis=0),
        "generated_pos": cat("pos"),
        "generated_species": cat("species"),
        "generated_h": cat("h"),
        "finite": cat("finite"),
        "accepted": cat("accepted"),
    }


def _sampling(cfg: Config, params_or_model, device, generator, schedule,
              edge_fn: Callable = egcl_pair_edges,
              knn_edge_fn: Callable = egcl_knn_edges) -> tuple:
    """(model, device, generator, schedule) of ``generate``'s arguments."""
    if isinstance(params_or_model, DiffusionDenoiser):
        model = params_or_model
        device = next(model.parameters()).device if device is None else device
        if schedule is None and cfg.noise_schedule != "predefined":
            raise ValueError(
                f"noise_schedule={cfg.noise_schedule!r}: a model comes "
                "without its gamma network; pass schedule=schedule_for(cfg, "
                "params, device)")
        params = {}
    else:
        params = params_or_model
        if device is None:
            device = "cuda" if generator is None else generator.device
        model = denoiser_from_params(cfg, params, device, edge_fn,
                                     knn_edge_fn)
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    if schedule is None:
        schedule = schedule_for(cfg, params, device)
    return model, device, generator, schedule


def generate_ring(cfg: Config,
                  params_or_model: Union[dict, DiffusionDenoiser],
                  test_graphs: list,
                  generator: Optional[torch.Generator] = None,
                  gen_num_per_spectrum: Optional[int] = None, mesh=None,
                  axis: str = "data", device=None,
                  schedule: Optional[Schedule] = None) -> dict:
    """Sample through the ring, one node-sharded graph a call, as
    ``diffusion_model_tpu.api.generate_ring``: the dense-topology route for
    cells whose ``[N, N]`` pair grid exceeds one card. The unchanged
    sampler (strided, deterministic, guidance, the t=0 epilogue, retries)
    runs with its denoiser through ``parallel.ring.ring_sampler_denoise_fn``;
    each condition's ``gen_num_per_spectrum`` repeats are sampled one after
    another at B=1, from one ``generator`` (by default seeded ``cfg.seed``
    on ``device``). Every rank of the ring calls it alike and gets the same
    samples. ``mesh``: by default one over the initialised world
    (``cfg.mesh_shape`` or every rank on ``axis``). The other arguments are
    ``generate``'s, and so is the returned dict, field for field, so every
    evaluator takes it. Raises where ``cfg.n_max`` does not split into the
    mesh's ranks."""
    from diffusion_model_tpu_torch.parallel.ring import (
        ring_sampler_denoise_fn,
    )

    if not cfg.ring_sample:
        cfg = cfg.replace(ring_sample=True)
    if mesh is None:
        if not dist.is_initialized():
            raise RuntimeError(f"api.generate_ring {NO_WORLD}")
        mesh = make_mesh(cfg.mesh_shape or None, (axis,))
    if cfg.n_max % mesh.size != 0:
        raise ValueError(f"n_max={cfg.n_max} not divisible by mesh size "
                         f"{mesh.size}")
    g = gen_num_per_spectrum or cfg.gen_num_per_spectrum
    model, device, generator, schedule = _sampling(
        cfg, params_or_model, device, generator, schedule)
    denoise_fn = ring_sampler_denoise_fn(cfg, model, mesh, axis)

    outs, ids = [], []
    orig_pos, orig_species, masks = [], [], []
    for gr in test_graphs:
        cond = collate([gr], cfg.n_max, device)
        for _ in range(g):
            res = sample_with_retry(denoise_fn, schedule, cfg, generator,
                                    cond)
            outs.append({k: getattr(res, k).cpu().numpy()
                         for k in ("pos", "species", "h", "finite",
                                   "accepted")})
            ids.append(gr["id"])
        for field, out in ((cond.pos, orig_pos),
                           (cond.species, orig_species), (cond.mask, masks)):
            out.append(np.repeat(field.cpu().numpy(), g, axis=0))

    def cat(field):
        return np.concatenate([o[field] for o in outs], axis=0)

    return {
        "ids": ids,
        "original_pos": np.concatenate(orig_pos, axis=0),
        "original_species": np.concatenate(orig_species, axis=0),
        "mask": np.concatenate(masks, axis=0),
        "generated_pos": cat("pos"),
        "generated_species": cat("species"),
        "generated_h": cat("h"),
        "finite": cat("finite"),
        "accepted": cat("accepted"),
    }


def predict_sizes(cfg: Config, size_predictor, test_graphs: list) -> list:
    """Re-size each condition to its predicted atom count, as
    ``diffusion_model_tpu.api.predict_sizes``: ``round(model(spectrum of
    node 0))`` clamped to ``[2, n_max]`` (a non-finite prediction falls back
    to the true size); the per-node arrays are cut, or zero-padded with the
    grown slots' species set to O.

    ``size_predictor``: ``(model, params)``, a ``CNPredictor`` and a flax
    tree it loads (or None: the model's own weights); the model runs where
    its parameters are.
    """
    model, params = size_predictor
    if params is not None:
        model.load_flax(params)
    device = next(model.parameters()).device
    spectra = torch.as_tensor(np.stack(
        [np.asarray(g["spectrum"][0], np.float32) for g in test_graphs]),
        device=device)
    with torch.no_grad():
        pred = model(spectra)[:, 0].cpu().numpy()
    true_sizes = np.asarray(
        [np.asarray(g["pos"]).shape[0] for g in test_graphs], np.float64)
    pred = np.where(np.isfinite(pred), pred, true_sizes)
    sizes = np.clip(np.round(pred), 2, cfg.n_max).astype(int)
    out = []
    for g, n in zip(test_graphs, sizes):
        g = dict(g)
        cur = np.asarray(g["pos"]).shape[0]
        for field in ("pos", "species", "spectrum", "exo"):
            a = np.asarray(g[field], np.float32)
            if n <= cur:
                g[field] = a[:n]
            else:
                padded = np.zeros((n,) + a.shape[1:], np.float32)
                padded[:cur] = a
                g[field] = padded
        if n > cur:
            g["species"][cur:, 0] = 1.0
        out.append(g)
    return out


def evaluate_numbers(results: dict, device=None) -> dict:
    """``evaluate``'s numbers without figures: over the accepted samples,
    the Kabsch RMSD of each to its condition, sorted (``sorted_rmsd``,
    ``(index among the accepted, rmsd)``; on ``device``, default the card),
    ``rmsd_best`` / ``rmsd_median`` / ``rmsd_worst``, the O densities
    (``o_density_original`` / ``_generated``) and ``atom_type_accuracy``,
    and ``num_accepted``. With no accepted sample, only ``num_accepted`` 0,
    an empty ``sorted_rmsd`` and a NaN accuracy."""
    keep = np.nonzero(np.asarray(results["accepted"]))[0]
    if len(keep) == 0:
        return {"sorted_rmsd": [], "atom_type_accuracy": float("nan"),
                "num_accepted": 0}
    pick = {k: np.asarray(results[k])[keep]
            for k in ("original_pos", "original_species", "mask",
                      "generated_pos", "generated_species")}
    sorted_rows = evaluate_by_rmsd(
        pick["original_pos"], pick["generated_pos"], pick["mask"],
        ids=list(range(len(keep))),
        device=_device(device, "api.evaluate"))
    rmsds = [r[1] for r in sorted_rows]
    d_orig = o_density(pick["original_species"], pick["mask"])
    d_gen = o_density(pick["generated_species"], pick["mask"])
    return {"sorted_rmsd": sorted_rows,
            "rmsd_best": float(rmsds[0]),
            "rmsd_median": float(rmsds[len(rmsds) // 2]),
            "rmsd_worst": float(rmsds[-1]),
            "o_density_original": d_orig, "o_density_generated": d_gen,
            "atom_type_accuracy": density_accuracy(d_orig, d_gen),
            "num_accepted": int(len(keep))}


def evaluate(results: dict, run_dir: str, logger: Optional[RunLogger] = None,
             create_xyz: bool = False, device=None) -> dict:
    """Sorted-RMSD evaluation, O-density accuracy and figures, as
    ``diffusion_model_tpu.api.evaluate``: the numbers of
    ``evaluate_numbers`` logged (``rmsd_best``, ``rmsd_median``,
    ``rmsd_worst``, ``atom_type_accuracy``, ``num_accepted``), the figures
    ``rmsd`` and ``atom_type_eval`` (matplotlib, imported here: without it
    ``utils.figures.pyplot`` raises before anything is logged), and with
    ``create_xyz`` the overlays of the best three, the median and the worst
    sample as ``run_dir/<name>.xyz``. Returns ``sorted_rmsd``,
    ``atom_type_accuracy`` and ``num_accepted``."""
    plt = pyplot("rmsd")
    logger = logger or RunLogger(run_dir)
    num = evaluate_numbers(results, device)
    if num["num_accepted"] == 0:
        logger.log({"num_accepted": 0})
        print("warning: no finite accepted samples to evaluate")
        return num
    sorted_rows = num["sorted_rmsd"]
    acc = num["atom_type_accuracy"]

    fig, ax = plt.subplots()
    ax.plot([r[1] for r in sorted_rows], marker="o", linestyle="None")
    ax.set_xlabel("sorted_index")
    ax.set_ylabel("rmsd")
    ax.set_yscale("log")
    ax.set_title("rmsd")
    logger.log_figure("rmsd", fig)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], "-", color="red", alpha=0.5)
    ax.plot(num["o_density_original"], num["o_density_generated"], "o",
            alpha=0.5)
    ax.set_xlabel("density of O for original")
    ax.set_ylabel("density of O for generated")
    ax.set_title(f"atom_type_eval (accuracy {acc:.5f})")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    logger.log_figure("atom_type_eval", fig)
    plt.close(fig)

    logger.log({k: num[k] for k in ("rmsd_best", "rmsd_median", "rmsd_worst",
                                    "atom_type_accuracy", "num_accepted")})

    if create_xyz:
        keep = np.nonzero(np.asarray(results["accepted"]))[0]
        picks = {"first_min_rmsd": 0, "second_min_rmsd": 1,
                 "third_min_rmsd": 2, "mid_rmsd": len(sorted_rows) // 2,
                 "max_rmsd": len(sorted_rows) - 1}
        for name, rank in picks.items():
            if rank >= len(sorted_rows):
                continue
            idx, rmsd = sorted_rows[rank]
            row = keep[idx]
            n_real = int(np.asarray(results["mask"])[row].sum())
            write_xyz_overlay(
                os.path.join(run_dir, f"{name}.xyz"),
                np.asarray(results["original_pos"])[row][:n_real],
                np.asarray(results["original_species"])[row][:n_real],
                np.asarray(results["generated_pos"])[row][:n_real],
                np.asarray(results["generated_species"])[row][:n_real],
                comment=f"{name} {results['ids'][row]} rmsd: {rmsd}")
        logger.register_artifact("rmsd_xyz_path", run_dir)

    return {k: num[k] for k in ("sorted_rmsd", "atom_type_accuracy",
                                "num_accepted")}


def record_schedule(cfg: Config, trainer: Trainer, state, run_dir: str,
                    logger: Optional[RunLogger] = None) -> dict:
    """Figures of the schedule at ``state.eval_params(cfg)`` against t =
    0..T, as ``diffusion_model_tpu.api.record_schedule``: ``alpha``,
    ``sigma = sqrt(clip(1 - alpha^2, 0, 1))``, ``SNR = alpha^2 /
    max(sigma^2, 1e-12)``, and for a learned schedule ``gamma`` on
    ``linspace(0, 1, T + 1)``. Returns name -> path."""
    plt = pyplot("alpha")
    logger = logger or RunLogger(run_dir)
    _, gamma = trainer._load_eval(state.eval_params(cfg))
    with torch.no_grad():
        alphas = trainer.schedule_for(gamma).alphas.cpu().numpy()
        sigmas = np.sqrt(np.clip(1 - alphas ** 2, 0, 1))
        curves = {"alpha": alphas, "sigma": sigmas,
                  "SNR": (alphas ** 2) / np.maximum(sigmas ** 2, 1e-12)}
        if cfg.noise_schedule == "learned":
            t_grid = linspace_f32(0.0, 1.0, len(alphas),
                                  device=trainer.device)[:, None]
            curves["gamma"] = gamma(t_grid)[:, 0].cpu().numpy()
    t = np.arange(alphas.shape[0])
    paths = {}
    for name, y in curves.items():
        fig, ax = plt.subplots()
        ax.plot(t, y)
        ax.set_xlabel("t")
        ax.set_ylabel(name)
        if name == "SNR":
            ax.set_yscale("log")
        ax.set_title(name)
        paths[name] = logger.log_figure(name, fig)
        plt.close(fig)
    return paths
