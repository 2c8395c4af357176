"""Library surface of the port: training, and conditional generation from
a snapshot.

    trainer, state, (train, val, test) = train(cfg, graphs, run_dir)
    # run_dir/params.npz: the eval parameters, as the JAX package saves them

    cfg = load_config_npz(path)
    params = load_params_npz(path)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    out = generate(cfg, params, test_graphs, gen)

The noise schedule is the config's (``schedule_for``): the polynomial table,
or for ``noise_schedule="learned"`` the table of the snapshot's own gamma
network (``params["gamma"]``).

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

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.split import (
    device_batch_iterator,
    split_dataset,
)
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
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.gamma import GammaNetwork
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges
from diffusion_model_tpu_torch.train.checkpoint import (
    gamma_state_dict_from_flax,
    save_params_npz,
    state_dict_from_flax,
)
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import (
    EarlyStopping,
    Trainer,
    params_tree,
)

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


def train(cfg: Config, dataset: list, run_dir: str,
          num_epochs: Optional[int] = None, device=None,
          noise: Optional[Callable[[int, str], object]] = None):
    """Train from a fresh state, as ``diffusion_model_tpu.api.train``: the
    dataset prepared and split 80/10/10 by ``cfg.seed``, collated once onto
    the device, then per epoch the train batches in the order of seed
    ``cfg.seed + epoch`` and the validation batches in order. A non-finite
    epoch rolls back to the last good state (at most ``MAX_NAN_RECOVERIES``
    times); ``EarlyStopping(cfg.patience)`` ends the run. Each epoch's
    losses go to ``run_dir/metrics.jsonl``, the eval parameters to
    ``run_dir/params.npz`` (float16, config embedded) at the end.

    Runs on the card unless ``device`` names the CPU; the card's kernels
    fail loudly, never falling back. ``noise(epoch, "train" | "eval")``
    gives an epoch's noise source (default ``TrainNoise`` streams seeded
    from ``cfg.seed``, the epoch and the phase).

    Returns ``(trainer, state, (train_set, val_set, test_set))``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("api.train runs on the card and finds none; "
                           "pass device='cpu' to train on the CPU")
    if noise is None:
        def noise(epoch, phase):
            return TrainNoise((cfg.seed, epoch, int(phase == "eval")),
                              device)
    dataset = prepare_dataset(dataset, cfg)
    train_set, val_set, test_set = split_dataset(dataset, cfg.seed)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed)
    os.makedirs(run_dir, exist_ok=True)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    stopper = EarlyStopping(patience=cfg.patience)
    epochs = cfg.num_epochs if num_epochs is None else num_epochs
    nan_recoveries = 0
    good = state.clone()
    train_data = collate(train_set, cfg.n_max, device)
    val_data = collate(val_set, cfg.n_max, device) if val_set else None
    for epoch in range(epochs):
        t0 = time.perf_counter()
        batches = device_batch_iterator(train_data, cfg.batch_size,
                                        seed=cfg.seed + epoch)
        state, train_loss = trainer.train_epoch(state, noise(epoch, "train"),
                                                batches)
        if not np.isfinite(train_loss):
            nan_recoveries += 1
            _log(metrics_path, {"nan_recovery": nan_recoveries}, epoch)
            if nan_recoveries > MAX_NAN_RECOVERIES:
                raise RuntimeError(
                    f"training diverged: {MAX_NAN_RECOVERIES} non-finite "
                    "epochs")
            state = trainer.restore(state, good)
            continue
        good = state.clone()
        val_batches = (device_batch_iterator(val_data, cfg.batch_size)
                       if val_data is not None else iter(()))
        eval_loss = trainer.eval_epoch(state, noise(epoch, "eval"),
                                       val_batches)
        _log(metrics_path, {"train_loss": train_loss, "eval_loss": eval_loss,
                            "epoch_s": time.perf_counter() - t0}, epoch)
        if stopper.validate(eval_loss):
            break
    save_params_npz(params_tree(state.eval_params(cfg)),
                    os.path.join(run_dir, "params.npz"), cfg=cfg)
    return trainer, state, (train_set, val_set, test_set)


def _log(path: str, record: dict, epoch: int) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({**record, "step": epoch}) + "\n")


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
        raise NotImplementedError("size_predictor is not ported yet")
    g = gen_num_per_spectrum or cfg.gen_num_per_spectrum
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
