"""Library surface of the port: conditional generation from a snapshot.

    cfg = load_config_npz(path)
    params = load_params_npz(path)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    out = generate(cfg, params, test_graphs, gen)

``generate`` follows ``diffusion_model_tpu.api.generate``: conditions are
collated in chunks of ``batch_size`` (the final chunk padded with copies of
its last condition and trimmed after sampling, so every chunk has one
shape), each tiled ``gen_num_per_spectrum`` times with the copies adjacent,
and sampled with NaN retry. With ``cfg.neighbor_k`` set, every denoiser call
runs over the kNN lists of the current positions (``knn_edge_fn``, the kNN
kernel on the card); otherwise over the dense pair grid (``edge_fn``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion.process import predefined_schedule
from diffusion_model_tpu_torch.diffusion.sampler import (
    NoiseSource,
    sample_with_retry,
    tile_batch,
)
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges
from diffusion_model_tpu_torch.train.checkpoint import state_dict_from_flax


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
    return model


def generate(cfg: Config, params_or_model: Union[dict, DiffusionDenoiser],
             test_graphs: list, generator: Optional[torch.Generator] = None,
             gen_num_per_spectrum: Optional[int] = None, batch_size: int = 16,
             device=None, noise: Optional[NoiseSource] = None,
             return_trajectory: bool = False, size_predictor=None,
             edge_fn: Callable = egcl_pair_edges,
             knn_edge_fn: Callable = egcl_knn_edges) -> dict:
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
      edge_fn, knn_edge_fn: the edge functions of a model built from
        ``params`` (see ``denoiser_from_params``).

    Returns:
      dict of numpy arrays: ``ids`` (condition i repeated G times,
      adjacent), ``original_pos``/``original_species``/``mask`` repeated
      alike, and ``generated_pos``/``generated_species``/``generated_h``/
      ``finite``/``accepted``.
    """
    if size_predictor is not None:
        raise NotImplementedError("size_predictor is not ported yet")
    if return_trajectory:
        raise NotImplementedError("return_trajectory is not ported yet")
    g = gen_num_per_spectrum or cfg.gen_num_per_spectrum
    if isinstance(params_or_model, DiffusionDenoiser):
        model = params_or_model
        device = next(model.parameters()).device if device is None else device
    else:
        if device is None:
            device = "cuda" if generator is None else generator.device
        model = denoiser_from_params(cfg, params_or_model, device, edge_fn,
                                     knn_edge_fn)
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    schedule = predefined_schedule(cfg, device=device)

    outs, ids = [], []
    orig_pos, orig_species, masks = [], [], []
    for start in range(0, len(test_graphs), batch_size):
        chunk = test_graphs[start : start + batch_size]
        n_real = len(chunk)
        if n_real < batch_size and len(test_graphs) >= batch_size:
            chunk = list(chunk) + [chunk[-1]] * (batch_size - n_real)
        cond = collate(chunk, cfg.n_max, device)
        res = sample_with_retry(model, schedule, cfg, generator,
                                tile_batch(cond, g), noise)
        keep = n_real * g
        outs.append({k: getattr(res, k)[:keep].cpu().numpy()
                     for k in ("pos", "species", "h", "finite", "accepted")})
        for gr in chunk[:n_real]:
            ids += [gr["id"]] * g
        orig_pos.append(np.repeat(cond.pos[:n_real].cpu().numpy(), g, 0))
        orig_species.append(
            np.repeat(cond.species[:n_real].cpu().numpy(), g, 0))
        masks.append(np.repeat(cond.mask[:n_real].cpu().numpy(), g, 0))

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
