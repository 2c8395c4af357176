"""Forward-noising of training batches and the epsilon-prediction loss, as
``diffusion_model_tpu/train/loss.py``:

  * per-graph timestep t ~ U{1..T}, optionally a fraction redrawn from the
    band ``[t_bias_lo, t_bias_hi]`` (``t_bias_frac``);
  * positions noised CoM-free, the species one-hot noised plainly;
  * summed squared error over ``[eps_x | eps_h]`` on real nodes, divided by
    the number of real graphs for the gradient (optionally weighted per
    graph by ``t_band_weights``), reported per node.

Random draws come from a noise source (``TrainNoise``, or any object with
its three methods): ``randint``, ``normal`` and ``bernoulli``, each naming
its stream. ``TrainNoise`` keeps one ``torch.Generator`` a stream, seeded
apart, as the JAX package splits its key into independent streams; a test
replays the JAX package's draws through the same three methods.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion.process import (
    Schedule,
    diffuse_zero_to_t,
)


class TrainNoise:
    """The random draws of training steps on ``device``: one generator for
    each stream, seeded from ``seed`` (an int or a sequence of ints) and the
    stream's place in ``STREAMS`` through ``numpy.random.SeedSequence``."""

    # appended, never inserted: a stream's seed is its place here
    STREAMS = ("t", "t_band", "t_sel", "pos", "h", "drop", "kabsch")

    def __init__(self, seed, device):
        self.device = torch.device(device)
        entropy = list(seed) if isinstance(seed, (tuple, list)) else [seed]
        self.generators = {}
        for i, name in enumerate(self.STREAMS):
            state = np.random.SeedSequence(entropy + [i]).generate_state(1)
            self.generators[name] = torch.Generator(
                device=self.device).manual_seed(int(state[0]))

    def randint(self, stream: str, low: int, high: int,
                shape: Sequence[int]) -> torch.Tensor:
        """Integers uniform in ``[low, high)``."""
        return torch.randint(low, high, tuple(shape), device=self.device,
                             generator=self.generators[stream])

    def normal(self, stream: str, shape: Sequence[int]) -> torch.Tensor:
        """Standard normal float32."""
        return torch.randn(tuple(shape), device=self.device,
                           generator=self.generators[stream])

    def bernoulli(self, stream: str, p: float,
                  shape: Sequence[int]) -> torch.Tensor:
        """Booleans, true with probability ``p``."""
        return torch.rand(tuple(shape), device=self.device,
                          generator=self.generators[stream]) < p


class BatchRows:
    """A noise source that draws from ``noise`` for a global batch of
    ``size`` graphs and hands out the rows ``rows`` of each draw: a
    data-parallel rank's draws, the same as the one-process step's for its
    graphs. Every draw's leading axis is the batch."""

    def __init__(self, noise, rows: slice, size: int):
        self.noise, self.rows, self.size = noise, rows, size

    def _global(self, shape: Sequence[int]) -> tuple:
        if shape[0] != self.rows.stop - self.rows.start:
            raise ValueError(f"a draw of shape {tuple(shape)} is not over "
                             f"this rank's {self.rows} of {self.size} graphs")
        return (self.size,) + tuple(shape[1:])

    def randint(self, stream: str, low: int, high: int,
                shape: Sequence[int]) -> torch.Tensor:
        return self.noise.randint(stream, low, high,
                                  self._global(shape))[self.rows]

    def normal(self, stream: str, shape: Sequence[int]) -> torch.Tensor:
        return self.noise.normal(stream, self._global(shape))[self.rows]

    def bernoulli(self, stream: str, p: float,
                  shape: Sequence[int]) -> torch.Tensor:
        return self.noise.bernoulli(stream, p,
                                    self._global(shape))[self.rows]


def _check_band(cfg: Config, what: str) -> None:
    if not 1 <= cfg.t_bias_lo <= cfg.t_bias_hi <= cfg.num_diffusion_timestep:
        raise ValueError(
            f"{what} [{cfg.t_bias_lo}, {cfg.t_bias_hi}] must lie within "
            f"[1, num_diffusion_timestep={cfg.num_diffusion_timestep}]")


def diffuse_batch(schedule: Schedule, cfg: Config, noise,
                  batch: GraphBatch):
    """Draw per-graph timesteps and noise the batch to them.

    Returns:
      (pos_t, h_t, t [B] int64, eps_pos, eps_h)
    """
    b = batch.batch_size
    t = noise.randint("t", 1, cfg.num_diffusion_timestep + 1, (b,))
    if cfg.t_bias_frac > 0.0:
        _check_band(cfg, "t_bias band")
        t_band = noise.randint("t_band", cfg.t_bias_lo, cfg.t_bias_hi + 1,
                               (b,))
        sel = noise.bernoulli("t_sel", cfg.t_bias_frac, (b,))
        t = torch.where(sel, t_band, t)
    pos_t, eps_pos = diffuse_zero_to_t(
        schedule, noise.normal("pos", batch.pos.shape), batch.pos, t,
        mode="pos", mask=batch.mask)
    if cfg.diffuse_species:
        h_t, eps_h = diffuse_zero_to_t(
            schedule, noise.normal("h", batch.species.shape), batch.species,
            t, mode="h", mask=batch.mask)
    else:
        h_t, eps_h = batch.species, torch.zeros_like(batch.species)
    return pos_t, h_t, t, eps_pos, eps_h


def t_band_weights(cfg: Config, t: torch.Tensor) -> Optional[torch.Tensor]:
    """Per-graph loss weights: ``t_loss_weight`` inside ``[t_bias_lo,
    t_bias_hi]``, 1 outside, over the analytic mean weight under the
    uniform t draw; None when the lever is off (``t_loss_weight`` 1)."""
    if cfg.t_loss_weight == 1.0:
        return None
    _check_band(cfg, "t-band")
    if cfg.t_loss_weight <= 0.0:
        raise ValueError(f"t_loss_weight={cfg.t_loss_weight} must be > 0")
    in_band = (t >= cfg.t_bias_lo) & (t <= cfg.t_bias_hi)
    w = torch.where(in_band, torch.tensor(cfg.t_loss_weight, device=t.device),
                    torch.tensor(1.0, device=t.device))
    p_band = (cfg.t_bias_hi - cfg.t_bias_lo + 1) / cfg.num_diffusion_timestep
    return w / (1.0 + (cfg.t_loss_weight - 1.0) * p_band)


def epsilon_loss(eps_x_pred, eps_h_pred, eps_x, eps_h, mask,
                 include_h: bool = True,
                 weights: Optional[torch.Tensor] = None):
    """Sum-MSE over ``[eps_x | eps_h]`` on real nodes.

    Returns:
      (loss = (weighted) sum / real graphs, sum_sq = raw summed squared
       error, num_nodes = real atoms in the batch)
    """
    m3 = mask.unsqueeze(-1)
    per_graph = (((eps_x_pred - eps_x) ** 2) * m3).sum(dim=(1, 2))
    if include_h:
        per_graph = per_graph + (((eps_h_pred - eps_h) ** 2) * m3).sum(
            dim=(1, 2))
    sq = per_graph.sum()
    num_graphs = (mask > 0).any(dim=-1).to(sq.dtype).sum().clamp_min(1.0)
    loss_sq = sq if weights is None else (
        per_graph * weights.to(per_graph.dtype)).sum()
    return loss_sq / num_graphs, sq, mask.sum()
