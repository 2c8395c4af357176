"""Reverse-diffusion sampler: T (or a strided subset of) ancestral steps, the
t=0 epilogue and the accept mask, with NaN retry.

The chain is a Python loop over eager PyTorch calls on one device. Random
draws come from ``noise(shape)``, a callable that returns the next
standard-normal tensor of that shape; by default it draws from the explicit
``torch.Generator``. The draws are taken in a fixed order: initial
positions, initial species channel, then per step the position noise and
the species noise, then the same two for the epilogue (none when the chain
is deterministic). A caller can therefore replay another implementation's
draws, which is how the tests hold whole chains against the JAX package.

``sample`` runs the chain under ``no_grad``; ``sample_with_grad`` runs the
same loop under autograd (the Kabsch coordinate loss differentiates through
it), each denoiser call through ``torch.utils.checkpoint`` so that the chain
keeps only every call's inputs and recomputes its activations in the
backward, as the JAX package's ``remat`` around ``model.apply``. The draws
are taken outside the checkpointed calls: a recompute restores the global
generators, not an explicit ``torch.Generator``, so a draw inside would
differ between the forward and the recompute.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion.process import (
    Schedule,
    final_denoise_step,
    head_out_to_eps,
    reverse_diffuse_one_step,
    x_param_is_x0,
)
from diffusion_model_tpu_torch.ops.com import remove_mean
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.ops.schedules import linspace_f32

NoiseSource = Callable[[Sequence[int]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SampleResult:
    pos: torch.Tensor       # [B, N, 3] final coordinates
    species: torch.Tensor   # [B, N, A] one-hot argmax species
    h: torch.Tensor         # [B, N, A] raw final species channel
    finite: torch.Tensor    # [B] bool: no NaN/Inf produced
    accepted: torch.Tensor  # [B] bool: finite and every coordinate <= 1000
    # (pos [F, B, N, 3], h [F, B, N, A]): the state entering every
    # snapshot_every-th reverse step, the pure-noise state first; or None
    trajectory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def tile_batch(cond: GraphBatch, n: int) -> GraphBatch:
    """Repeat each condition ``n`` times, copies adjacent."""
    return cond.map(lambda a: a.repeat_interleave(n, dim=0))


def snr_grid(alphas: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps+1`` schedule indices equispaced in log-SNR, endpoints pinned
    to 0 and T and forced monotone where the spacing allows."""
    a2 = alphas.to(torch.float32) ** 2
    gamma = (torch.log1p(-a2.clamp_max(1.0 - 1e-7))
             - torch.log(a2.clamp_min(1e-38)))
    levels = linspace_f32(gamma[0], gamma[-1], steps + 1, device=alphas.device)
    idx = torch.searchsorted(gamma, levels)
    t_max = alphas.shape[0] - 1
    idx[0] = 0
    idx[-1] = t_max
    ar = torch.arange(steps + 1, device=alphas.device)
    idx = torch.minimum(torch.maximum(idx, ar), t_max - steps + ar)
    return torch.cummax(idx, dim=0).values


def _strided(schedule: Schedule, cfg: Config):
    """(schedule over the reverse grid, t/T of each grid entry, steps)."""
    T = cfg.num_diffusion_timestep
    steps = cfg.sample_steps or T
    if steps > T:
        raise ValueError(
            f"sample_steps={steps} exceeds num_diffusion_timestep={T}")
    device = schedule.alphas.device
    if steps == T:
        return (schedule,
                torch.arange(T + 1, dtype=torch.float32, device=device) / T,
                steps)
    if cfg.sample_grid == "snr":
        idx = snr_grid(schedule.alphas, steps)
    else:
        idx = torch.round(linspace_f32(0.0, T, steps + 1, device=device)).long()
    return (Schedule(alphas=schedule.alphas[idx]),
            idx.to(torch.float32) / T, steps)


class ReverseChain:
    """The pieces of one reverse chain over a conditioning batch: the
    denoiser call at a grid index (guidance blend, then the coordinate
    head read as epsilon), one ancestral step and the t=0 epilogue.
    ``sample`` strings them together; a caller can also start any step
    from a state of its own (another implementation's, to hold the two
    step by step).

    ``schedule`` is the full ``T+1`` table; the chain keeps the one over
    its reverse grid (``cfg.sample_steps`` strided entries, else all), and
    ``t`` everywhere is an index into that grid: a Python int, or for
    ``step`` a 0-d int64 tensor on the CPU (read with ``item``; one on the
    card would make the host wait for it). ``grid``, where given, is
    ``_strided(schedule, cfg)`` computed before (``schedule`` is then not
    read): the serving export computes it before the trace, so that the
    grid enters the program as constants.

    ``start``, ``step`` and ``finish`` take every draw as a tensor (None
    where the chain takes none), so ``torch.export`` can trace each of
    them; ``run_chain`` takes the draws from a noise source in the fixed
    order (module docstring) and strings them together.
    """

    def __init__(self, denoise_fn: Callable, schedule: Optional[Schedule],
                 cfg: Config, cond: GraphBatch, grid: Optional[tuple] = None):
        self.denoise_fn = denoise_fn
        self.cfg = cfg
        self.cond = cond
        self.schedule, self.t_norm_table, self.steps = (
            grid if grid is not None else _strided(schedule, cfg))
        self.x0_mode = x_param_is_x0(cfg)
        self.mask = cond.mask
        self.m3 = cond.mask.unsqueeze(-1)
        self.scale = cfg.onehot_scaling_factor
        self.stochastic = (not cfg.deterministic_sampling
                           and cfg.sample_noise_scale != 0)
        self.step_kw = dict(mask=cond.mask,
                            deterministic=cfg.deterministic_sampling,
                            noise_scale=cfg.sample_noise_scale)

    def denoise(self, pos: torch.Tensor, h: torch.Tensor, t):
        """(eps_x, eps_h) at grid index ``t``."""
        cfg, cond, mask = self.cfg, self.cond, self.mask
        t_norm = self.m3 * self.t_norm_table[t]
        # integer lists: under autograd the distances would only be kept
        # for a backward that gives indices nothing
        edges = (knn_edges(pos.detach(), mask, cfg.neighbor_k)
                 if cfg.neighbor_k else None)
        h_in = self.scale * h
        eps_x, eps_h = self.denoise_fn(h_in, pos, cond.spectrum, cond.exo,
                                       t_norm, mask, edges)
        if cfg.guidance_scale > 0:
            # classifier-free guidance: (1+w) * cond - w * uncond
            ex_u, eh_u = self.denoise_fn(h_in, pos,
                                         torch.zeros_like(cond.spectrum),
                                         cond.exo, t_norm, mask, edges)
            w = cfg.guidance_scale
            eps_x = (1.0 + w) * eps_x - w * ex_u
            eps_h = (1.0 + w) * eps_h - w * eh_u
        if self.x0_mode:
            # after the blend: both conversions are affine in the output
            # with a z-term that does not depend on it, so they commute
            # with (1+w)c - w u. The strided table's entry t is the noise
            # level this z carries. The species channel stays epsilon.
            eps_x = head_out_to_eps(cfg, self.schedule, t, pos, eps_x)
        return eps_x, eps_h

    def start_shapes(self) -> list:
        """The shapes of the chain's first draws, in the fixed order: the
        positions, then the species channel where it is diffused."""
        b, n = self.mask.shape
        return [(b, n, 3)] + ([(b, n, self.cfg.atom_type_size)]
                              if self.cfg.diffuse_species else [])

    def step_shapes(self) -> list:
        """The shapes of one step's draws (the epilogue's too), in the fixed
        order; none when the chain is deterministic."""
        if not self.stochastic:
            return []
        return self.start_shapes()

    def draws(self, noise: NoiseSource, shapes: list) -> tuple:
        """``noise`` of each of ``shapes``, in order, padded with None to
        (positions, species)."""
        got = [noise(s) for s in shapes]
        return tuple(got + [None] * (2 - len(got)))

    def start(self, pos_draw: torch.Tensor,
              h_draw: Optional[torch.Tensor]):
        """The pure-noise state at grid index ``steps``: the first draw made
        CoM-free, and the species channel's draw masked (the condition's
        species where they are not diffused)."""
        pos = remove_mean(pos_draw, self.mask)
        h = (h_draw * self.m3 if self.cfg.diffuse_species
             else self.cond.species)
        return pos, h

    def step(self, pos: torch.Tensor, h: torch.Tensor, t,
             pos_noise: Optional[torch.Tensor],
             h_noise: Optional[torch.Tensor]):
        """The state at grid index ``t - 1`` from the one at ``t``."""
        if isinstance(t, torch.Tensor):
            t = t.item()
            # the bounds of an index that torch.export's tracer cannot see
            torch._check(t >= 1)
            torch._check(t <= self.steps)
        eps_x, eps_h = self.denoise(pos, h, t)
        new_pos = reverse_diffuse_one_step(self.schedule, pos_noise, pos,
                                           eps_x, t, mode="pos",
                                           **self.step_kw)
        if self.cfg.diffuse_species:
            h = reverse_diffuse_one_step(self.schedule, h_noise,
                                         self.scale * h, eps_h, t, mode="h",
                                         **self.step_kw)
        return new_pos, h

    def epilogue(self, pos: torch.Tensor, h: torch.Tensor,
                 pos_noise: Optional[torch.Tensor],
                 h_noise: Optional[torch.Tensor]):
        """(pos, h, species) after the t=0 step: index 0 of the (strided)
        table is schedule entry 0."""
        eps_x, eps_h = self.denoise(pos, h, 0)
        pos = final_denoise_step(self.schedule, pos_noise, pos, eps_x,
                                 mode="pos", **self.step_kw)
        if not self.cfg.diffuse_species:
            return pos, h, self.cond.species
        h = final_denoise_step(self.schedule, h_noise, self.scale * h, eps_h,
                               mode="h", **self.step_kw)
        species = (F.one_hot(h.argmax(dim=-1), self.cfg.atom_type_size)
                   .to(pos.dtype) * self.m3)
        return pos, h, species

    def finish(self, pos: torch.Tensor, h: torch.Tensor,
               pos_noise: Optional[torch.Tensor],
               h_noise: Optional[torch.Tensor]):
        """The epilogue, then its masks: (pos, h, species, finite [B],
        accepted [B]), finite where no NaN or Inf came out, accepted where
        also no coordinate exceeds 1000."""
        pos, h, species = self.epilogue(pos, h, pos_noise, h_noise)
        b = pos.shape[0]
        flat_pos = pos.detach().reshape(b, -1)
        flat_h = h.detach().reshape(b, -1)
        finite = (torch.isfinite(flat_pos).all(dim=-1)
                  & torch.isfinite(flat_h).all(dim=-1))
        # coordinates above 1000 are rejected (signed comparison)
        accepted = finite & ~(flat_pos > 1000.0).any(dim=-1)
        return pos, h, species, finite, accepted


def run_chain(chain: ReverseChain, noise: NoiseSource,
              return_trajectory: bool = False) -> SampleResult:
    """The reverse chain from pure noise to the t=0 epilogue, the draws
    taken from ``noise`` in the fixed order; autograd records it where grad
    mode is on."""
    cfg, steps = chain.cfg, chain.steps
    pos, h = chain.start(*chain.draws(noise, chain.start_shapes()))
    shapes = chain.step_shapes()
    frames = []
    for t in range(steps, 0, -1):
        if return_trajectory and (steps - t) % cfg.snapshot_every == 0:
            frames.append((pos, h))
        pos, h = chain.step(pos, h, t, *chain.draws(noise, shapes))
    pos, h, species, finite, accepted = chain.finish(
        pos, h, *chain.draws(noise, shapes))
    trajectory = None
    if return_trajectory:
        trajectory = (torch.stack([f[0] for f in frames]),
                      torch.stack([f[1] for f in frames]))
    return SampleResult(pos=pos, species=species, h=h, finite=finite,
                        accepted=accepted, trajectory=trajectory)


@torch.no_grad()
def sample(denoise_fn: Callable, schedule: Schedule, cfg: Config,
           generator: Optional[torch.Generator], cond: GraphBatch,
           noise: Optional[NoiseSource] = None,
           return_trajectory: bool = False) -> SampleResult:
    """Generate one structure per entry of ``cond``.

    Args:
      denoise_fn: ``(species_ch, pos, spectrum, exo, t_norm, mask, edges)
        -> (eps_x, eps_h)``, e.g. a ``DiffusionDenoiser``. ``edges`` is None
        (dense topology) unless ``cfg.neighbor_k`` is set; then it is the
        kNN lists of the current positions, rebuilt at every call. With
        ``cfg.x_parameterization`` "x0" or "v" its coordinate output is
        read as that head and converted to epsilon.
      schedule: the full ``T+1`` schedule table, on ``cond``'s device.
      generator: source of the default noise; unused when ``noise`` is set.
      cond: conditioning batch; its ``spectrum``, ``exo`` and ``mask`` drive
        generation (``species`` too when species are not diffused).
      noise: optional replacement source of standard-normal draws.
      return_trajectory: keep the (pos, h) entering reverse steps 0,
        ``cfg.snapshot_every``, ... of the chain (``SampleResult.trajectory``);
        the draws and the result are the same either way.
    """
    if noise is None:
        device = cond.device

        def noise(shape):
            return torch.randn(tuple(shape), generator=generator,
                               device=device)
    return run_chain(ReverseChain(denoise_fn, schedule, cfg, cond), noise,
                     return_trajectory)


def sample_with_grad(denoise_fn: Callable, schedule: Schedule, cfg: Config,
                     cond: GraphBatch, noise: NoiseSource) -> SampleResult:
    """``sample`` under autograd, with the draws from ``noise``: each
    denoiser call is checkpointed (non-reentrant, so that
    ``torch.autograd.grad`` works through it) and recomputed in the
    backward; a learned ``schedule`` carries its gradient too."""
    def call(*args):
        return checkpoint(denoise_fn, *args, use_reentrant=False)

    return run_chain(ReverseChain(call, schedule, cfg, cond), noise)


def sample_with_retry(denoise_fn: Callable, schedule: Schedule, cfg: Config,
                      generator: Optional[torch.Generator], cond: GraphBatch,
                      noise: Optional[NoiseSource] = None,
                      return_trajectory: bool = False) -> SampleResult:
    """``sample``, then re-draw the entries that were not accepted, keeping
    the accepted ones (their trajectories too, over batch axis 1), for at
    most ``cfg.max_nan_retries`` rounds."""
    result = sample(denoise_fn, schedule, cfg, generator, cond, noise,
                    return_trajectory)
    for _ in range(cfg.max_nan_retries):
        if bool(result.accepted.all()):
            break
        retry = sample(denoise_fn, schedule, cfg, generator, cond, noise,
                       return_trajectory)
        take = ~result.accepted & retry.accepted

        def merge(old, new, axis=0):
            shape = [1] * old.ndim
            shape[axis] = -1
            return torch.where(take.reshape(shape), new, old)

        result = SampleResult(
            pos=merge(result.pos, retry.pos),
            species=merge(result.species, retry.species),
            h=merge(result.h, retry.h),
            finite=torch.where(take, retry.finite, result.finite),
            accepted=result.accepted | retry.accepted,
            trajectory=None if result.trajectory is None else tuple(
                merge(o, n, axis=1)
                for o, n in zip(result.trajectory, retry.trajectory)),
        )
    return result
