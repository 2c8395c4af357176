"""Progressive distillation of the reverse chain into a few-step student, as
``diffusion_model_tpu/train/distill.py`` (Salimans & Ho, ICLR 2022).

A student with half the steps is trained so that ONE of its deterministic
reverse steps lands where TWO of the teacher's land; then the student
becomes the next teacher, halving again (1000 -> 500 -> 250 -> 125 for
T = 1000). The deterministic step is linear in (z, eps),
``z_{t-1} = A z_t + B eps(z_t, t)`` (``step_coeffs``), so the one-step eps
that lands where the teacher's two steps land is
``(z_teacher(2 steps) - A_S z_t) / B_S``, clipped to ``target_clip``, and
the student regresses onto it with a plain eps-MSE. The species channel is
stepped on the scaled channel and stored back unscaled, as the sampler
does, so in h-units its step is ``h' = (A scale) h + B eps_h``. Grids are
dyadic subsets of the 0..T table, so a K-step student is sampled by the
strided sampler: ``cfg.replace(sample_steps=K, deterministic_sampling=True,
sample_grid="uniform")`` walks exactly the grid it was trained on when K
divides T.

The models are ``DiffusionDenoiser`` modules. Each phase's teacher is a
frozen copy of the student as the phase begins, called under ``no_grad``
(its weights cast once and kept, ``EGCL.compute_weights``); the student
trains under autograd (cast anew at every call, so its casts carry the
gradient), through the edge kernels on the card with ``ops.edge_grad``'s
backward. With ``cfg.neighbor_k`` the kNN lists are rebuilt from the
current positions at each of a step's three denoiser calls. The optimizer
is optax's ``chain(clip_by_global_norm(max_grad_norm), adam(lr))``, fresh
each phase.

Random draws come from an explicit ``torch.Generator`` (``draw``: per graph
the student step ``j ~ U{1..K}``, then the position noise, then the species
noise) or are handed in (``DistillDraws``), so a test can feed the JAX
package's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Iterable, Optional

import torch

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion.process import (
    Schedule,
    _bcast,
    diffuse_zero_to_t,
)
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train import optim


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """One phase's grid: the alpha table and each grid point's t/T on the
    ORIGINAL scale."""

    alphas: torch.Tensor   # [K+1]
    t_norm: torch.Tensor   # [K+1]

    @property
    def num_steps(self) -> int:
        return self.alphas.shape[0] - 1

    def halve(self) -> "PhaseSchedule":
        if self.num_steps % 2:
            raise ValueError(f"cannot halve odd step count {self.num_steps}")
        return PhaseSchedule(alphas=self.alphas[::2], t_norm=self.t_norm[::2])


def full_phase(schedule: Schedule) -> PhaseSchedule:
    t = schedule.num_timesteps
    return PhaseSchedule(
        alphas=schedule.alphas,
        t_norm=torch.arange(t + 1, dtype=torch.float32,
                            device=schedule.alphas.device) / t)


def step_coeffs(alphas: torch.Tensor, t):
    """(A, B) of the deterministic reverse step t -> t-1 on grid ``alphas``
    (``t`` an int or ``[B]``): ``z_{t-1} = A z_t + B eps``, as
    ``reverse_diffuse_one_step(..., deterministic=True)``. A near-flat
    segment of a learned schedule makes ``sigma2_ts`` a cancellation that
    can round negative: it is clamped at 0, so B <= 0."""
    alpha_t = alphas[t]
    alpha_s = alphas[t - 1]
    sq_sigma_t = 1.0 - alpha_t ** 2
    alpha_ts = alpha_t / alpha_s
    sq_sigma_ts = torch.clamp_min(
        sq_sigma_t - alpha_ts ** 2 * (1.0 - alpha_s ** 2), 0.0)
    a = 1.0 / alpha_ts
    b = -sq_sigma_ts / (alpha_ts * torch.sqrt(sq_sigma_t))
    return a, b


@dataclasses.dataclass(frozen=True)
class DistillDraws:
    """The draws of one ``distill_loss``: per graph the student step ``j``
    ``[B]`` (1..K), and raw standard-normal position ``[B, N, 3]`` and
    species ``[B, N, A]`` noise (None without ``diffuse_species``)."""

    j: torch.Tensor
    pos: torch.Tensor
    h: Optional[torch.Tensor]


def draw(generator: torch.Generator, student_steps: int, batch: GraphBatch,
         diffuse_species: bool) -> DistillDraws:
    """``DistillDraws`` from ``generator``, in the order j, pos, h."""
    b = batch.batch_size
    kw = dict(generator=generator, device=batch.device)
    j = torch.randint(1, student_steps + 1, (b,), **kw)
    pos = torch.randn(tuple(batch.pos.shape), **kw)
    h = (torch.randn(tuple(batch.species.shape), **kw) if diffuse_species
         else None)
    return DistillDraws(j=j, pos=pos, h=h)


def _make_denoise(cfg: Config, cond: GraphBatch) -> Callable:
    """``denoise(model, pos, h, t_norm [B])``: the sampler's feature
    assembly (per-graph t/T over the real nodes, the species channel
    scaled by ``onehot_scaling_factor``, kNN lists of ``pos`` where
    ``cfg.neighbor_k``)."""
    scale = cfg.onehot_scaling_factor
    mask = cond.mask
    m3 = mask.unsqueeze(-1)

    def denoise(model, pos, h, t_norm_g):
        t_norm = t_norm_g[:, None, None] * torch.ones_like(m3) * m3
        edges = (knn_edges(pos.detach(), mask, cfg.neighbor_k)
                 if cfg.neighbor_k else None)
        return model(scale * h, pos, cond.spectrum, cond.exo, t_norm, mask,
                     edges)

    return denoise


def distill_loss(student, teacher, cfg: Config,
                 teacher_phase: PhaseSchedule, student_phase: PhaseSchedule,
                 batch: GraphBatch,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[DistillDraws] = None,
                 target_clip: float = 20.0) -> torch.Tensor:
    """Two-for-one eps-matching loss of ``student`` on one batch.

    Noise the clean batch to student grid point j (teacher point 2j), run
    the teacher's two deterministic steps, solve for the one-step eps that
    reproduces the teacher's landing point (clipped to ``target_clip``, the
    paper's x-clipping: at the top step the teacher's first half-step
    multiplies its own error by ``alpha_{T-1}/alpha_T``), and sum the
    student's squared error over the real nodes over the graphs with any
    real node. The draws are ``draws``, or are drawn from ``generator``."""
    if cfg.x_parameterization != "eps":
        # the two-for-one target algebra reads raw network outputs as
        # epsilon
        raise NotImplementedError(
            "progressive distillation supports x_parameterization='eps' "
            f"only (got {cfg.x_parameterization!r})")
    if draws is None:
        draws = draw(generator, student_phase.num_steps, batch,
                     cfg.diffuse_species)
    m3 = batch.mask.unsqueeze(-1)
    j = draws.j
    s_sched = Schedule(alphas=student_phase.alphas)
    pos_t, _ = diffuse_zero_to_t(s_sched, draws.pos, batch.pos, j,
                                 mode="pos", mask=batch.mask)
    if cfg.diffuse_species:
        h_t, _ = diffuse_zero_to_t(s_sched, draws.h, batch.species, j,
                                   mode="h", mask=batch.mask)
    else:
        h_t = batch.species
    denoise = _make_denoise(cfg, batch)
    scale = cfg.onehot_scaling_factor

    def teacher_step(pos, h, t_idx):
        eps_x, eps_h = denoise(teacher, pos, h, teacher_phase.t_norm[t_idx])
        a, bb = step_coeffs(teacher_phase.alphas, t_idx)
        new_pos = (_bcast(a, pos) * pos + _bcast(bb, eps_x) * eps_x) * m3
        if cfg.diffuse_species:
            h = (_bcast(a * scale, h) * h + _bcast(bb, eps_h) * eps_h) * m3
        return new_pos, h

    with torch.no_grad():
        tt = 2 * j
        z1_pos, z1_h = teacher_step(pos_t, h_t, tt)
        z2_pos, z2_h = teacher_step(z1_pos, z1_h, tt - 1)
        a_s, b_s = step_coeffs(student_phase.alphas, j)
        a_s3 = _bcast(a_s, pos_t)
        # B <= 0 after the clamp; ~0 on a near-flat segment: floored so the
        # target stays finite (the clip then bounds it)
        inv_b = _bcast(1.0 / torch.clamp_max(b_s, -1e-8), pos_t)
        eps_x_tgt = torch.clamp((z2_pos - a_s3 * pos_t) * inv_b,
                                -target_clip, target_clip) * m3
        if cfg.diffuse_species:
            eps_h_tgt = torch.clamp((z2_h - a_s3 * scale * h_t) * inv_b,
                                    -target_clip, target_clip) * m3

    eps_x_s, eps_h_s = denoise(student, pos_t, h_t, student_phase.t_norm[j])
    sq = torch.sum(((eps_x_s - eps_x_tgt) ** 2) * m3)
    if cfg.diffuse_species:
        sq = sq + torch.sum(((eps_h_s - eps_h_tgt) ** 2) * m3)
    num_graphs = torch.clamp_min(
        torch.sum(torch.any(batch.mask > 0, dim=-1).to(sq.dtype)), 1.0)
    return sq / num_graphs


@dataclasses.dataclass(frozen=True)
class DistillResult:
    params: dict     # the student denoiser's state dict (bare names)
    num_steps: int


def fresh_copy(model, trainable: bool):
    """A copy of ``model`` that keeps none of its cast weights, its
    parameters trainable or frozen."""
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if hasattr(m, "drop_compute_weights"):
            m.drop_compute_weights()
    return twin.requires_grad_(trainable)


def progressive_distill(
    cfg: Config,
    model,
    schedule: Schedule,
    batches_fn: Callable[[], Iterable[GraphBatch]],
    final_steps: int,
    epochs_per_phase: int = 50,
    lr: float = 1e-4,
    target_clip: float = 20.0,
    log_fn: Callable[[str], None] = lambda s: None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Callable[[int, GraphBatch], DistillDraws]] = None,
) -> DistillResult:
    """Distil ``model`` (a ``DiffusionDenoiser`` holding the teacher's
    eval parameters; left as it is) down to a ``final_steps`` student.

    Args:
      schedule: the teacher's full T-step table; ``T / final_steps`` must
        be a power of two.
      batches_fn: one epoch of clean batches, re-invoked every epoch.
      epochs_per_phase: epochs per halving; the loss is logged through
        ``log_fn`` every ``max(1, epochs_per_phase // 5)`` epochs.
      generator: the source of each step's draws, unless ``noise(K,
        batch)`` gives them (K the phase's student steps).

    Returns a ``DistillResult``: sample the student with
    ``cfg.replace(sample_steps=result.num_steps,
    deterministic_sampling=True, sample_grid="uniform")``."""
    t = schedule.num_timesteps
    ratio = t // final_steps
    if final_steps * ratio != t or ratio < 1 or (ratio & (ratio - 1)):
        raise ValueError(
            f"T={t} -> final_steps={final_steps}: ratio must be a power of 2")
    if generator is None and noise is None:
        raise ValueError("progressive_distill needs a generator or noise")

    phase = full_phase(schedule)
    student = fresh_copy(model, trainable=True)
    params = dict(student.named_parameters())
    opt = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm),
                      optim.scale_by_adam(), optim.scale(-lr))

    while phase.num_steps > final_steps:
        teacher = fresh_copy(student, trainable=False)
        teacher_phase = phase
        phase = phase.halve()
        opt_state = opt.init(params)
        for epoch in range(epochs_per_phase):
            last = None
            for batch in batches_fn():
                draws = None if noise is None else noise(phase.num_steps,
                                                         batch)
                loss = distill_loss(student, teacher, cfg, teacher_phase,
                                    phase, batch, generator, draws,
                                    target_clip)
                parts = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(params.items(), parts)}
                updates, opt_state = opt.update(grads, opt_state, params)
                optim.apply_updates(params, updates)
                last = loss.detach()
            if epoch % max(1, epochs_per_phase // 5) == 0:
                log_fn(f"phase {teacher_phase.num_steps}->{phase.num_steps} "
                       f"epoch {epoch}: loss {float(last):.3e}")

    return DistillResult(
        params={k: p.detach().clone() for k, p in params.items()},
        num_steps=phase.num_steps)
