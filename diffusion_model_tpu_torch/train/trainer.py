"""Training engine of the port: optimizer factory, train and eval steps,
epochs, early stopping, as ``diffusion_model_tpu/train/trainer.py``.

The optimizers are optax's rules (``train.optim``): global-norm clipping,
then Adam with coupled L2, AdamW with amsgrad, or schedule-free RAdam
(``optax.contrib.schedule_free`` over ``radam(lr, b1=0)``), and optionally
an EMA of the parameters. Evaluation runs at ``TrainState.eval_params``: the
EMA, the schedule-free average x, or the parameters.

The denoiser's dense route is the pair kernel (K1) and its kNN route the kNN
kernel (K2), each paired with the autograd of its plain statement
(``ops.edge_grad``), as the JAX package pairs its Pallas kernels in a
``custom_vjp``. On the CPU every step is plain PyTorch. A learned schedule's
gamma network trains through the loss jointly with the denoiser, with the
VDM boundary terms (``_gamma_boundary``). With ``kabsch_loss`` a train step
also runs the reverse chain under autograd (``diffusion.sampler.
sample_with_grad``, each denoiser call checkpointed) and adds the Kabsch RMSD
of its structures against the batch's (``_kabsch_loss``); the eval step
leaves that term out, as the JAX package's does.

Random draws come from a noise source (``train.loss.TrainNoise``); the loss
of an epoch is summed on the device and read once at its end.

``cfg.debug_nans`` (the JAX package's ``jax_debug_nans``) runs every train
step's forward and backward under ``torch.autograd.detect_anomaly()`` and
raises ``FloatingPointError`` on a non-finite loss, or on a non-finite
gradient naming its leaf, before the optimizer steps.

Data parallelism (``mesh=`` of the steps and epochs, a ``parallel.Mesh``):
every rank of the mesh gets the same global batch and keeps its rows
(``_place``, the JAX ``_place``); it draws the global batch's noise and
keeps its rows, divides its part of the loss by the global count of real
graphs, and the ranks sum their gradients with one ``all_reduce`` before
the optimizer, which then steps identically on each (the parameters are
replicated once by ``replicate``). A learned schedule's boundary term is
computed from the global sums and added on the first rank alone. So a step
equals the one-process step on the global batch, up to the order of the
sums. ``ring_train_step_fn`` trains one graph whose node axis is split
over a mesh axis (``parallel.ring``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional

import torch
import torch.distributed as dist

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion.process import (
    Schedule,
    head_out_to_eps,
    learned_schedule,
    predefined_schedule,
    x_param_is_x0,
)
from diffusion_model_tpu_torch.diffusion.sampler import sample_with_grad
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.gamma import (
    GammaNetwork,
    fit_gamma_to_schedule,
)
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges
from diffusion_model_tpu_torch.ops.kabsch import kabsch_rmsd
from diffusion_model_tpu_torch.parallel.mesh import dp_batch_sharding
from diffusion_model_tpu_torch.train import optim
from diffusion_model_tpu_torch.train.checkpoint import (
    flax_from_state_dict,
    gamma_flax_from_state_dict,
    gamma_state_dict_from_flax,
    state_dict_from_flax,
)
from diffusion_model_tpu_torch.train.loss import (
    BatchRows,
    diffuse_batch,
    epsilon_loss,
    t_band_weights,
)


def make_optimizer(cfg: Config) -> optim.Transform:
    """Adam / AdamW(amsgrad) / schedule-free RAdam after global-norm
    clipping at ``max_grad_norm``, with an EMA tail where ``ema_decay`` > 0
    (not with schedule-free, which averages already). As in the JAX
    package, schedule-free applies no ``weight_decay``."""
    lr = cfg.lr
    if cfg.optimizer == "Adam":
        base = optim.chain(optim.scale_by_adam(), optim.scale(-lr))
        if cfg.weight_decay:
            base = optim.chain(optim.add_decayed_weights(cfg.weight_decay),
                               base)
    elif cfg.optimizer == "AdamW":
        base = optim.chain(optim.scale_by_amsgrad(),
                           optim.add_decayed_weights(cfg.weight_decay),
                           optim.scale(-lr))
    elif cfg.optimizer == "RAdamScheduleFree":
        base = optim.schedule_free(
            optim.chain(optim.scale_by_radam(b1=0.0), optim.scale(-lr)), lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    parts = [optim.clip_by_global_norm(cfg.max_grad_norm), base]
    if cfg.ema_decay > 0.0:
        if cfg.optimizer == "RAdamScheduleFree":
            raise ValueError(
                "ema_decay > 0 is redundant with RAdamScheduleFree's "
                "built-in averaging; use optimizer='Adam'/'AdamW' with EMA")
        parts.append(optim.ema(cfg.ema_decay))
    return optim.chain(*parts)


@dataclasses.dataclass
class TrainState:
    """``params``: name -> the trained modules' own parameters
    (``denoiser.*``, ``gamma.*``), updated in place; ``opt_state``: the
    optimizer's state; ``step``: updates taken."""

    params: dict
    opt_state: Any
    step: int = 0

    def eval_params(self, cfg: Config) -> dict:
        """The parameters to evaluate and sample at: the EMA, the
        schedule-free average ``(y - (1 - b1) z) / b1``, or the
        parameters themselves."""
        if cfg.ema_decay > 0.0:
            return self.opt_state[-1].ema
        if cfg.optimizer == "RAdamScheduleFree":
            return optim.schedule_free_eval_params(self.opt_state[1],
                                                   self.params)
        return {k: p.detach() for k, p in self.params.items()}

    def clone(self) -> "TrainState":
        """A copy of the values (parameters and optimizer state)."""
        return TrainState({k: p.detach().clone()
                           for k, p in self.params.items()},
                          _clone_tree(self.opt_state), self.step)


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_tree(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree


def params_tree(params: dict) -> dict:
    """Name -> tensor (``denoiser.*``, ``gamma.*``) as the flax tree the
    snapshots hold: ``{"denoiser": {"params": ...}, "gamma": ...}``."""
    def part(prefix):
        return {k[len(prefix):]: v for k, v in params.items()
                if k.startswith(prefix)}

    tree = {"denoiser": flax_from_state_dict(part("denoiser."))}
    gamma = part("gamma.")
    if gamma:
        tree["gamma"] = gamma_flax_from_state_dict(gamma)
    return tree


class EarlyStopping:
    """Stop when the eval loss has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 0):
        self._step = 0
        self._loss = float("inf")
        self._patience = patience

    def validate(self, loss: float) -> bool:
        if self._loss < loss:
            self._step += 1
            if self._step > self._patience:
                return True
        else:
            self._step = 0
            self._loss = loss
        return False


class Trainer:
    """Owns the denoiser (and the gamma network of a learned schedule), the
    optimizer and their train and eval steps on ``device`` (default the
    card; the CPU only when asked for)."""

    def __init__(self, cfg: Config, device=None,
                 edge_fn: Callable = egcl_pair_edges,
                 knn_edge_fn: Callable = egcl_knn_edges):
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        self.optimizer = make_optimizer(cfg)
        self._modules = lambda: DiffusionDenoiser(
            cfg, edge_fn=edge_fn, knn_edge_fn=knn_edge_fn,
            device=self.device)
        self.model: Optional[DiffusionDenoiser] = None
        self.gamma: Optional[GammaNetwork] = None
        self._eval_model = self._eval_gamma = None
        self._static_schedule = (
            predefined_schedule(cfg, device=self.device)
            if cfg.noise_schedule == "predefined" else None)

    # -- init ----------------------------------------------------------
    def init_state(self, seed: int, params: Optional[dict] = None,
                   skip_gamma_fit: bool = False) -> TrainState:
        """A fresh state: the modules drawn from ``seed`` (the gamma network
        then fitted to the polynomial table where ``gamma_init`` says so,
        unless ``skip_gamma_fit``), or holding ``params`` (a flax tree as
        the snapshots hold, ``{"denoiser": ..., "gamma": ...}``), and a
        fresh optimizer state."""
        learned = self.cfg.noise_schedule == "learned"
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            self.model = self._modules()
            self.gamma = GammaNetwork(device=self.device) if learned else None
        if params is not None:
            self.model.load_state_dict(state_dict_from_flax(params))
            if learned:
                self.gamma.load_state_dict(gamma_state_dict_from_flax(params))
        elif learned and self.cfg.gamma_init == "polynomial" \
                and not skip_gamma_fit:
            fit_gamma_to_schedule(self.gamma, predefined_schedule(
                self.cfg, device=self.device).alphas)
        named = {f"denoiser.{k}": p for k, p in self.model.named_parameters()}
        if learned:
            named.update({f"gamma.{k}": p
                          for k, p in self.gamma.named_parameters()})
        return TrainState(named, self.optimizer.init(named))

    def denoise_fn(self, params: dict) -> DiffusionDenoiser:
        """The denoiser holding ``params`` (name -> tensor, as
        ``TrainState.eval_params`` gives them), frozen, for the sampler:
        called with the denoiser's arguments."""
        model = self._modules().requires_grad_(False)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params["denoiser." + k])
        return model

    # -- schedule ------------------------------------------------------
    def schedule_for(self, gamma: Optional[GammaNetwork]) -> Schedule:
        if self._static_schedule is not None:
            return self._static_schedule
        return learned_schedule(gamma, self.cfg.num_diffusion_timestep)

    # -- loss ----------------------------------------------------------
    def _loss(self, model, gamma, noise, batch: GraphBatch,
              kabsch: bool = True, dp: Optional["_DataParallel"] = None):
        """(loss, sum_sq, num_nodes) of ``model`` on ``batch`` noised by
        ``noise``'s draws; the Kabsch term where ``cfg.kabsch_loss`` and
        ``kabsch``. With ``dp`` the batch is this rank's rows of the global
        one, and the loss this rank's part of the global loss: the
        per-graph terms over the global count of real graphs, the boundary
        term on the first rank alone."""
        cfg = self.cfg
        schedule = self.schedule_for(gamma)
        pos_t, h_t, t, eps_pos, eps_h = diffuse_batch(schedule, cfg, noise,
                                                      batch)
        b, n = batch.mask.shape
        t_norm = (t.to(torch.float32)[:, None, None]
                  / cfg.num_diffusion_timestep) * torch.ones(
                      (b, n, 1), device=batch.device)
        t_norm = t_norm * batch.mask.unsqueeze(-1)
        edges = (knn_edges(pos_t.detach(), batch.mask, cfg.neighbor_k)
                 if cfg.neighbor_k else None)
        spectrum = batch.spectrum
        if cfg.cond_dropout_prob > 0:
            keep = noise.bernoulli("drop", 1.0 - cfg.cond_dropout_prob, (b,))
            spectrum = spectrum * keep[:, None, None].to(spectrum.dtype)
        eps_x_pred, eps_h_pred = model(h_t, pos_t, spectrum, batch.exo,
                                       t_norm, batch.mask, edges)
        if x_param_is_x0(cfg):
            # an x0 or v coordinate head, read as epsilon at the per-graph
            # t (through a learned schedule's table: gamma trains through
            # the conversion too); the species channel stays epsilon
            eps_x_pred = head_out_to_eps(cfg, schedule, t, pos_t, eps_x_pred)
        loss, sum_sq, num_nodes = epsilon_loss(
            eps_x_pred, eps_h_pred, eps_pos, eps_h, batch.mask,
            include_h=cfg.diffuse_species, weights=t_band_weights(cfg, t))
        if cfg.kabsch_loss and kabsch:
            loss = loss + cfg.kabsch_loss_weight * self._kabsch_loss(
                model, noise, batch, schedule)
        boundary = gamma is not None and cfg.gamma_boundary_weight > 0
        sums = (self._batch_sums(batch) if boundary or dp is not None
                else None)
        if dp is not None:
            # both terms so far are means over this rank's real graphs
            local = sums[2].clone()
            dist.all_reduce(sums, group=dp.group)
            loss = loss * (local / sums[2].clamp_min(1.0))
        if boundary and (dp is None or dp.index == 0):
            loss = loss + cfg.gamma_boundary_weight * self._gamma_boundary(
                schedule, batch, sums)
        return loss, sum_sq, num_nodes

    def _batch_sums(self, batch: GraphBatch) -> torch.Tensor:
        """``[real nodes, sum of x^2 over their real dimensions, real
        graphs]`` of ``batch``: what the boundary term reads of it."""
        m3 = batch.mask.unsqueeze(-1)
        x2_sum = ((batch.pos ** 2) * m3).sum()
        if self.cfg.diffuse_species:
            x2_sum = x2_sum + ((batch.species ** 2) * m3).sum()
        num_graphs = (batch.mask > 0).any(dim=-1).to(x2_sum.dtype).sum()
        return torch.stack([batch.num_nodes(), x2_sum, num_graphs])

    def _gamma_boundary(self, schedule: Schedule, batch: GraphBatch,
                        sums: Optional[torch.Tensor] = None):
        """The VDM boundary terms of a learned schedule (reconstruction at
        t = 0, prior KL at t = T), per real dimension, hinged at their
        clean-endpoint values and normalised as the eps loss is (summed
        over real dimensions, over the real graphs); gradients reach only
        the gamma parameters. ``sums``: ``_batch_sums`` of ``batch`` (by
        default), or of the global batch under data parallelism."""
        cfg = self.cfg
        if sums is None:
            sums = self._batch_sums(batch)
        a0 = schedule.alpha(0)
        a_t = schedule.alpha(cfg.num_diffusion_timestep)
        s0_sq = 1.0 - a0 ** 2
        st_sq = 1.0 - a_t ** 2
        d2 = cfg.gamma_rec_floor ** 2
        dims = 3.0 + (cfg.atom_type_size if cfg.diffuse_species else 0.0)
        n_dims = sums[0] * dims
        x2_sum = sums[1]
        rec = torch.maximum(0.5 * torch.log((s0_sq + d2) / a0 ** 2),
                            torch.log(torch.tensor(2.0 * d2)).to(a0) * 0.5)
        prior = torch.clamp_min(
            0.5 * (a_t ** 2 * (x2_sum / n_dims.clamp_min(1.0))
                   + st_sq - 1.0 - torch.log(st_sq)), 1e-4)
        num_graphs = sums[2].clamp_min(1.0)
        return (rec + prior) * n_dims / num_graphs

    def _kabsch_loss(self, model, noise, batch: GraphBatch,
                     schedule: Schedule):
        """The mean Kabsch RMSD, over the real graphs, between the
        structures of a reverse chain run under autograd (the draws from
        the ``"kabsch"`` stream) and the batch's own. The chain takes
        ``kabsch_loss_steps`` strided steps (the sampler's own uniform
        grid; every step at 0). A zero-mask padded row would hand the SVD a
        zero covariance, whose gradient is not finite: such rows are scored
        on a fixed well-conditioned template instead, and left out of the
        mean."""
        cfg = self.cfg
        steps = cfg.kabsch_loss_steps or cfg.num_diffusion_timestep
        sub_cfg = cfg.replace(sample_steps=steps, sample_grid="uniform")
        res = sample_with_grad(model, schedule, sub_cfg, batch,
                               lambda shape: noise.normal("kabsch", shape))
        real = (batch.mask > 0).any(dim=-1)
        t = torch.arange(batch.pos.shape[1], dtype=batch.pos.dtype,
                         device=batch.device)
        template = torch.stack([torch.sin(t), torch.cos(1.3 * t),
                                torch.sin(2.7 * t + 1.0)], dim=-1)
        r3 = real[:, None, None]
        gen_pos = torch.where(r3, res.pos, 1.5 * template + 1.0)
        ref_pos = torch.where(r3, batch.pos, template)
        mask_safe = torch.where(real[:, None], batch.mask,
                                torch.ones_like(batch.mask))
        rmsd = kabsch_rmsd(gen_pos, ref_pos, mask_safe)
        total = torch.where(real, rmsd, torch.zeros_like(rmsd)).sum()
        return total / real.to(rmsd.dtype).sum().clamp_min(1.0)

    # -- steps ---------------------------------------------------------
    def _place(self, batch: GraphBatch, noise, mesh):
        """(this rank's rows of the global ``batch``, a noise source that
        draws for the global batch and keeps those rows, the data-parallel
        group) on ``mesh``; ``(batch, noise, None)`` without one. The JAX
        ``_place``: ``shard_graph_batch(batch, mesh, mode="dp")``."""
        if mesh is None:
            return batch, noise, None
        layout = dp_batch_sharding(mesh)
        rows = layout.block(0, batch.batch_size)
        group, ranks = mesh.group_over(layout.axes(0))
        return (batch.map(layout.local),
                BatchRows(noise, rows, batch.batch_size),
                _DataParallel(group, ranks.index(dist.get_rank())))

    def loss_and_grads(self, state: TrainState, noise, batch: GraphBatch,
                       mesh=None):
        """(loss, sum_sq, num_nodes, grads name -> tensor) at the trained
        modules' parameters; on ``mesh`` those of the global batch, the
        same on every rank (the gradients summed over the ranks)."""
        batch, noise, dp = self._place(batch, noise, mesh)
        if self.cfg.debug_nans:
            with torch.autograd.detect_anomaly():
                out = self._loss_and_grads(state, noise, batch, True, dp)
        else:
            out = self._loss_and_grads(state, noise, batch, False, dp)
        return out if dp is None else _summed(out, dp.group)

    def _loss_and_grads(self, state, noise, batch, check: bool, dp=None):
        loss, sum_sq, num_nodes = self._loss(self.model, self.gamma, noise,
                                             batch, dp=dp)
        if check and not bool(torch.isfinite(loss)):
            raise FloatingPointError(
                f"debug_nans: the loss is {float(loss.detach())}")
        params = state.params
        parts = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), parts)}
        if check:
            for k, g in grads.items():
                if not bool(torch.isfinite(g).all()):
                    raise FloatingPointError(
                        f"debug_nans: the gradient of {k} is not finite")
        return loss.detach(), sum_sq.detach(), num_nodes, grads

    def _apply(self, state: TrainState, loss, sum_sq, num_nodes, grads):
        updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                   state.params)
        optim.apply_updates(state.params, updates)
        metrics = {"loss": loss, "sum_sq": sum_sq, "num_nodes": num_nodes,
                   "grad_norm": optim.global_norm(grads)}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    def train_step(self, state: TrainState, noise, batch: GraphBatch,
                   mesh=None):
        """One optimizer step: (state, metrics ``loss``, ``sum_sq``,
        ``num_nodes``, ``grad_norm``, all tensors on the device); on
        ``mesh`` a data-parallel step over the global ``batch``."""
        return self._apply(state, *self.loss_and_grads(state, noise, batch,
                                                       mesh))

    @torch.no_grad()
    def replicate(self, state: TrainState, mesh) -> TrainState:
        """``state`` with the parameters and the optimizer state of the
        mesh's first rank on every rank (the JAX ``device_put(state,
        replicate(mesh))``), in place."""
        group, ranks = mesh.group_over(mesh.axis_names)
        for t in _tensors(state.params) + _tensors(state.opt_state):
            dist.broadcast(t, src=ranks[0], group=group)
        return state

    def _load_eval(self, params: dict) -> tuple:
        """The frozen evaluation modules, holding ``params``."""
        if self._eval_model is None:
            self._eval_model = self._modules().requires_grad_(False)
            if self.gamma is not None:
                self._eval_gamma = GammaNetwork(
                    device=self.device).requires_grad_(False)
        modules = {"denoiser.": self._eval_model, "gamma.": self._eval_gamma}
        with torch.no_grad():
            for prefix, module in modules.items():
                if module is None:
                    continue
                for k, p in module.named_parameters():
                    p.copy_(params[prefix + k])
        return self._eval_model, self._eval_gamma

    def eval_step(self, state: TrainState, noise, batch: GraphBatch) -> dict:
        """``sum_sq`` and ``num_nodes`` at ``state.eval_params``."""
        return self._eval_batch(self._load_eval(state.eval_params(self.cfg)),
                                noise, batch)

    @torch.no_grad()
    def _eval_batch(self, modules, noise, batch) -> dict:
        # the eval step reads sum_sq alone: no reverse chain for the
        # Kabsch term it would throw away
        _, sum_sq, num_nodes = self._loss(*modules, noise, batch,
                                          kabsch=False)
        return {"sum_sq": sum_sq, "num_nodes": num_nodes}

    # -- ring (node-sharded) training ----------------------------------
    def ring_train_step_fn(self, mesh, axis: str = "data") -> Callable:
        """A train step through the ring (``parallel.ring``) for one graph a
        step whose node axis is split over ``axis``, as the JAX
        ``ring_train_step_fn``: ``step(state, noise, batch) -> (state,
        metrics)``. Every rank noises the whole graph with the same draws
        (the dense loss's streams: ``diffuse_batch``, then the
        conditioning-dropout Bernoulli), keeps its block of nodes, and
        takes the loss of its block over the graph count; the sum over the
        ring of the ranks' parts is the dense loss, and the gradients are
        summed once before the optimizer. The coordinate head's conversion
        and the t-band weights are the dense loss's; a learned schedule's
        gamma runs on every rank over the whole graph, its boundary term
        added on the first rank of the ring alone."""
        if self.cfg.kabsch_loss:
            # the Kabsch term differentiates through the whole reverse
            # chain every step, a small-cluster objective; at ring scale
            # that is T sharded forwards a step, and leaving it out would
            # train another objective
            raise NotImplementedError(
                "kabsch_loss is not routed through the ring (the whole "
                "reverse chain a step is a small-cluster objective; use the "
                "dense path for Kabsch training)")
        from diffusion_model_tpu_torch.parallel.ring import (
            ring_denoise_apply,
        )

        cfg = self.cfg
        apply_fn = ring_denoise_apply(cfg, mesh, axis)
        group, ranks = mesh.lines[axis]
        place = mesh.axis_index(axis)

        def loss_fn(noise, batch: GraphBatch):
            if batch.mask.shape[0] != 1:
                # one ring is one graph: the single prediction would meet
                # every graph's noise targets in the loss
                raise ValueError(
                    "ring training takes exactly one node-sharded graph "
                    f"per step (got batch_size={batch.mask.shape[0]})")
            schedule = self.schedule_for(self.gamma)
            pos_t, h_t, t, eps_pos, eps_h = diffuse_batch(schedule, cfg,
                                                          noise, batch)
            b, n = batch.mask.shape
            t_norm = (t.to(torch.float32)[:, None, None]
                      / cfg.num_diffusion_timestep) * torch.ones(
                          (b, n, 1), device=batch.device)
            t_norm = t_norm * batch.mask.unsqueeze(-1)
            spectrum = batch.spectrum
            if cfg.cond_dropout_prob > 0:
                keep = noise.bernoulli("drop", 1.0 - cfg.cond_dropout_prob,
                                       (b,))
                spectrum = spectrum * keep[:, None, None].to(spectrum.dtype)
            eps_x_pred, eps_h_pred = apply_fn(
                self.model, h_t[0], pos_t[0], spectrum[0], batch.exo[0],
                t_norm[0], batch.mask[0])
            width = n // len(ranks)
            blk = slice(place * width, (place + 1) * width)
            if x_param_is_x0(cfg):
                eps_x_pred = head_out_to_eps(
                    cfg, schedule, t, pos_t[:, blk], eps_x_pred[None])[0]
            loss, sum_sq, num_nodes = epsilon_loss(
                eps_x_pred[None], eps_h_pred[None], eps_pos[:, blk],
                eps_h[:, blk], batch.mask[:, blk],
                include_h=cfg.diffuse_species,
                weights=t_band_weights(cfg, t))
            if (self.gamma is not None and cfg.gamma_boundary_weight > 0
                    and place == 0):
                loss = loss + cfg.gamma_boundary_weight * \
                    self._gamma_boundary(schedule, batch)
            return loss, sum_sq, num_nodes

        def step(state: TrainState, noise, batch: GraphBatch):
            params = state.params
            loss, sum_sq, num_nodes = loss_fn(noise, batch)
            parts = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), parts)}
            out = _summed((loss.detach(), sum_sq.detach(), num_nodes,
                           grads), group)
            return self._apply(state, *out)

        return step

    # -- epochs --------------------------------------------------------
    def train_epoch(self, state: TrainState, noise,
                    batches: Iterable[GraphBatch], mesh=None) -> tuple:
        """One pass over ``batches``: (state, summed squared error per real
        node), the sums kept on the device and read once; on ``mesh`` each
        batch is the global one and each step data-parallel."""
        total = torch.zeros(2, device=self.device)
        for batch in batches:
            state, m = self.train_step(state, noise, batch, mesh)
            total = total + torch.stack([m["sum_sq"], m["num_nodes"]])
        sq, nodes = total.tolist()
        return state, sq / max(nodes, 1.0)

    def eval_epoch(self, state: TrainState, noise,
                   batches: Iterable[GraphBatch], mesh=None) -> float:
        """Summed squared error per real node at ``state.eval_params`` (over
        the global batches on ``mesh``, summed over the ranks once)."""
        modules = self._load_eval(state.eval_params(self.cfg))
        total = torch.zeros(2, device=self.device)
        for batch in batches:
            batch, batch_noise, _ = self._place(batch, noise, mesh)
            m = self._eval_batch(modules, batch_noise, batch)
            total = total + torch.stack([m["sum_sq"], m["num_nodes"]])
        if mesh is not None:
            group, _ = mesh.group_over(dp_batch_sharding(mesh).axes(0))
            dist.all_reduce(total, group=group)
        sq, nodes = total.tolist()
        return sq / max(nodes, 1.0)

    @torch.no_grad()
    def restore(self, state: TrainState, saved: TrainState) -> TrainState:
        """``state`` with the values of ``saved`` (a ``clone``) written back
        into the trained modules' parameters."""
        for k, p in state.params.items():
            p.copy_(saved.params[k])
        return TrainState(state.params, _clone_tree(saved.opt_state),
                          saved.step)


@dataclasses.dataclass(frozen=True)
class _DataParallel:
    """The ranks whose gradients a data-parallel step sums: their process
    group, and this rank's place among them."""

    group: Any
    index: int


def _tensors(tree) -> list:
    """The tensors of a state tree (dicts, tuples, named tuples), in a
    fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return []


def _all_reduced(tensors: list, group) -> list:
    """The sums of ``tensors`` over ``group``, through one ``all_reduce`` of
    their concatenation."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _summed(out: tuple, group) -> tuple:
    """``(loss, sum_sq, num_nodes, grads)`` summed over ``group``."""
    loss, sum_sq, num_nodes, grads = out
    names = list(grads)
    summed = _all_reduced([loss, sum_sq, num_nodes]
                          + [grads[k] for k in names], group)
    return (*summed[:3], dict(zip(names, summed[3:])))
