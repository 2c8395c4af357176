"""Shared inputs for the PyTorch port's tests and for ``chip_smoke.py``.

``build()`` makes, with the JAX package on the CPU:

  * the flagship's 27 test conditions: ``synthetic_sio2_dataset(2024, 256,
    16, spectrum_size=200, shells=2)`` split with ``split_dataset(., 2024)``
    (the recipe of ``benchmarks/npz_restore_check.py``), padded to 16 nodes;
  * the 192-atom headline cell ``amorphous_cell(seed=0, num_atoms=192,
    spectrum_size=200)`` of ``bench.py``;
  * goldens of ``DiffusionDenoiser.apply`` on the ``artifacts/q_predef_r5.npz``
    weights, in float32 and in bfloat16, at t/T = 0.1, 0.5 and 0.9 on the
    27 conditions noised from a numpy seed (the noisy inputs are stored):
    over the dense pair grid (``eps_x_float32`` ...) and over the kNN lists
    ``knn_edges(pos_t, mask, 6)`` (``knn6_eps_x_float32`` ...).

The committed copy is ``tests/fixtures/torch_port/flagship.npz``; the port's
GPU check reads it because the JAX package's data modules need JAX. A test
rebuilds it and compares, so it cannot go stale. To rewrite it:

    JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py

``build_train()`` makes the training fixture ``tests/fixtures/torch_port/
train.npz``, which ``chip_smoke.py`` holds the card's training step to: on
the first ``TRAIN_GRAPHS`` train graphs of the flagship's split, the draws
of ``Trainer._loss`` from ``jax.random.key(seed)`` (``jax_loss_draws``),
and the JAX package's loss, ``sum_sq``, per-leaf gradient norms and
per-leaf update norms of one ``RAdamScheduleFree`` step from the
``q_predef_r5`` weights, in float32 and in bfloat16; and, for the learned
recipe, the gamma network's initial parameters, its parameters after
``fit_gamma_to_schedule``'s 6000 steps, and that fit's alpha table.
``JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py`` rewrites both
files.

The module also replays the JAX sampler's random draws for the port's
noise source (``jax_sample_draws``, ``Replay``) and the JAX trainer's
(``jax_loss_draws``, ``ReplayDraws``), and makes inputs for the
EGCL edge functions (``edge_inputs``/``edge_args`` for the dense one,
``knn_inputs``/``knn_args`` for the kNN one). It imports JAX only inside
the functions that need it, so the card's tests can use the rest.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "flagship.npz"
TRAIN_FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "train.npz"
SNAPSHOT = REPO / "artifacts" / "q_predef_r5.npz"
LEARNED = REPO / "artifacts" / "q_learned_r5_s2025.npz"
TRAIN_GRAPHS = 16    # train graphs of the training fixture's batch
T_FRACS = (0.1, 0.5, 0.9)
KNN_K = 6            # neighbours per node of the kNN goldens
NUM_GRAPHS = 256     # dataset size the flagship was trained on
CELL_ATOMS = 192


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def flagship():
    """(JAX config, flax params) of the committed flagship snapshot."""
    _jax()
    from diffusion_model_tpu.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    return load_config_npz(str(SNAPSHOT)), load_params_npz(str(SNAPSHOT))


def flagship_conditions(cfg) -> list:
    """The flagship's test split as graph dicts (numpy)."""
    from diffusion_model_tpu.data.split import split_dataset
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset

    graphs = synthetic_sio2_dataset(cfg.seed, NUM_GRAPHS, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    return split_dataset(graphs, cfg.seed)[2]


def noisy_inputs(schedule_alphas: np.ndarray, pos, species, mask, t_frac,
                 seed):
    """Forward-noised (species_t, pos_t, t_norm) at t = round(t_frac * T)."""
    T = len(schedule_alphas) - 1
    t = int(round(t_frac * T))
    alpha = np.float32(schedule_alphas[t])
    sigma = np.float32(np.sqrt(1.0 - alpha ** 2))
    rng = np.random.default_rng(seed)
    m3 = mask[..., None]
    eps_x = rng.normal(size=pos.shape).astype(np.float32) * m3
    count = np.maximum(m3.sum(axis=1, keepdims=True), 1.0)
    eps_x = (eps_x - eps_x.sum(axis=1, keepdims=True) / count) * m3
    eps_h = rng.normal(size=species.shape).astype(np.float32) * m3
    pos_t = (alpha * pos + sigma * eps_x).astype(np.float32)
    species_t = (alpha * species + sigma * eps_h).astype(np.float32)
    t_norm = (np.float32(t / T) * m3).astype(np.float32)
    return species_t, pos_t, t_norm


def build() -> dict:
    """Every array of the fixture file, made anew."""
    jax = _jax()
    import jax.numpy as jnp

    from diffusion_model_tpu.data.batch import collate
    from diffusion_model_tpu.data.synthetic import amorphous_cell
    from diffusion_model_tpu.diffusion.process import predefined_schedule
    from diffusion_model_tpu.nn import DiffusionDenoiser
    from diffusion_model_tpu.ops.edges import knn_edges

    cfg, params = flagship()
    test = flagship_conditions(cfg)
    batch = collate(test, cfg.n_max)
    out = {
        "cond_pos": np.asarray(batch.pos),
        "cond_species": np.asarray(batch.species),
        "cond_spectrum": np.asarray(batch.spectrum),
        "cond_exo": np.asarray(batch.exo),
        "cond_mask": np.asarray(batch.mask),
        "cond_id": np.asarray([g["id"] for g in test]),
    }
    cell = amorphous_cell(seed=0, num_atoms=CELL_ATOMS,
                          spectrum_size=cfg.spectrum_size)
    for k in ("pos", "species", "spectrum", "exo"):
        out[f"cell_{k}"] = np.asarray(cell[k], np.float32)

    alphas = np.asarray(predefined_schedule(cfg).alphas)
    ins = [noisy_inputs(alphas, out["cond_pos"], out["cond_species"],
                        out["cond_mask"], frac, seed=100 + k)
           for k, frac in enumerate(T_FRACS)]
    out["t_frac"] = np.asarray(T_FRACS, np.float32)
    out["in_species_t"] = np.stack([i[0] for i in ins])
    out["in_pos_t"] = np.stack([i[1] for i in ins])
    out["in_t_norm"] = np.stack([i[2] for i in ins])
    topologies = {
        "": lambda pos: batch.pair_mask(),
        f"knn{KNN_K}_": lambda pos: knn_edges(pos, batch.mask, KNN_K),
    }
    for dt in ("float32", "bfloat16"):
        model = DiffusionDenoiser(cfg.replace(compute_dtype=dt))
        apply = jax.jit(model.apply)
        for prefix, edges in topologies.items():
            eps = [apply(params["denoiser"], jnp.asarray(sp), jnp.asarray(p),
                         batch.spectrum, batch.exo, jnp.asarray(tn),
                         batch.mask, edges(jnp.asarray(p)))
                   for sp, p, tn in ins]
            for i, field in enumerate(("eps_x", "eps_h")):
                out[f"{prefix}{field}_{dt}"] = np.stack(
                    [np.asarray(e[i], np.float32) for e in eps])
    return out


def flagship_train_batch(cfg, count: int = TRAIN_GRAPHS):
    """The first ``count`` graphs of the flagship's train split, collated by
    the JAX package."""
    from diffusion_model_tpu.data.batch import collate
    from diffusion_model_tpu.data.split import split_dataset
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset

    graphs = synthetic_sio2_dataset(cfg.seed, NUM_GRAPHS, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    return collate(split_dataset(graphs, cfg.seed)[0][:count], cfg.n_max)


def jax_loss_draws(key, cfg, b: int, n: int) -> dict:
    """The draws ``diffusion_model_tpu.train.Trainer._loss(params, key, .)``
    makes, by the port's stream names (``train.loss.TrainNoise.STREAMS``),
    each a list of numpy arrays in the order the port consumes them."""
    jax = _jax()
    k_diff, _, k_drop = jax.random.split(key, 3)
    k_t, k_pos, k_h = jax.random.split(k_diff, 3)
    T = cfg.num_diffusion_timestep
    draws = {"t": [jax.random.randint(k_t, (b,), 1, T + 1)],
             "pos": [jax.random.normal(k_pos, (b, n, 3))],
             "h": [jax.random.normal(k_h, (b, n, cfg.atom_type_size))]}
    if cfg.t_bias_frac > 0.0:
        k_sel = jax.random.fold_in(k_t, 0x7FFFFFFE)
        k_band = jax.random.fold_in(k_t, 0x7FFFFFFD)
        draws["t_band"] = [jax.random.randint(k_band, (b,), cfg.t_bias_lo,
                                              cfg.t_bias_hi + 1)]
        draws["t_sel"] = [jax.random.bernoulli(k_sel, cfg.t_bias_frac, (b,))]
    if cfg.cond_dropout_prob > 0:
        draws["drop"] = [jax.random.bernoulli(
            k_drop, 1.0 - cfg.cond_dropout_prob, (b,))]
    return {k: [np.asarray(a) for a in v] for k, v in draws.items()}


class ReplayDraws:
    """A port training noise source (``randint``, ``normal``,
    ``bernoulli``) that hands out recorded draws in order, stream by
    stream."""

    def __init__(self, draws: dict, device="cpu"):
        self.draws = {k: list(v) for k, v in draws.items()}
        self.device = device

    def _next(self, stream, shape, dtype):
        import torch

        if not self.draws.get(stream):
            raise AssertionError(f"no recorded {stream} draw left")
        d = self.draws[stream].pop(0)
        if tuple(d.shape) != tuple(shape):
            raise AssertionError(f"recorded {stream} draw has shape "
                                 f"{d.shape}, asked {tuple(shape)}")
        return torch.from_numpy(np.array(d, dtype)).to(self.device)

    def randint(self, stream, low, high, shape):
        return self._next(stream, shape, np.int64)

    def normal(self, stream, shape):
        return self._next(stream, shape, np.float32)

    def bernoulli(self, stream, p, shape):
        return self._next(stream, shape, bool)


def port_batch(batch, device="cpu"):
    """A JAX ``GraphBatch`` as the port's, through numpy."""
    import torch

    from diffusion_model_tpu_torch.data.batch import GraphBatch

    return GraphBatch(**{
        k: torch.from_numpy(np.array(getattr(batch, k), np.float32)).to(
            device) for k in ("pos", "species", "spectrum", "exo", "mask")})


def flat_leaves(tree: dict) -> dict:
    """A parameter tree's leaves by their ``/``-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in flat_leaves(v).items()})
        else:
            out[k] = v
    return out


def build_train() -> dict:
    """Every array of the training fixture, made anew (float32 and
    bfloat16 JAX train steps on ``TRAIN_GRAPHS`` flagship graphs, and the
    learned recipe's gamma fit)."""
    jax = _jax()
    import jax.numpy as jnp

    from diffusion_model_tpu.diffusion.process import (
        learned_schedule,
        predefined_schedule,
    )
    from diffusion_model_tpu.nn.gamma import (
        GammaNetwork,
        fit_gamma_to_schedule,
    )
    from diffusion_model_tpu.train import Trainer
    from diffusion_model_tpu.train.checkpoint import load_config_npz
    from diffusion_model_tpu.train.trainer import TrainState

    cfg, params = flagship()
    batch = flagship_train_batch(cfg)
    key = jax.random.key(cfg.seed)
    draws = jax_loss_draws(key, cfg, TRAIN_GRAPHS, cfg.n_max)
    out = {"train_pos": np.asarray(batch.pos),
           **{f"draw_{k}": v[0] for k, v in draws.items()}}
    names = sorted(flat_leaves(params))
    out["leaf_names"] = np.asarray(names)
    for dt in ("float32", "bfloat16"):
        trainer = Trainer(cfg.replace(compute_dtype=dt))
        (loss, (sum_sq, _)), grads = jax.jit(jax.value_and_grad(
            trainer._loss, has_aux=True))(params, key, batch)
        state = TrainState(params=params,
                           opt_state=trainer.optimizer.init(params),
                           step=jnp.zeros((), jnp.int32))
        new, _ = trainer.train_step(state, key, batch)
        g, old, upd = (flat_leaves(t) for t in (grads, params, new.params))
        out[f"loss_{dt}"] = np.float32(loss)
        out[f"sum_sq_{dt}"] = np.float32(sum_sq)
        out[f"grad_norm_{dt}"] = np.asarray(
            [np.linalg.norm(np.asarray(g[k], np.float32)) for k in names],
            np.float32)
        out[f"update_norm_{dt}"] = np.asarray(
            [np.linalg.norm(np.asarray(upd[k], np.float32)
                            - np.asarray(old[k], np.float32))
             for k in names], np.float32)
    lcfg = load_config_npz(str(LEARNED))
    gamma = GammaNetwork()
    gkey = jax.random.key(lcfg.seed)
    init = gamma.init(gkey, jnp.zeros((1, 1)))
    fitted, _ = fit_gamma_to_schedule(gamma, predefined_schedule(lcfg).alphas,
                                      gkey)
    for tag, tree in (("init", init), ("fit", fitted)):
        for k, v in flat_leaves(tree["params"]).items():
            out[f"gamma_{tag}_{k}"] = np.asarray(v, np.float32)
    out["gamma_fit_alphas"] = np.asarray(learned_schedule(
        gamma.apply, fitted, lcfg.num_diffusion_timestep).alphas)
    return out


def jax_sample_draws(key, b: int, n: int, a_dim: int, steps: int,
                     stochastic: bool) -> list:
    """The standard-normal draws ``diffusion_model_tpu.diffusion.sampler.
    sample(key, ...)`` makes, in the order the port's sampler consumes them
    (initial pos, initial h, then pos/h per step and for the epilogue)."""
    jax = _jax()

    def normal(k, shape):
        return np.asarray(jax.random.normal(k, shape))

    key, k_pos, k_h = jax.random.split(key, 3)
    draws = [normal(k_pos, (b, n, 3)), normal(k_h, (b, n, a_dim))]
    for _ in range(steps):
        key, k1, k2 = jax.random.split(key, 3)
        if stochastic:
            draws += [normal(k1, (b, n, 3)), normal(k2, (b, n, a_dim))]
    key, k1, k2 = jax.random.split(key, 3)
    if stochastic:
        draws += [normal(k1, (b, n, 3)), normal(k2, (b, n, a_dim))]
    return draws


class SnapshotState:
    """The one Trainer-state method ``diffusion_model_tpu.api.generate``
    calls, over a loaded snapshot's parameters."""

    def __init__(self, params):
        self._params = params

    def eval_params(self, cfg):
        return self._params


class Replay:
    """A port noise source that hands out recorded draws in order."""

    def __init__(self, draws, device="cpu"):
        self.draws = list(draws)
        self.device = device

    def __call__(self, shape):
        import torch

        if not self.draws:
            raise AssertionError(f"no recorded draw left for shape {shape}")
        d = self.draws.pop(0)
        if tuple(d.shape) != tuple(shape):
            raise AssertionError(
                f"recorded draw has shape {d.shape}, sampler asked {shape}")
        return torch.from_numpy(np.array(d, np.float32)).to(self.device)


EDGE_NAMES = ("am_i", "am_j", "ax_i", "ax_j", "x", "mask", "w_dm", "w_dx",
              "w2m", "b2m", "wa", "ba", "w2x", "b2x", "wx3", "bx3")
_EDGE_COMPUTE = {"am_i", "am_j", "ax_i", "ax_j", "w_dm", "w_dx", "w2m", "w2x"}


def edge_inputs(seed=0, b=2, n=16, f1=32, fm=16, n_real=(11, 16)) -> dict:
    """Numpy inputs of the EGCL edge function (K1's layout), graphs padded
    to ``n`` nodes with ``n_real[g]`` real ones, scaled to stay O(1)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = np.zeros((b, n, 1), np.float32)
    for g, k in enumerate(n_real):
        mask[g, :k] = 1.0
    return {
        "am_i": normal(b, n, f1, scale=0.5), "am_j": normal(b, n, f1, scale=0.5),
        "ax_i": normal(b, n, f1, scale=0.5), "ax_j": normal(b, n, f1, scale=0.5),
        "x": normal(b, n, 3, scale=2.0), "mask": mask,
        "w_dm": normal(1, f1, scale=0.1), "w_dx": normal(1, f1, scale=0.1),
        "w2m": normal(f1, fm, scale=f1 ** -0.5), "b2m": normal(1, fm, scale=0.1),
        "wa": normal(fm, 1, scale=fm ** -0.5), "ba": normal(1, 1, scale=0.1),
        "w2x": normal(f1, f1, scale=f1 ** -0.5), "b2x": normal(1, f1, scale=0.1),
        "wx3": normal(f1, 1, scale=f1 ** -0.5), "bx3": normal(1, 1, scale=0.1),
    }


def edge_args(inputs: dict, device="cpu", dtype=None) -> tuple:
    """``edge_inputs`` as torch tensors in argument order: the projections
    and the big kernels in ``dtype`` (default float32), the rest float32."""
    import torch

    dtype = dtype or torch.float32
    return tuple(
        torch.from_numpy(inputs[k]).to(
            device, dtype if k in _EDGE_COMPUTE else torch.float32)
        for k in EDGE_NAMES)


KNN_NAMES = ("am_i", "ax_i", "h", "x", "idx", "edge_mask", "wm_j", "wx_j",
             "w_dm", "w_dx", "w2m", "b2m", "wa", "ba", "w2x", "b2x", "wx3",
             "bx3")
_KNN_COMPUTE = {"am_i", "ax_i", "h", "wm_j", "wx_j", "w_dm", "w_dx", "w2m",
                "w2x"}


def knn_lists(x: np.ndarray, mask: np.ndarray, k: int):
    """Numpy statement of ``knn_edges``: the ``k`` nearest real neighbours
    of every node (self and padding excluded), nearest first; slots past
    the real neighbours and rows of padded nodes are masked."""
    n = x.shape[-2]
    d2 = ((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1)
    invalid = (1.0 - mask[..., :, None] * mask[..., None, :]) + np.eye(n)
    d2 = np.where(invalid > 0, np.inf, d2)
    idx = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    em = (np.take_along_axis(invalid, idx, axis=-1) == 0) * mask[..., None]
    return idx.astype(np.int32), em.astype(np.float32)


def knn_inputs(seed=0, b=2, n=16, k=4, hdim=10, f1=32, fm=16,
               n_real=(11, 16)) -> dict:
    """Numpy inputs of the kNN EGCL edge function (K2's layout), graphs
    padded to ``n`` nodes with ``n_real[g]`` real ones, neighbour lists
    from ``knn_lists``, scaled to stay O(1)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = np.zeros((b, n), np.float32)
    for g, real in enumerate(n_real):
        mask[g, :real] = 1.0
    x = normal(b, n, 3, scale=2.0)
    idx, em = knn_lists(x, mask, k)
    return {
        "am_i": normal(b, n, f1, scale=0.5), "ax_i": normal(b, n, f1, scale=0.5),
        "h": normal(b, n, hdim, scale=0.5), "x": x, "idx": idx,
        "edge_mask": em,
        "wm_j": normal(hdim, f1, scale=hdim ** -0.5),
        "wx_j": normal(hdim, f1, scale=hdim ** -0.5),
        "w_dm": normal(1, f1, scale=0.1), "w_dx": normal(1, f1, scale=0.1),
        "w2m": normal(f1, fm, scale=f1 ** -0.5), "b2m": normal(1, fm, scale=0.1),
        "wa": normal(fm, 1, scale=fm ** -0.5), "ba": normal(1, 1, scale=0.1),
        "w2x": normal(f1, f1, scale=f1 ** -0.5), "b2x": normal(1, f1, scale=0.1),
        "wx3": normal(f1, 1, scale=f1 ** -0.5), "bx3": normal(1, 1, scale=0.1),
    }


def knn_args(inputs: dict, device="cpu", dtype=None) -> tuple:
    """``knn_inputs`` as torch tensors in argument order: the projections,
    h and the big kernels in ``dtype`` (default float32), idx int32, the
    rest float32."""
    import torch

    dtype = dtype or torch.float32

    def tensor(k):
        want = (torch.int32 if k == "idx"
                else dtype if k in _KNN_COMPUTE else torch.float32)
        return torch.from_numpy(inputs[k]).to(device, want)

    return tuple(tensor(k) for k in KNN_NAMES)


def tpu_probe(name: str):
    """A fresh copy of the TPU probe ``benchmarks/<name>.py`` (it imports
    JAX), so a test may set its shape constants without touching another's."""
    import importlib.util

    _jax()
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


STAGE_NAMES = ("am_i", "am_j", "ax_i", "ax_j", "x", "mask", "qm", "qx",
               "w_dm", "w_dx", "w2m_q", "w2x_q", "wx3", "wa")
_STAGE_BF16 = ("am_i", "am_j", "ax_i", "ax_j", "w_dm", "w_dx")


def stage_inputs(seed=0, n=16, f1=32, fm=16, n_real=None) -> dict:
    """numpy inputs of the kernel-stages probe (one graph) at the TPU probe's
    scales; targets from ``n_real`` on are masked."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=0.5):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def quant(*shape):
        return np.clip(rng.normal(size=shape) * 40, -127, 127).astype(np.int8)

    mask = np.ones((1, n, 1), np.float32)
    mask[0, n if n_real is None else n_real:] = 0.0
    return {"am_i": normal(1, n, f1), "am_j": normal(1, n, f1),
            "ax_i": normal(1, n, f1), "ax_j": normal(1, n, f1),
            "x": normal(1, n, 3, scale=3.0), "mask": mask,
            "qm": quant(1, n * n, f1), "qx": quant(1, n * n, f1),
            "w_dm": normal(1, f1), "w_dx": normal(1, f1),
            "w2m_q": quant(f1, fm), "w2x_q": quant(f1, f1),
            "wx3": normal(f1, 1, scale=0.05), "wa": normal(fm, 1, scale=0.05)}


def stage_args(inputs: dict, device="cpu") -> tuple:
    """``stage_inputs`` as torch tensors in argument order (projections and
    w_d in bf16, the rest as drawn)."""
    import torch

    return tuple(
        torch.from_numpy(inputs[k]).to(device, torch.bfloat16)
        if k in _STAGE_BF16 else torch.from_numpy(inputs[k]).to(device)
        for k in STAGE_NAMES)


def main() -> int:
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    for path, make in ((FIXTURE, build), (TRAIN_FIXTURE, build_train)):
        np.savez_compressed(path, **make())
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
