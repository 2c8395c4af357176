"""Train the large-cell recipe on amorphous cells and score generation at
each requested size, the port's counterpart of
``examples/size_generalization.py`` (which needs JAX).

    python -m diffusion_model_tpu_torch.evals.size_gen_check \\
        --generator network --train_cells 96 --train_min 160 --train_max 192 \\
        --neighbor_k 32 --epochs 2000 --lr 2e-4 --max_grad_norm 1 \\
        --h_init_scale 1e-3 --h_residual --virtual_node --sizes 192 \\
        --gen_cells 16 --sample_steps 250 --chunk 4 \\
        --record docs/quality/size192net_lever_sweep.json \\
        --arm h_residual+virtual_node [--run_dir D] [--segment_epochs N]

The recipe is the example's: its flags map one to one onto the config
(bfloat16, ``gen_num_per_spectrum`` 2); training cells are
``make_cell(s, rng.integers(train_min, train_max + 1))`` for ``s`` in
``rng.integers(0, 2**31, train_cells)`` with ``rng = default_rng(seed)``,
evaluation cells ``make_cell(10_000 + size + i, size)``, each through
``data.synthetic.cached_cell`` under ``--cell_cache`` (the JAX example's key,
so either reads the other's entries). Training goes through
``api.train(..., resume=True)``: a call goes on from the run's newest
checkpoint, and with ``--segment_epochs`` stops after that many more epochs.
Once every epoch is done, each size is scored as the example scores it:
finite fraction, accepted count, generation seconds, the aggregate exO-RDF
cosine, nearest-neighbour distance medians, the O-density error,
``evals.amorphous.structure_panel`` and the resampling ceiling over the
distinct accepted conditions (``pairs=3``).

``--params`` scores a parameter npz (a run's float16 ``params.npz``) without
training, and ``--sample_seed`` draws the sampling noise from another seed
than the recipe's: the spread of the scores over sampling draws.

``--record`` and ``--arm`` put the record's numbers for that arm beside the
largest size's, with gates: the aggregate and the excess RDF cosine at least
the record's less 3 sqrt(2) of the 16-cell resampling sd the record states,
and a finite fraction of 1.

Prints one JSON line: the example's ``config`` name and ``sizes`` rows, the
loss curve every ``--curve_every`` epochs, the training's wall time, the
record and gates, and the card's name and power limit (``nvidia-smi``). On
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.synthetic import (
    amorphous_cell,
    amorphous_network_cell,
    cached_cell,
)
from diffusion_model_tpu_torch.evals.amorphous import (
    aggregate_exo_rdf,
    exo_rdf_resampling_ceiling,
    structure_panel,
)
from diffusion_model_tpu_torch.evals.density import o_density
from diffusion_model_tpu_torch.evals.rdf import rdf_metrics
from diffusion_model_tpu_torch.evals.retrain_check import (
    device_name,
    loss_curve,
)
from diffusion_model_tpu_torch.train.checkpoint import (
    latest_step,
    load_params_npz,
)
from diffusion_model_tpu_torch.train.trainer import params_tree

# Panel numbers the record holds beside the gated ones, shown ungated.
SHOWN = ("cn_si_mean_generated", "bond_peak_width_generated",
         "angle_siosi_w1_deg")


def nn_distances(pos: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Nearest-neighbour distance of each real atom of one structure."""
    n = int(mask.sum())
    p = pos[:n]
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.min(1)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", default="runs/size_gen")
    p.add_argument("--segment_epochs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--curve_every", type=int, default=50)
    p.add_argument("--record", default=None,
                   help="a lever sweep's JSON (docs/quality/...)")
    p.add_argument("--arm", default=None, help="the record's arm")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--params", default=None,
                   help="score this parameter npz (a run's params.npz) "
                        "instead of training")
    p.add_argument("--sample_seed", type=int, default=None,
                   help="seed of the sampling noise (default the recipe's)")
    p.add_argument("--seed", type=int, default=Config.seed,
                   help="the recipe's seed (training cells, initialisation, "
                        "training and sampling noise); the example has the "
                        "config's default")
    # the example's flags
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--train_cells", type=int, default=96)
    p.add_argument("--train_min", type=int, default=48)
    p.add_argument("--train_max", type=int, default=72)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--neighbor_k", type=int, default=16)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--L", type=int, default=5)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--m_size", type=int, default=256)
    p.add_argument("--sizes", default="72,96,144,192")
    p.add_argument("--gen_cells", type=int, default=8)
    p.add_argument("--chunk", type=int, default=4)
    p.add_argument("--sample_steps", type=int, default=0)
    p.add_argument("--virtual_node", action="store_true")
    p.add_argument("--global_radius", action="store_true")
    p.add_argument("--h_init_scale", type=float, default=1.0)
    p.add_argument("--h_residual", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--edge_rbf", type=int, default=0)
    p.add_argument("--t_bias_frac", type=float, default=0.0)
    p.add_argument("--t_loss_weight", type=float, default=1.0)
    p.add_argument("--x_parameterization", default="eps",
                   choices=("eps", "x0", "v"))
    p.add_argument("--init_from", default="")
    p.add_argument("--optimizer", default="RAdamScheduleFree",
                   choices=("RAdamScheduleFree", "Adam", "AdamW"))
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--cell_cache", default="runs/cell_cache")
    p.add_argument("--generator", default="packing",
                   choices=("packing", "network"))
    return p


def recipe(args) -> Config:
    """The example's config for ``args``."""
    return Config(
        seed=args.seed, n_max=args.train_max, neighbor_k=args.neighbor_k,
        L=args.L, m_hidden_size=args.hidden, h_hidden_size=args.hidden,
        x_hidden_size=args.hidden, m_size=args.m_size,
        batch_size=args.batch_size,
        num_diffusion_timestep=args.timesteps, num_epochs=args.epochs,
        lr=args.lr, max_grad_norm=args.max_grad_norm,
        optimizer=args.optimizer, ema_decay=args.ema_decay,
        compute_dtype="bfloat16", gen_num_per_spectrum=2,
        global_radius_feature=args.global_radius,
        virtual_node=args.virtual_node, h_init_scale=args.h_init_scale,
        h_residual=args.h_residual, remat_egcl=args.remat,
        edge_rbf=args.edge_rbf, t_bias_frac=args.t_bias_frac,
        t_loss_weight=args.t_loss_weight,
        x_parameterization=args.x_parameterization,
        checkpoint_every=args.checkpoint_every)


def config_name(args) -> str:
    """The example's name of the run, by which a record finds it."""
    return (f"size_gen_knn{args.neighbor_k}_train"
            f"{args.train_min}-{args.train_max}_{args.epochs}ep"
            f"_{args.generator}"
            f"_lr{args.lr:g}_clip{args.max_grad_norm:g}"
            + ("_hres" if args.h_residual else "")
            + (f"_{args.optimizer}" if args.optimizer
               != "RAdamScheduleFree" else "")
            + (f"_ema{args.ema_decay:g}" if args.ema_decay else "")
            + (f"_rbf{args.edge_rbf}" if args.edge_rbf else "")
            + (f"_tb{args.t_bias_frac:g}" if args.t_bias_frac else "")
            + (f"_tw{args.t_loss_weight:g}"
               if args.t_loss_weight != 1.0 else "")
            + (f"_L{args.L}" if args.L != 5 else "")
            + (f"_{args.x_parameterization}"
               if args.x_parameterization != "eps" else "")
            + ("_curr" if args.init_from else "")
            + ("_gr" if args.global_radius else "")
            + ("_vn" if args.virtual_node else ""))


def cell_maker(args, spectrum_size: int):
    """``make_cell(seed, num_atoms)`` of the example."""
    maker = (amorphous_network_cell if args.generator == "network"
             else amorphous_cell)

    def make_cell(seed: int, num_atoms: int) -> dict:
        kw = dict(seed=seed, num_atoms=num_atoms, spectrum_size=spectrum_size)
        if args.cell_cache:
            return cached_cell(maker, args.cell_cache, **kw)
        return maker(**kw)

    return make_cell


def train_cells(args, cfg: Config, make_cell) -> list:
    rng = np.random.default_rng(cfg.seed)
    return [make_cell(int(s),
                      int(rng.integers(args.train_min, args.train_max + 1)))
            for s in rng.integers(0, 2**31, args.train_cells)]


def score_size(args, cfg: Config, params: dict, make_cell, size: int,
               device, seed: int) -> tuple:
    """The example's row for ``size`` (sampling noise from ``seed``), and
    the positions it scored."""
    cfg_s = cfg.replace(n_max=size, sample_steps=args.sample_steps)
    cells = [make_cell(10_000 + size + i, size) for i in range(args.gen_cells)]
    generator = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    res = api.generate(cfg_s, params, cells, generator,
                       batch_size=args.chunk, device=device)
    gen_s = time.perf_counter() - t0
    keep = np.nonzero(res["accepted"])[0]
    row = {"finite_fraction": float(res["finite"].mean()),
           "accepted": int(len(keep)), "generate_seconds": round(gen_s, 1)}
    if not len(keep):
        return row, res
    gp, op, m = (res[k][keep] for k in ("generated_pos", "original_pos",
                                        "mask"))
    rdf_g = aggregate_exo_rdf(gp, m, device=device)
    rdf_o = aggregate_exo_rdf(op, m, device=device)
    row["aggregate_rdf_cos"] = round(
        float(rdf_metrics(rdf_o, rdf_g)["cos"]), 4)
    for name, pos in (("generated", gp), ("original", op)):
        row[f"nn_dist_median_{name}"] = round(float(np.median(
            np.concatenate([nn_distances(p_, m_)
                            for p_, m_ in zip(pos, m)]))), 3)
    dens_g = o_density(res["generated_species"][keep], m)
    dens_o = o_density(res["original_species"][keep], m)
    row["o_density_mae"] = round(float(np.mean(np.abs(dens_o - dens_g))), 4)
    row["panel"] = structure_panel(op, res["original_species"][keep], gp,
                                   res["generated_species"][keep], m,
                                   device=device)
    # the ceiling over the distinct accepted conditions: each repeats
    # gen_num_per_spectrum times in the aggregate
    distinct = len({res["ids"][i] for i in keep})
    row["rdf_ceiling"] = exo_rdf_resampling_ceiling(
        lambda s: make_cell(s, size), num_cells=distinct, pairs=3,
        device=device)
    return row, res


def against_record(record_path: str, arm: str, row: dict) -> dict:
    """The arm's recorded numbers beside ``row``'s, and the gates."""
    with open(record_path) as f:
        record = json.load(f)
    rec = record["arms"][arm]
    sd = record["ceilings_16cell_aggregate"]
    ours = {"aggregate_rdf_cos": row.get("aggregate_rdf_cos"),
            "finite_fraction": row["finite_fraction"],
            **{k: row.get("panel", {}).get(k)
               for k in ("excess_rdf_cos", *SHOWN)}}
    floor = {k: rec[k] - 3 * math.sqrt(2) * sd[k]["sd"]
             for k in ("aggregate_rdf_cos", "excess_rdf_cos")}
    gates = {k: ours[k] is not None and ours[k] >= v
             for k, v in floor.items()}
    gates["finite_fraction"] = ours["finite_fraction"] == 1.0
    out = {"arm": arm, "record_config": rec["config"], "record": rec,
           "port": ours, "floor": floor, "within_gate": gates}
    if "ctl" in record["arms"] and arm != "ctl":
        out["ctl"] = record["arms"]["ctl"]
    return out


def score(args, cfg: Config, params: dict, make_cell, device) -> dict:
    """Every size's row (positions saved beside ``--run_dir``), and the
    record's numbers beside the largest size's."""
    os.makedirs(args.run_dir, exist_ok=True)
    seed = cfg.seed if args.sample_seed is None else args.sample_seed
    results = {}
    for size in [int(s) for s in args.sizes.split(",")]:
        row, res = score_size(args, cfg, params, make_cell, size, device,
                              seed)
        np.savez_compressed(
            os.path.join(args.run_dir, f"positions_n{size}.npz"),
            **{k: res[k] for k in ("generated_pos", "original_pos",
                                   "generated_species", "original_species",
                                   "mask", "accepted")})
        results[f"n{size}"] = row
    out = {"sample_seed": seed, "sizes": results}
    if args.record and args.arm:
        largest = max(int(s) for s in args.sizes.split(","))
        out["against_record"] = against_record(args.record, args.arm,
                                               results[f"n{largest}"])
    return out


def run(args) -> dict:
    device = torch.device(args.device)
    cfg = recipe(args)
    make_cell = cell_maker(args, cfg.spectrum_size)
    out = {"config": config_name(args), "seed": cfg.seed,
           "card": device_name(device), "run_dir": args.run_dir}
    if args.params:
        out["params"] = args.params
        out.update(score(args, cfg, load_params_npz(args.params), make_cell,
                         device))
        return out
    ckpt_dir = os.path.join(args.run_dir, "checkpoints")
    start = latest_step(ckpt_dir) or 0
    stop = args.epochs if args.segment_epochs is None else min(
        args.epochs, start + args.segment_epochs)
    if stop > start:
        t0 = time.perf_counter()
        graphs = train_cells(args, cfg, make_cell)
        cells_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, (train_set, _, _) = api.train(
            cfg, graphs, args.run_dir, num_epochs=stop, device=device,
            resume=True, init_params_from=args.init_from or None)
        wall = time.perf_counter() - t0
        out["segment"] = {"from_epoch": start, "to_epoch": stop,
                          "train_graphs": len(train_set),
                          "cells_s": cells_s, "wall_s": wall,
                          "ms_per_epoch": wall * 1e3 / (stop - start)}
    done = latest_step(ckpt_dir)
    out["epochs_done"] = done
    if done >= args.epochs:
        _, state = api.load_trained(args.run_dir, cfg, device)
        out.update(score(args, cfg, params_tree(state.eval_params(cfg)),
                         make_cell, device))
    curve = loss_curve(args.run_dir, args.curve_every)
    out["ms_per_epoch_logged"] = 1e3 * float(np.mean(
        [r[3] for r in loss_curve(args.run_dir, 1)]))
    out["loss_curve"] = {"columns": ["epoch", "train_loss", "eval_loss",
                                     "epoch_s"], "every": args.curve_every,
                         "rows": curve}
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if (args.device.startswith("cuda")
            and not torch.cuda.is_available()):
        print("size_gen_check: no CUDA device (--device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 1
    out = run(args)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
