"""Retrain a snapshot's recipe from a fresh init and score the run against
the JAX package's record of that recipe.

    python -m diffusion_model_tpu_torch.evals.retrain_check \\
        artifacts/q_predef_r5.npz --run_dir build/retrain [--segment_epochs N]
    python -m diffusion_model_tpu_torch.evals.retrain_check \\
        artifacts/q_predef_r5.npz --score_only --seeds 0 1 2 3 4

Training: the recipe embedded in the npz (its seed, widths, optimizer,
``num_epochs`` and ``checkpoint_every``) on the synthetic dataset the
snapshot was trained on (``--num`` graphs of ``--shells`` shells from the
recipe's seed), through ``api.train(..., resume=True)``: a call goes on from
the run's newest checkpoint, and with ``--segment_epochs`` stops after that
many more epochs (at a checkpoint), so a long run can be made in several
calls. Once every epoch is done, ``api.load_trained``'s eval parameters
generate ``gen_num_per_spectrum`` samples for each test condition (seed the
recipe's) and are scored two ways: ``restore_check.score`` (rdf_cos mean and
median, CN2 angle R²) and ``api.evaluate_numbers`` (``rmsd_best``,
``rmsd_median``, ``atom_type_accuracy``), beside the JAX record and its
gates.

``--score_only`` scores the npz's own parameters over ``--seeds`` sampling
seeds instead (in ``--compute_dtype``, default the npz's): the spread of
those numbers.

Prints one JSON line: the scores, the loss curve (train and eval loss and
seconds, every ``--curve_every``-th epoch), ms per epoch, and the card's
name and power limit (``nvidia-smi``). On the card unless ``--device cpu``.
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
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.evals.restore_check import (
    held_out_conditions,
    score,
)
from diffusion_model_tpu_torch.train.checkpoint import (
    latest_step,
    load_config_npz,
    load_params_npz,
)
from diffusion_model_tpu_torch.train.trainer import params_tree

# The JAX package's record of the flagship recipe (retrained four times,
# docs/quality/predef_r5_summary.json), and the gates a run of the port is
# held to. rdf_cos and the angle R^2: chip_smoke.py's QUALITY gates (3
# sqrt(2) recorded spreads over sampling seeds, docs/quality/
# seed_variance.json; R^2 record - 0.05). rmsd_median and
# atom_type_accuracy: 3 sqrt(2) of their spread over sampling seeds of the
# snapshot on the card (this module's --score_only over seeds 0-5 on an
# NVIDIA H100 80GB HBM3 at 700 W, the standard deviations of
# tests/fixtures/torch_port/evaluate_spread_predef_r5.json).
RECORD = {
    "q_predef_r5": {
        "rdf_cos_mean": 0.8962191085880955,
        "rdf_cos_median": 0.9317090191130563,
        "cn2_angle_r2": 0.9766619012625823,
        "rmsd_best": 0.49653732776641846,
        "rmsd_median": 1.9807744026184082,
        "atom_type_accuracy": 0.9703703703703703,
    },
}
EVALUATE_SPREAD = {"rmsd_median": 0.05908971120801031,
                   "atom_type_accuracy": 0.0038251687369949853}
GATE = {
    "q_predef_r5": {
        "rdf_cos_mean": 0.045, "rdf_cos_median": 0.027,
        "cn2_angle_r2_min": 0.927,
        **{k: 3 * math.sqrt(2) * s for k, s in EVALUATE_SPREAD.items()},
    },
}


def within_gate(snapshot: str, scores: dict) -> dict:
    """The verdict of each score in ``scores`` that has a gate, against
    ``RECORD`` and ``GATE``."""
    record, gate = RECORD[snapshot], GATE[snapshot]
    out = {}
    if "cn2_angle_r2" in scores:
        out["cn2_angle_r2"] = (scores["cn2_angle_r2"] is not None
                               and scores["cn2_angle_r2"]
                               >= gate["cn2_angle_r2_min"])
    for k, width in gate.items():
        if k in record and k in scores:
            out[k] = (scores[k] is not None
                      and abs(scores[k] - record[k]) <= width)
    return out


def scored(cfg, params: dict, test_set: list, device, seed: int) -> dict:
    """Generate for every condition of ``test_set`` and score the samples
    both ways."""
    generator = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    results = api.generate(cfg, params, test_set, generator, device=device)
    gen_s = time.perf_counter() - t0
    out = score(results, cfg.gen_num_per_spectrum, device)
    t0 = time.perf_counter()
    numbers = api.evaluate_numbers(results, device)
    evaluate_ms = (time.perf_counter() - t0) * 1e3
    out.update({k: numbers.get(k) for k in ("rmsd_best", "rmsd_median",
                                            "rmsd_worst",
                                            "atom_type_accuracy",
                                            "num_accepted")})
    return {"seed": seed, **out, "gen_seconds": gen_s,
            "evaluate_ms": evaluate_ms}


def loss_curve(run_dir: str, every: int) -> list:
    """``[epoch, train_loss, eval_loss, epoch_s]`` of every ``every``-th
    epoch of ``run_dir/metrics.jsonl`` (the last record of an epoch that a
    resumed segment logged again), and the last epoch."""
    rows = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if "train_loss" in r:
                rows[r["step"]] = [r["step"], r["train_loss"], r["eval_loss"],
                                   r["epoch_s"]]
    last = max(rows) if rows else None
    return [rows[e] for e in sorted(rows) if e % every == 0 or e == last]


def device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    from diffusion_model_tpu_torch.probes._common import card_line

    return card_line()


def retrain(npz: str, run_dir: str, device, num: int = 256, shells: int = 2,
            segment_epochs=None, curve_every: int = 1) -> dict:
    cfg = load_config_npz(npz)
    graphs = synthetic_sio2_dataset(cfg.seed, num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=shells)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    start = latest_step(ckpt_dir) or 0
    stop = cfg.num_epochs if segment_epochs is None else min(
        cfg.num_epochs, start + segment_epochs)
    out = {"npz": npz, "run_dir": run_dir, "card": device_name(device),
           "recipe": {k: getattr(cfg, k) for k in (
               "seed", "compute_dtype", "neighbor_k", "n_max", "batch_size",
               "optimizer", "lr", "num_epochs", "checkpoint_every")}}
    if stop > start:
        t0 = time.perf_counter()
        _, _, (train_set, _, _) = api.train(cfg, graphs, run_dir,
                                            num_epochs=stop, device=device,
                                            resume=True)
        wall = time.perf_counter() - t0
        out["segment"] = {"from_epoch": start, "to_epoch": stop,
                          "train_graphs": len(train_set), "wall_s": wall,
                          "ms_per_epoch": wall * 1e3 / (stop - start)}
    done = latest_step(ckpt_dir)
    curve = loss_curve(run_dir, curve_every)
    out.update({"epochs_done": done,
                "ms_per_epoch_logged": 1e3 * float(np.mean(
                    [r[3] for r in loss_curve(run_dir, 1)])),
                "checkpoints": sorted(os.listdir(ckpt_dir))})
    if done >= cfg.num_epochs:
        _, state = api.load_trained(run_dir, cfg, device)
        params = params_tree(state.eval_params(cfg))
        test_set = held_out_conditions(cfg, num, shells)
        out["scores"] = scored(cfg, params, test_set, device, cfg.seed)
        snapshot = os.path.splitext(os.path.basename(npz))[0]
        if snapshot in RECORD:
            out.update({"jax_record": RECORD[snapshot],
                        "gate": GATE[snapshot],
                        "within_gate": within_gate(snapshot,
                                                   out["scores"])})
    out["loss_curve"] = {"columns": ["epoch", "train_loss", "eval_loss",
                                     "epoch_s"], "every": curve_every,
                         "rows": curve}
    return out


def score_only(npz: str, device, seeds, num: int = 256, shells: int = 2,
               compute_dtype=None) -> dict:
    cfg = load_config_npz(npz)
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    params = load_params_npz(npz)
    test_set = held_out_conditions(cfg, num, shells)
    rows = [scored(cfg, params, test_set, device, s) for s in seeds]
    spread = {}
    for k in ("rdf_cos_mean", "rdf_cos_median", "cn2_angle_r2", "rmsd_best",
              "rmsd_median", "atom_type_accuracy"):
        v = np.asarray([r[k] for r in rows if r[k] is not None], np.float64)
        v = v[np.isfinite(v)]
        spread[k] = {"n": int(len(v))}
        if len(v):
            spread[k].update(mean=float(v.mean()), min=float(v.min()),
                             max=float(v.max()),
                             std=float(v.std(ddof=1)) if len(v) > 1
                             else None)
    return {"npz": npz, "card": device_name(device), "seeds": list(seeds),
            "compute_dtype": cfg.compute_dtype, "rows": rows,
            "spread": spread}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--segment_epochs", type=int, default=None)
    p.add_argument("--score_only", action="store_true")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num", type=int, default=256,
                   help="dataset size the snapshot trained on")
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--curve_every", type=int, default=1)
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                   default=None, help="--score_only: default the npz's")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("retrain_check: no CUDA device (--device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 1
    if args.score_only:
        out = score_only(args.npz, device, args.seeds, args.num, args.shells,
                         args.compute_dtype)
    else:
        if args.run_dir is None:
            p.error("--run_dir is needed to train")
        out = retrain(args.npz, args.run_dir, device, args.num, args.shells,
                      args.segment_epochs, args.curve_every)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
