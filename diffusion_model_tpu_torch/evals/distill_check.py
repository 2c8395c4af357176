"""Distil a snapshot into a few-step student and score three sampling
regimes on its test split, the port's counterpart of
``examples/distill_eval.py``:

  * full: ancestral sampling over every step of the schedule;
  * strided: ancestral sampling over ``sample_steps=K`` strided steps, no
    retraining;
  * distilled: the K-step deterministic student of ``api.distill``.

    python -m diffusion_model_tpu_torch.evals.distill_check \\
        artifacts/q_predef_r5.npz --final_steps 125 --epochs_per_phase 60 \\
        --lr 5e-5 --out build/distill_check.json \\
        --record docs/quality/distill_eval.json

The dataset is the one the snapshot was trained on (``--num`` synthetic
graphs of ``--shells`` shells from its seed), split as
``restore_check.held_out_conditions`` splits it: the teacher is distilled on
the train split, every regime samples ``gen_num_per_spectrum`` structures
for each test condition (a generator seeded with the snapshot's seed) and
is scored as the example scores it: generation seconds and seconds per
structure, the finite fraction, the accepted count, and rdf_cos mean and
median over the accepted samples. ``--record`` puts a JSON record of the
same keys (the JAX package's) beside the numbers. Prints one JSON line
(with the card's name and power limit, ``nvidia-smi``); on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.data.split import split_dataset
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.evals.rdf import evaluate_rdf_lists
from diffusion_model_tpu_torch.evals.retrain_check import device_name
from diffusion_model_tpu_torch.train.checkpoint import (
    load_config_npz,
    load_params_npz,
)
from diffusion_model_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    params_tree,
)


def snapshot_state(cfg, params: dict, device) -> tuple:
    """``(cfg, trainer, state)`` holding a snapshot's parameters exactly:
    the config with ``optimizer="Adam"`` and no EMA, so that
    ``state.eval_params`` is the parameters themselves."""
    cfg = cfg.replace(optimizer="Adam", ema_decay=0.0)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed, params=params, skip_gamma_fit=True)
    return cfg, trainer, TrainState(state.params, None)


def run_regime(cfg, params: dict, test: list, device) -> dict:
    """Sample every test condition with ``cfg`` from ``params`` and score
    the samples as ``examples/distill_eval.py`` does."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    t0 = time.perf_counter()
    results = api.generate(cfg, params, test, gen, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gen_s = time.perf_counter() - t0
    keep = np.nonzero(results["accepted"])[0]
    rows = evaluate_rdf_lists(
        results["original_pos"][keep], results["mask"][keep],
        results["generated_pos"][keep], results["mask"][keep],
        device=device)
    cos = np.asarray([r["cos"] for r in rows])
    return {
        "sample_steps": cfg.sample_steps or cfg.num_diffusion_timestep,
        "deterministic": cfg.deterministic_sampling,
        "generate_seconds": gen_s,
        "seconds_per_structure": gen_s / len(results["ids"]),
        "finite_fraction": float(results["finite"].mean()),
        "accepted": int(results["accepted"].sum()),
        "samples": int(len(results["ids"])),
        "rdf_cos_mean": float(cos.mean()) if len(cos) else None,
        "rdf_cos_median": float(np.median(cos)) if len(cos) else None,
    }


def distill_check(npz: str, final_steps: int = 125,
                  epochs_per_phase: int = 60, lr: float = 5e-5,
                  num: int = 256, shells: int = 2, device="cuda",
                  record=None) -> dict:
    """Distil ``npz`` to ``final_steps`` and score the three regimes."""
    device = torch.device(device)
    cfg = load_config_npz(npz)
    params = load_params_npz(npz)
    graphs = synthetic_sio2_dataset(cfg.seed, num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=shells)
    train, _, test = split_dataset(graphs, cfg.seed)
    teacher_cfg, trainer, state = snapshot_state(cfg, params, device)
    log = []

    def log_fn(line):
        log.append(line)
        print(line, file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    student_cfg, student = api.distill(
        teacher_cfg, trainer, state, train, final_steps=final_steps,
        epochs_per_phase=epochs_per_phase, lr=lr, log_fn=log_fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    distill_s = time.perf_counter() - t0
    student_params = params_tree(student.eval_params(student_cfg))
    out = {
        "npz": npz,
        "card": device_name(device),
        "final_steps": final_steps,
        "epochs_per_phase": epochs_per_phase,
        "lr": lr,
        "train_graphs": len(train),
        "test_conditions": len(test),
        "distill_seconds": distill_s,
        "distill_log": log,
        "full": run_regime(cfg, params, test, device),
        "strided": run_regime(cfg.replace(sample_steps=final_steps), params,
                              test, device),
        "distilled": run_regime(student_cfg, student_params, test, device),
    }
    if record:
        with open(record) as f:
            out["record"] = {"path": record, **json.load(f)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--final_steps", type=int, default=125)
    p.add_argument("--epochs_per_phase", type=int, default=60)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--num", type=int, default=256,
                   help="dataset size the snapshot trained on")
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--record", default=None,
                   help="a JSON record to report beside the numbers")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    summary = distill_check(args.npz, args.final_steps,
                            args.epochs_per_phase, args.lr, args.num,
                            args.shells, args.device, args.record)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
