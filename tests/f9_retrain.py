"""F9 steps (f) and (g): the large-cell arm (``h_residual+virtual_node``,
kNN-32) retrained at one training seed in one compute dtype, then scored at
sampling seed 2024 and, while the call has time, at 0-3. No JAX.

    # (f) float32, first the timing of 20 epochs and the projection
    python tests/f9_retrain.py --dtype float32 --time_epochs 20 \\
        --out chiprun_out/f9_f_timing.json
    python tests/f9_retrain.py --dtype float32 --run_dir runs/size192_f \\
        --out chiprun_out/size_gen_192_hres_vn_seed2024_f32.json
    # (g) bfloat16 with the F11 and F12 repairs
    python tests/f9_retrain.py --dtype bfloat16 --run_dir runs/size192_g \\
        --out chiprun_out/size_gen_192_hres_vn_seed2024_f12.json

The recipe is ``evals/size_gen_check.py``'s network-cell line (the
``RECIPE`` flags below, as in ``.claude/skills/verify/SKILL.md``), with
``recipe(args).replace(compute_dtype=...)``: the module's ``recipe`` is
wrapped for the call, and the module gains no flag. Training and each
score go through ``size_gen_check.run``; a score after the first reads
the run's newest checkpoint. The record is rewritten after every score,
so a call cut by its time limit keeps what it scored: the first score's
JSON with ``compute_dtype``, ``sample_seeds`` (each seed's aggregate and
excess RDF cosine, finite fraction, accepted count), ``gate_met_at_2024``
and the call's seconds. ``--deadline_s`` skips a further sampling seed
once the call has run that long. The run's float16 ``params.npz`` is
copied beside the record. Flags after ``--`` override the recipe's, e.g.
``--device cpu -- --hidden 32 --m_size 16 --L 2 --epochs 2 --train_cells 4
--train_min 24 --train_max 24 --neighbor_k 8 --sizes 24 --gen_cells 2
--sample_steps 4 --timesteps 20 --cell_cache ''`` rehearses it here.

``--time_epochs N`` trains N epochs only (``--segment_epochs``) and writes
the time an epoch and the projection of the whole run: 2000 of those
epochs plus the scoring PR 21's record took beside its training.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from diffusion_model_tpu_torch.evals import size_gen_check  # noqa: E402

RECIPE = ["--generator", "network", "--train_cells", "96", "--train_min",
          "160", "--train_max", "192", "--neighbor_k", "32", "--epochs",
          "2000", "--lr", "2e-4", "--max_grad_norm", "1", "--h_init_scale",
          "1e-3", "--h_residual", "--virtual_node", "--sizes", "192",
          "--gen_cells", "16", "--sample_steps", "250", "--chunk", "4",
          "--record", os.path.join(ROOT, "docs", "quality",
                                   "size192net_lever_sweep.json"), "--arm",
          "h_residual+virtual_node"]
SAMPLE_SEEDS = (2024, 0, 1, 2, 3)
# what a call holds beside its training, for the projection: PR 21's record
# (size_gen_192_hres_vn_seed2024_2b.json) held ~45-55 min for 1,640.9 s of
# training; an upper bound (step (g)'s five scores took 51 s)
SCORING_S = 600.0


def with_dtype(dtype: str):
    """``size_gen_check.recipe`` with the compute dtype replaced."""
    base = size_gen_check.recipe

    def recipe(args):
        return base(args).replace(compute_dtype=dtype)

    return recipe


def seed_row(out: dict) -> dict:
    row = out["sizes"][max(out["sizes"], key=lambda k: int(k[1:]))]
    return {"aggregate_rdf_cos": row.get("aggregate_rdf_cos"),
            "excess_rdf_cos": row.get("panel", {}).get("excess_rdf_cos"),
            "finite_fraction": row["finite_fraction"],
            "accepted": row["accepted"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", required=True, choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--run_dir", default="runs/size192_f9")
    p.add_argument("--out", required=True)
    p.add_argument("--time_epochs", type=int, default=0)
    p.add_argument("--deadline_s", type=float, default=3300.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--repair", default="")
    p.add_argument("recipe_flags", nargs="*",
                   help="after --: flags that override the recipe's (a "
                        "rehearsal at small widths on the CPU)")
    a = p.parse_args(argv)
    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("f9_retrain: no CUDA device", file=sys.stderr)
        return 1
    size_gen_check.recipe = with_dtype(a.dtype)
    flags = RECIPE + ["--seed", str(a.seed), "--run_dir", a.run_dir,
                      "--device", a.device] + a.recipe_flags
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)

    def write(rec):
        rec["call_s"] = time.perf_counter() - t0
        with open(a.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("sizes", "against_record",
                                       "loss_curve")}), flush=True)

    if a.time_epochs:
        out = size_gen_check.run(size_gen_check.parser().parse_args(
            flags + ["--segment_epochs", str(a.time_epochs)]))
        ms = out["ms_per_epoch_logged"]
        write({"compute_dtype": a.dtype, "seed": a.seed,
               "card": out["card"], "segment": out["segment"],
               "ms_per_epoch_logged": ms,
               "projected_train_s": 2000 * ms / 1e3,
               "projected_call_s": 2000 * ms / 1e3 + SCORING_S})
        return 0
    rec = None
    for s in SAMPLE_SEEDS:
        if rec is not None and time.perf_counter() - t0 > a.deadline_s:
            rec["skipped_seeds"] = [x for x in SAMPLE_SEEDS
                                    if str(x) not in rec["sample_seeds"]]
            break
        out = size_gen_check.run(size_gen_check.parser().parse_args(
            flags + ["--sample_seed", str(s)]))
        if rec is None:
            rec = dict(out, compute_dtype=a.dtype, repair=a.repair,
                       sample_seeds={})
            rec["gate_met_at_2024"] = bool(
                out["against_record"]["within_gate"]["aggregate_rdf_cos"])
        rec["sample_seeds"][str(s)] = seed_row(out)
        write(rec)
    params = os.path.join(a.run_dir, "params.npz")
    if os.path.exists(params):
        shutil.copy(params, os.path.splitext(a.out)[0] + "_params.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
