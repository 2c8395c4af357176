"""Scores of both snapshots' generation at 250 strided reverse steps, in the
JAX package on the CPU: the reference the port's strided scoring is held to.

    JAX_PLATFORMS=cpu python tests/jax_strided_scores.py

For each (snapshot, key) of ``RUNS``: every test condition of the
snapshot's split (256 synthetic 2-shell graphs from its seed),
``gen_num_per_spectrum`` samples each, the snapshot's own schedule
subsampled to ``--steps`` entries on the ``--grid`` grid, float32, key
``jax.random.key(seed)``; scored as ``benchmarks/npz_restore_check.py``
scores (rdf_cos over the accepted samples, the CN2 angle R²) with the
O-density accuracy of ``api.evaluate``. Writes
``tests/fixtures/torch_port/jax_strided_250.json`` after every run (about
15-20 min a run on an 8-core CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "fixtures" / "torch_port" / "jax_strided_250.json"
RUNS = (("artifacts/q_predef_r5.npz", 2024), ("artifacts/q_predef_r5.npz", 0),
        ("artifacts/q_learned_r5_s2025.npz", 2025),
        ("artifacts/q_learned_r5_s2025.npz", 0))


def main(argv=None) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from diffusion_model_tpu import api
    from diffusion_model_tpu.data.split import split_dataset
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
    from diffusion_model_tpu.evals import (
        conditional_angle_parity,
        evaluate_rdf_lists,
        r2score,
    )
    from diffusion_model_tpu.evals.density import density_accuracy, o_density
    from diffusion_model_tpu.train import Trainer
    from diffusion_model_tpu.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--grid", default="uniform", choices=("uniform", "snr"))
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)

    out = {
        "script": "JAX_PLATFORMS=cpu python tests/jax_strided_scores.py",
        "device": "CPU, float32 (seconds are no device time)",
        "sample_steps": args.steps, "sample_grid": args.grid, "rows": [],
    }
    for npz, seed in RUNS:
        cfg = load_config_npz(npz).replace(compute_dtype="float32",
                                           sample_steps=args.steps,
                                           sample_grid=args.grid)
        params = load_params_npz(npz)
        graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size,
                                        shells=args.shells)
        test = split_dataset(graphs, cfg.seed)[2]

        class State:
            def eval_params(self, _cfg):
                return params

        t0 = time.perf_counter()
        res = api.generate(cfg, Trainer(cfg), State(), test,
                           key=jax.random.key(seed))
        gen_s = time.perf_counter() - t0
        keep = np.nonzero(res["accepted"])[0]
        rows = evaluate_rdf_lists(res["original_pos"][keep],
                                  res["mask"][keep],
                                  res["generated_pos"][keep],
                                  res["mask"][keep])
        rdf_cos = np.asarray([r["cos"] for r in rows])
        avg_o, avg_g = conditional_angle_parity(res,
                                                cfg.gen_num_per_spectrum)
        r2 = r2score(avg_o, avg_g) if len(avg_o) >= 3 else None
        acc = density_accuracy(
            o_density(res["original_species"][keep], res["mask"][keep]),
            o_density(res["generated_species"][keep], res["mask"][keep]))
        row = {
            "npz": npz, "seed": seed, "dtype": "float32",
            "sample_steps": args.steps, "sample_grid": args.grid,
            "conditions": len(test), "samples": int(len(res["accepted"])),
            "accepted": int(len(keep)),
            "finite_fraction": float(np.mean(res["finite"])),
            "rdf_cos_mean": float(rdf_cos.mean()),
            "rdf_cos_median": float(np.median(rdf_cos)),
            "cn2_angle_r2": None if r2 is None else float(r2),
            "cn2_angle_conditions": len(avg_o),
            "atom_type_accuracy": acc, "seconds": gen_s,
        }
        print(json.dumps(row), flush=True)
        out["rows"].append(row)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
