"""``api.evaluate``'s numbers (sorted Kabsch RMSD, O-density accuracy) of a
snapshot's generation in the JAX package on the CPU, over sampling keys:
the reference's own reading of an npz, to read the port's against.

    JAX_PLATFORMS=cpu python tests/jax_evaluate_npz.py \
        artifacts/q_predef_r5.npz --run_dir build/jax_eval --seeds 2024

Every test condition of the snapshot's split (256 synthetic 2-shell graphs
from its seed), ``gen_num_per_spectrum`` samples each, the snapshot's own
schedule and steps, in ``--dtype`` (float32 by default: bfloat16 matmuls are
emulated on the CPU), key ``jax.random.key(seed)``. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from diffusion_model_tpu import api
    from diffusion_model_tpu.data.split import split_dataset
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
    from diffusion_model_tpu.train import Trainer
    from diffusion_model_tpu.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--dtype", default="float32")
    args = p.parse_args(argv)

    cfg = load_config_npz(args.npz).replace(compute_dtype=args.dtype)
    params = load_params_npz(args.npz)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=args.shells)
    test = split_dataset(graphs, cfg.seed)[2]

    class State:
        def eval_params(self, _cfg):
            return params

    trainer = Trainer(cfg)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = api.generate(cfg, trainer, State(), test,
                           key=jax.random.key(seed))
        gen_s = time.perf_counter() - t0
        run_dir = os.path.join(args.run_dir, str(seed))
        out = api.evaluate(res, run_dir)
        rmsds = [r[1] for r in out["sorted_rmsd"]]
        print(json.dumps({
            "npz": args.npz, "dtype": args.dtype, "seed": seed,
            "conditions": len(test), "samples": int(len(res["accepted"])),
            "accepted": int(np.sum(res["accepted"])),
            "rmsd_best": rmsds[0], "rmsd_median": rmsds[len(rmsds) // 2],
            "atom_type_accuracy": out["atom_type_accuracy"],
            "seconds": gen_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
