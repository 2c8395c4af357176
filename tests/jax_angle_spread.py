"""Spread of a snapshot's CN2 angle R² over sampling seeds, in the JAX
package on the CPU: the reference's own spread, to read the port's against.

    JAX_PLATFORMS=cpu python tests/jax_angle_spread.py \
        artifacts/q_learned_r5_s2025.npz --seeds 0 1 2 3

The R² reads only the CN2 conditions of the test split (``make_graph`` with
CN 2), so only those are sampled: ``gen_num_per_spectrum`` samples each,
the snapshot's own schedule and steps, in ``--dtype`` (float32 by default:
bfloat16 matmuls are emulated on the CPU). One JSON line per seed, the key
``jax.random.key(seed)``; the scoring is ``benchmarks/npz_restore_check.py``'s.
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
    from diffusion_model_tpu.evals import conditional_angle_parity, r2score
    from diffusion_model_tpu.train import Trainer
    from diffusion_model_tpu.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
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
    cn2 = [g for g in split_dataset(graphs, cfg.seed)[2] if g["cn"] == 2]

    class State:
        def eval_params(self, _cfg):
            return params

    trainer = Trainer(cfg)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = api.generate(cfg, trainer, State(), cn2,
                           key=jax.random.key(seed))
        avg_o, avg_g = conditional_angle_parity(res,
                                                cfg.gen_num_per_spectrum)
        r2 = r2score(avg_o, avg_g) if len(avg_o) >= 3 else None
        print(json.dumps({
            "npz": args.npz, "dtype": args.dtype, "seed": seed,
            "cn2_conditions": len(cn2), "cn2_angle_conditions": len(avg_o),
            "accepted": int(np.sum(res["accepted"])),
            "cn2_angle_r2": r2, "seconds": time.perf_counter() - t0}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
