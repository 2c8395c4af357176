"""Finite chains sampled by a model a few epochs from its init, in the JAX
package on the CPU: the reference's own answer, to read the port's against.

    JAX_PLATFORMS=cpu python tests/jax_fresh_chains.py \
        artifacts/q_predef_r5.npz --epochs 2 --run_dir build/jax_fresh

Trains the recipe embedded in the npz (its seed, batch, optimizer and
``compute_dtype``, or ``--dtype``) from a fresh init through the JAX
package's ``api.train`` on the 256 synthetic 2-shell graphs the snapshot was
trained on, for ``--epochs`` epochs, then samples the first ``--conditions``
test conditions ``gen_num_per_spectrum`` times each through its
``api.generate`` (key ``jax.random.key(seed)``, 1000 steps) with
``--retries`` NaN-retry rounds (0: the first draw only). Prints one JSON
line: the losses, the finite and accepted chains, the seconds.
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
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
    from diffusion_model_tpu.train.checkpoint import load_config_npz

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--conditions", type=int, default=16)
    p.add_argument("--retries", type=int, default=0)
    p.add_argument("--dtype", default=None, help="default the recipe's")
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--shells", type=int, default=2)
    args = p.parse_args(argv)

    cfg = load_config_npz(args.npz)
    cfg = cfg.replace(compute_dtype=args.dtype or cfg.compute_dtype,
                      max_nan_retries=args.retries, checkpoint_every=0)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=args.shells)
    t0 = time.perf_counter()
    trainer, state, (_, _, test) = api.train(cfg, graphs, args.run_dir,
                                             num_epochs=args.epochs)
    train_s = time.perf_counter() - t0
    with open(os.path.join(args.run_dir, "metrics.jsonl")) as f:
        losses = [json.loads(x) for x in f]
    t0 = time.perf_counter()
    res = api.generate(cfg, trainer, state, test[: args.conditions],
                       key=jax.random.key(cfg.seed))
    rows = np.isfinite(res["generated_pos"]).all(axis=(1, 2))
    print(json.dumps({
        "npz": args.npz, "epochs": args.epochs,
        "compute_dtype": cfg.compute_dtype, "retries": args.retries,
        "steps": int(state.step),
        "losses": [{k: r[k] for k in ("step", "train_loss", "eval_loss")}
                   for r in losses if "train_loss" in r],
        "samples": int(len(rows)), "finite": int(rows.sum()),
        "flagged_finite": int(np.sum(res["finite"])),
        "accepted": int(np.sum(res["accepted"])),
        "train_seconds": train_s,
        "sample_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
