"""Score conditional generation from a committed ``.npz`` snapshot.

The port's counterpart of ``benchmarks/npz_restore_check.py``: rebuild the
dataset and its split from the snapshot's own config (seed, ``n_max``,
spectrum size), generate ``gen_num_per_spectrum`` samples for every test
condition through ``api.generate`` (with the snapshot's own noise schedule),
and score them as the JAX package scores its runs: rdf_cos between each
accepted sample and its condition, and the R² of the per-condition mean
Si-exO-Si angles over the CN2 conditions.

    python -m diffusion_model_tpu_torch.evals.restore_check \\
        artifacts/q_predef_r5.npz [--neighbor_k 15] [--out score.json]
        [--sample_steps 250 --sample_grid uniform]

samples on the card (``--device cpu`` on the host) and prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.split import split_dataset
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.evals.cn2 import (
    conditional_angle_parity,
    r2score,
)
from diffusion_model_tpu_torch.evals.density import (
    density_accuracy,
    o_density,
)
from diffusion_model_tpu_torch.evals.rdf import evaluate_rdf_lists
from diffusion_model_tpu_torch.train.checkpoint import (
    load_config_npz,
    load_params_npz,
)


def held_out_conditions(cfg: Config, num: int = 256,
                        shells: int = 2) -> list:
    """The test conditions of the dataset a snapshot was trained on:
    ``num`` synthetic graphs from ``cfg.seed``, split with ``cfg.seed``."""
    graphs = synthetic_sio2_dataset(cfg.seed, num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=shells)
    return split_dataset(graphs, cfg.seed)[2]


def score(results: dict, group: int, device="cuda") -> dict:
    """The scores of an ``api.generate`` result whose conditions come in
    runs of ``group`` samples: finite and accepted fractions, mean and
    median rdf_cos over the accepted samples (curves on ``device``), and
    the CN2 angle R² over the CN2 conditions whose every sample is a valid
    CN2 readout (``cn2_angle_conditions`` of them; None with fewer than
    three)."""
    keep = np.nonzero(results["accepted"])[0]
    rows = evaluate_rdf_lists(
        results["original_pos"][keep], results["mask"][keep],
        results["generated_pos"][keep], results["mask"][keep],
        device=device)
    rdf_cos = np.asarray([r["cos"] for r in rows])
    avg_o, avg_g = conditional_angle_parity(results, group)
    angle_r2 = r2score(avg_o, avg_g) if len(avg_o) >= 3 else None
    return {
        "finite_fraction": float(results["finite"].mean()),
        "accepted_fraction": float(results["accepted"].mean()),
        "rdf_cos_mean": float(rdf_cos.mean()),
        "rdf_cos_median": float(np.median(rdf_cos)),
        "cn2_angle_r2": None if angle_r2 is None else float(angle_r2),
        "cn2_angle_conditions": len(avg_o),
    }


def restore_check(npz: str, device="cuda", num: int = 256, shells: int = 2,
                  neighbor_k: Optional[int] = None,
                  seed: Optional[int] = None,
                  compute_dtype: Optional[str] = None,
                  sample_steps: Optional[int] = None,
                  sample_grid: Optional[str] = None) -> dict:
    """Generate for every test condition of ``npz`` and score the result.

    Args:
      device: where the model samples and the curves are computed.
      num, shells: the dataset the snapshot was trained on (not in its
        config).
      neighbor_k: sample over kNN lists of this many neighbours (the kNN
        route) instead of the snapshot's topology.
      seed: the sampling generator's seed (default the config's), to
        measure the spread of the scores over sampling draws.
      compute_dtype: the MLP matmuls' dtype (default the config's).
      sample_steps, sample_grid: sample over this many strided entries of
        the schedule, on the "uniform" or the "snr" grid (default the
        config's; ``sample_steps`` 0 is every step).

    Returns:
      the scores (``score``) and the share of accepted samples whose O
      fraction is the condition's (``api.evaluate``'s
      ``atom_type_accuracy``), with the sample counts, the condition count,
      the steps and grid, the device and the generation's wall seconds.
    """
    cfg = load_config_npz(npz)
    if neighbor_k is not None:
        cfg = cfg.replace(neighbor_k=neighbor_k)
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=compute_dtype)
    if sample_steps is not None:
        cfg = cfg.replace(sample_steps=sample_steps)
    if sample_grid is not None:
        cfg = cfg.replace(sample_grid=sample_grid)
    params = load_params_npz(npz)
    test_set = held_out_conditions(cfg, num, shells)
    device = torch.device(device)
    seed = cfg.seed if seed is None else seed
    generator = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    results = api.generate(cfg, params, test_set, generator, device=device)
    gen_s = time.perf_counter() - t0
    keep = results["accepted"]
    accuracy = density_accuracy(
        o_density(results["original_species"][keep], results["mask"][keep]),
        o_density(results["generated_species"][keep], results["mask"][keep]))
    return {
        "npz": npz,
        "seed": seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "compute_dtype": cfg.compute_dtype,
        "neighbor_k": cfg.neighbor_k,
        "sample_steps": cfg.sample_steps or cfg.num_diffusion_timestep,
        "sample_grid": cfg.sample_grid,
        "n_test_conditions": len(test_set),
        "samples": int(len(results["accepted"])),
        "accepted": int(results["accepted"].sum()),
        **score(results, cfg.gen_num_per_spectrum, device),
        "atom_type_accuracy": accuracy,
        "gen_seconds": gen_s,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num", type=int, default=256,
                   help="dataset size the snapshot trained on")
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--neighbor_k", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="sampling seed (default the snapshot's)")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                   default=None, help="default the snapshot's")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="strided reverse steps (default the snapshot's)")
    p.add_argument("--sample_grid", choices=("uniform", "snr"), default=None,
                   help="the strided grid (default the snapshot's)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    summary = restore_check(args.npz, args.device, args.num, args.shells,
                            args.neighbor_k, args.seed, args.compute_dtype,
                            args.sample_steps, args.sample_grid)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
