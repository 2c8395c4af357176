"""Export a trained run's sampler as a serving artifact (``serve.py``), as
``diffusion_model_tpu/cli/export.py``::

    python -m diffusion_model_tpu_torch.cli.export \\
        --run_dir runs/flagship --out runs/flagship/sampler.pt2 \\
        --batch_size 16 --sample_steps 250 --deterministic

The artifact is the compiled sampler (``serve.py``): the reverse chain's
start, step and epilogue as ``torch.export`` programs at the export's
shape, with the run's eval parameters and schedule table baked in, which
``ServedSampler`` calls without the model code. The run is loaded, the
programs are traced, and ``--calibrate`` samples with the live sampler, on
``--device``.
"""

from __future__ import annotations

import argparse

import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.cli.common import add_device, device
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.diffusion.sampler import sample
from diffusion_model_tpu_torch.serve import export_sampler
from diffusion_model_tpu_torch.train.trainer import params_tree
from diffusion_model_tpu_torch.utils.logging import load_run_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="artifact path: one file of compiled programs "
                        "(metadata sidecar at <out>.json)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="conditions per call (one export per shape bucket)")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="override: strided sampler step count (0 = full)")
    p.add_argument("--deterministic", action="store_true",
                   help="override: DDIM eta=0 sampling")
    p.add_argument("--platforms", type=str, default="cuda,cpu",
                   help="comma-separated devices the artifact may run on")
    p.add_argument("--retry_rounds", type=int, default=0,
                   help="redraw rounds of each served call (0 = the caller "
                        "owns the redraw contract)")
    p.add_argument("--calibrate", type=int, default=0,
                   help="measure single-draw acceptance over this many "
                        "sampling calls on synthetic conditions and record "
                        "it in the sidecar")
    add_device(p)
    return p


def _calibrate_acceptance(cfg, state, batch_size: int, calls: int,
                          dev) -> dict:
    """Single-draw acceptance of the live sampler at the export shape over
    ``batch_size`` synthetic SiO2 conditions (seed ``cfg.seed + 99``), call
    i drawing from a generator seeded ``1000 + i``: the number an operator
    sizes the redraw budget by."""
    params = params_tree(state.eval_params(cfg))
    model = api.denoiser_from_params(cfg, params, dev)
    schedule = api.schedule_for(cfg, params, dev)
    graphs = synthetic_sio2_dataset(cfg.seed + 99, batch_size, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    cond = collate(graphs, cfg.n_max, dev)
    accepted = total = 0
    for i in range(calls):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        res = sample(model, schedule, cfg, gen, cond)
        accepted += int(res.accepted.sum())
        total += batch_size
    return {
        "single_draw_accepted_fraction": accepted / max(total, 1),
        "calls": calls,
        "samples": total,
        "conditions": "synthetic_sio2",
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = device(args.device)
    cfg = load_run_config(args.run_dir)
    if args.sample_steps is not None:
        cfg = cfg.replace(sample_steps=args.sample_steps)
    if args.deterministic:
        cfg = cfg.replace(deterministic_sampling=True)
    trainer, state = api.load_trained(args.run_dir, cfg, dev)
    b = args.batch_size
    stats = None
    if args.calibrate:
        stats = _calibrate_acceptance(cfg, state, b, args.calibrate, dev)
        print(f"calibrated acceptance: {stats}")
    export_sampler(cfg, trainer, state, args.out, batch_size=b,
                   platforms=tuple(args.platforms.split(",")),
                   retry_rounds=args.retry_rounds, acceptance_stats=stats)
    print(f"exported sampler ({b}x{cfg.n_max} atoms, "
          f"{cfg.sample_steps or cfg.num_diffusion_timestep} steps, "
          f"{args.retry_rounds} retry rounds) to {args.out}")


if __name__ == "__main__":
    main()
