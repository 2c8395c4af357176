"""The orchestrator CLI of the port, as ``diffusion_model_tpu/cli/main.py``
(the reference's ``main.py``): train, generate and evaluate from a config
into a run directory.

    python -m diffusion_model_tpu_torch.cli.main --mode train_and_generate \\
        --config configs/tiny.yaml --synthetic 48 --run_dir runs/latest
    python -m diffusion_model_tpu_torch.cli.main --mode evaluate_only \\
        --run_dir runs/latest --synthetic 48

Modes: ``train_and_generate``, ``train_only``, ``generate_only`` (the run's
newest checkpoint samples its test split) and ``evaluate_only`` (the run's
``generated.npz`` scored again). The config is ``--config``, a
reference-style ``parameters.yaml`` (which needs PyYAML) or the same keys
as ``.json``; ``generate_only`` and ``evaluate_only`` read the run's own
``config.json``. The data: ``--dataset_path`` (a ``.npz`` of
``cli.make_dataset``), ``--synthetic N`` (N synthetic SiO2 environments of
two shells from the config's seed) or ``--test_by_provided_data QM9`` with
``--dataset_path`` a directory of GDB-9 ``.xyz`` files (``atom_type_size``
widened to 5, unconditional). The run directory holds ``config.json``,
``metrics.jsonl``, ``profile.json``, ``checkpoints/``, ``params.npz``,
``generated.npz`` (the keys of the JAX package's), the figures and the
artifact registry.

Everything runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.cli.common import (
    add_device,
    device,
    load_results,
)
from diffusion_model_tpu_torch.config import Config, load_config
from diffusion_model_tpu_torch.data.io import load_dataset
from diffusion_model_tpu_torch.data.split import split_dataset
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.train.trainer import params_tree
from diffusion_model_tpu_torch.utils.logging import RunLogger, load_run_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--project_name", type=str,
                   default="diffusion_first_nearest_loss_per_atom")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--run_dir", type=str, default="runs/latest")
    p.add_argument("--config", type=str, default=None,
                   help="parameters.yaml (reference-compatible) or .json")
    p.add_argument("--dataset_path", type=str, default=None,
                   help=".npz dataset from cli/make_dataset.py")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic SiO2 environments instead")
    p.add_argument("--mode", type=str, default="train_and_generate",
                   choices=["train_and_generate", "train_only",
                            "generate_only", "evaluate_only"])
    p.add_argument("--num_epochs", type=int, default=None,
                   help="override config num_epochs")
    p.add_argument("--resume", action="store_true",
                   help="continue training from the latest checkpoint")
    p.add_argument("--record_schedule", action="store_true")
    p.add_argument("--create_xyz_file", action="store_true")
    p.add_argument("--note", type=str, default=None)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--test_by_provided_data", type=str, default=None)
    add_device(p)
    return p


def load_graphs(args, cfg: Config) -> list:
    if args.test_by_provided_data:
        if args.test_by_provided_data != "QM9":
            raise SystemExit(
                f"unknown provided dataset {args.test_by_provided_data!r}; "
                "only QM9 is supported")
        if not args.dataset_path:
            raise SystemExit(
                "--test_by_provided_data QM9 needs --dataset_path pointing "
                "at a directory of raw GDB-9 .xyz files")
        from diffusion_model_tpu_torch.data.qm9 import load_qm9_dataset

        # a seeded subset of 10,000, as the reference draws
        return load_qm9_dataset(args.dataset_path,
                                spectrum_size=cfg.spectrum_size,
                                limit=10_000, seed=cfg.seed)
    if args.synthetic:
        return synthetic_sio2_dataset(cfg.seed, args.synthetic, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size,
                                      shells=2)
    if args.dataset_path:
        return load_dataset(args.dataset_path)
    raise SystemExit("provide --dataset_path or --synthetic N")


def save_generated(results: dict, path: str) -> None:
    """``results`` as the JAX package's ``generated.npz``."""
    np.savez_compressed(path, **{k: v for k, v in results.items()
                                 if k != "ids"},
                        ids=np.asarray(results["ids"]))


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = device(args.device)

    if args.mode in ("generate_only", "evaluate_only"):
        cfg = load_run_config(args.run_dir)
    else:
        cfg = load_config(args.config) if args.config else Config()

    if args.test_by_provided_data == "QM9":
        # QM9 graphs carry no spectrum or exO to condition on
        cfg = cfg.replace(atom_type_size=5, conditional=False,
                          give_exO=False)

    graphs = api.prepare_dataset(load_graphs(args, cfg), cfg)
    n_max = api.fit_n_max(graphs)
    if n_max != cfg.n_max:
        cfg = cfg.replace(n_max=n_max)

    logger = RunLogger(args.run_dir, cfg, project=args.project_name,
                       run_name=args.run_name, use_wandb=args.use_wandb,
                       notes=args.note)

    results = None
    if "train" in args.mode:
        trainer, state, (_, _, test_set) = api.train(
            cfg, graphs, args.run_dir, logger, num_epochs=args.num_epochs,
            device=dev, resume=args.resume)
        print(f"model checkpoints saved under {args.run_dir}/checkpoints")
    else:
        test_set = split_dataset(graphs, cfg.seed)[2]
        trainer, state = api.load_trained(args.run_dir, cfg, dev)

    if "generate" in args.mode:
        results = api.generate(cfg, params_tree(state.eval_params(cfg)),
                               test_set, device=dev)
        out = os.path.join(args.run_dir, "generated.npz")
        save_generated(results, out)
        logger.register_artifact("generated_graph_save_path", out)
        print(f"generated structures saved at {out}")

    if args.mode == "evaluate_only":
        # api.evaluate applies its own accept filter
        results = load_results(args.run_dir, accepted_only=False)

    if results is not None and cfg.conditional:
        summary = api.evaluate(results, args.run_dir, logger,
                               create_xyz=args.create_xyz_file, device=dev)
        print(f"atom_type_accuracy: {summary['atom_type_accuracy']:.5f}")

    if args.record_schedule:
        api.record_schedule(cfg, trainer, state, args.run_dir, logger)
        print("noise_schedule saved")

    logger.finish()


if __name__ == "__main__":
    main()
