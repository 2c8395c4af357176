"""Amorphous and arbitrary-condition generation from a trained run, as
``diffusion_model_tpu/cli/generate_amorphous.py``.

Loads a run's newest checkpoint, generates for the conditions of a dataset
(``--dataset_path``), of N synthetic environments (``--synthetic``) or of N
amorphous cells (``--amorphous``, from ``--generator packing|network`` at
``--num_atoms`` atoms each), writes ``run_dir/generated_amorphous.npz``,
and logs the O-density accuracy scatter; ``--panel`` adds the structural
panel and the in-protocol RDF resampling ceiling
(``run_dir/amorphous_panel.json``). Runs on ``--device``, the card by
default: each denoiser call goes through the dense edge kernel, or with
``neighbor_k`` set the kNN one. ``--ring`` samples one dense-topology graph
a call through the node-sharded ring (``api.generate_ring``) over the
initialised ``torch.distributed`` world, where every rank runs this command
and the first writes; in a process without one it starts a world of one
(``parallel.init_single``).

    python -m diffusion_model_tpu_torch.cli.generate_amorphous \\
        --run_dir runs/latest --amorphous 2 --generator network \\
        --num_atoms 192 --panel
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch.distributed as dist

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.cli.common import add_device, device
from diffusion_model_tpu_torch.cli.main import save_generated
from diffusion_model_tpu_torch.data.io import load_dataset
from diffusion_model_tpu_torch.data.synthetic import (
    amorphous_cell,
    amorphous_network_cell,
    synthetic_sio2_dataset,
)
from diffusion_model_tpu_torch.evals.density import (
    density_accuracy,
    o_density,
)
from diffusion_model_tpu_torch.parallel import init_single
from diffusion_model_tpu_torch.train.trainer import params_tree
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger, load_run_config

def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True,
                   help="trained run directory (checkpoints + config)")
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--amorphous", type=int, default=0,
                   help="generate for N amorphous-cell conditions drawn "
                        "from --generator at --num_atoms atoms each")
    p.add_argument("--num_atoms", type=int, default=None,
                   help="atoms per amorphous condition (default: cfg.n_max)")
    p.add_argument("--generator", type=str, default="packing",
                   choices=("packing", "network"),
                   help="'packing' = hard-sphere amorphous_cell; "
                        "'network' = CRN silica amorphous_network_cell "
                        "(real Si-O chemical order)")
    p.add_argument("--gen_num_per_spectrum", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None,
                   help="conditions per sampling call (default 16): each "
                        "call holds batch_size * gen_num_per_spectrum "
                        "chains, and on the dense route a [B, N, N] pair "
                        "grid of every layer's edge features, so lower it "
                        "for large cells")
    p.add_argument("--ring", action="store_true",
                   help="sample through the node-sharded ring "
                        "(api.generate_ring): one dense-topology graph a "
                        "call, its node axis split over the ranks of the "
                        "world, for cells whose [N, N] pair grid exceeds "
                        "one card (neighbor_k must be 0)")
    p.add_argument("--panel", action="store_true",
                   help="emit the structural-quality panel + the "
                        "in-protocol RDF resampling ceiling "
                        "(evals.amorphous) into run_dir/amorphous_panel.json")
    add_device(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device(args.device)
    if args.ring and not dist.is_initialized():
        init_single("nccl" if dev.type == "cuda" else "gloo")

    cfg = load_run_config(args.run_dir)
    make_cell = None
    if args.amorphous:
        n_atoms = args.num_atoms or cfg.n_max
        gen_fn = (amorphous_network_cell if args.generator == "network"
                  else amorphous_cell)

        def make_cell(seed):
            return gen_fn(seed=seed, num_atoms=n_atoms,
                          spectrum_size=cfg.spectrum_size)

        graphs = [make_cell(cfg.seed + 10_000 + i)
                  for i in range(args.amorphous)]
        if n_atoms > cfg.n_max:
            cfg = cfg.replace(n_max=n_atoms)
    elif args.synthetic:
        graphs = synthetic_sio2_dataset(cfg.seed + 1, args.synthetic,
                                        cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
    elif args.dataset_path:
        graphs = load_dataset(args.dataset_path)
    else:
        raise SystemExit(
            "provide --dataset_path, --synthetic N or --amorphous N")
    graphs = api.prepare_dataset(graphs, cfg)

    _, state = api.load_trained(args.run_dir, cfg, dev)
    params = params_tree(state.eval_params(cfg))
    if args.ring:
        results = api.generate_ring(
            cfg, params, graphs,
            gen_num_per_spectrum=args.gen_num_per_spectrum, device=dev)
        if dist.get_rank() != 0:
            return
    else:
        gen_kwargs = {}
        if args.batch_size is not None:
            gen_kwargs["batch_size"] = args.batch_size
        results = api.generate(
            cfg, params, graphs,
            gen_num_per_spectrum=args.gen_num_per_spectrum, device=dev,
            **gen_kwargs)

    logger = RunLogger(args.run_dir)

    out = os.path.join(args.run_dir, "generated_amorphous.npz")
    save_generated(results, out)
    logger.register_artifact("generated_amorphous_save_path", out)

    d_orig = o_density(results["original_species"], results["mask"])
    d_gen = o_density(results["generated_species"], results["mask"])
    acc = density_accuracy(d_orig, d_gen)

    plt = pyplot("atom_type_eval_amorphous")
    fig, ax = plt.subplots()
    ax.plot([0, 1], [0, 1], linestyle="-", color="red")
    ax.plot(d_orig, d_gen, linestyle="None", marker="o")
    ax.set_xlabel("density of O in original")
    ax.set_ylabel("density of O in generated")
    ax.set_title(f"density of O (accuracy {acc:.5f})")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    logger.log_figure("atom_type_eval_amorphous", fig)
    plt.close(fig)
    summary = (f"generated {len(results['ids'])} structures; "
               f"O-density accuracy {acc:.5f}; saved at {out}")

    if args.panel:
        panel_path = os.path.join(args.run_dir, "amorphous_panel.json")
        with open(panel_path, "w") as f:
            json.dump(amorphous_panel(results, make_cell, dev), f, indent=1)
        logger.register_artifact("amorphous_panel", panel_path)
        summary += f"; panel at {panel_path}"

    print(summary)


def amorphous_panel(results: dict, make_cell, dev) -> dict:
    """The accepted count, the finite share and, over the accepted samples,
    ``evals.amorphous.structure_panel``; with a cell source, the RDF
    resampling ceiling over as many cells as there are distinct accepted
    conditions (a condition's repeats are not independent cells)."""
    from diffusion_model_tpu_torch.evals.amorphous import (
        exo_rdf_resampling_ceiling,
        structure_panel,
    )

    keep = np.nonzero(results["accepted"])[0]
    panel = {"accepted": int(len(keep)),
             "finite_fraction": float(results["finite"].mean())}
    if len(keep):
        panel["panel"] = structure_panel(
            results["original_pos"][keep], results["original_species"][keep],
            results["generated_pos"][keep],
            results["generated_species"][keep], results["mask"][keep],
            device=dev)
        if make_cell is not None:
            ids = results["ids"]
            distinct = len({ids[i] for i in keep})
            panel["rdf_ceiling"] = exo_rdf_resampling_ceiling(
                lambda s: make_cell(int(s)), num_cells=distinct, pairs=3,
                device=dev)
    return panel


if __name__ == "__main__":
    main()
