"""RDF evaluator CLI, as ``diffusion_model_tpu/cli/evaluate_rdf.py``.

The exO-centred RDFs of each accepted original and generated structure (on
``--device``), one of the four similarity metrics (cosine, euclidean, MSE,
Wasserstein) over the pairs, its histogram and the best / median / worst
curves as figures, and its mean and std logged to ``metrics.jsonl``.
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model_tpu_torch.cli.common import (
    add_device,
    device,
    load_results,
)
from diffusion_model_tpu_torch.evals.rdf import evaluate_rdf_lists
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--metric", type=str, default="cos",
                   choices=["cos", "euclidean", "mse", "wasserstein"])
    add_device(p)
    args = p.parse_args(argv)
    dev = device(args.device)

    results = load_results(args.run_dir)
    logger = RunLogger(args.run_dir)
    rows = evaluate_rdf_lists(
        results["original_pos"], results["mask"],
        results["generated_pos"], results["mask"], device=dev)
    values = np.asarray([r[args.metric] for r in rows])
    if values.size == 0:
        # nothing accepted: nothing to draw
        logger.log({f"rdf_{args.metric}_mean": float("nan"),
                    f"rdf_{args.metric}_std": float("nan")})
        print(f"rdf {args.metric}: no accepted samples to evaluate")
        return

    plt = pyplot(f"rdf_{args.metric}_hist")
    fig, ax = plt.subplots()
    ax.hist(values, bins=40)
    ax.set_xlabel(args.metric)
    ax.set_ylabel("count")
    ax.set_title(f"RDF {args.metric} distribution")
    logger.log_figure(f"rdf_{args.metric}_hist", fig)
    plt.close(fig)

    # best / median / worst (cos: higher is better; the others lower)
    order = np.argsort(values)
    if args.metric == "cos":
        order = order[::-1]
    picks = {"best": order[0], "mid": order[len(order) // 2],
             "worst": order[-1]}
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    r_axis = np.arange(len(rows[0]["rdf_original"])) * 0.01 + 0.01
    for ax, (name, idx) in zip(axes, picks.items()):
        ax.plot(r_axis, rows[idx]["rdf_original"], label="original")
        ax.plot(r_axis, rows[idx]["rdf_generated"], label="generated")
        ax.set_title(f"{name} ({args.metric}={values[idx]:.4f})")
        ax.set_xlabel("r [A]")
        ax.legend()
    logger.log_figure(f"rdf_{args.metric}_panels", fig)
    plt.close(fig)

    logger.log({
        f"rdf_{args.metric}_mean": float(values.mean()),
        f"rdf_{args.metric}_std": float(values.std()),
    })
    print(f"rdf {args.metric}: mean {values.mean():.5f} "
          f"std {values.std():.5f} over {len(values)} pairs")


if __name__ == "__main__":
    main()
