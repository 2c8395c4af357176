"""Si-O-Si evaluator CLI for amorphous structures, as
``diffusion_model_tpu/cli/evaluate_si_o_si.py``.

Keeps the accepted structures whose exO has exactly two Si within 2 A in
both the original and the generated set, and holds their Si-exO-Si angles
(on ``--device``) to each other: R² logged, with the count, and a scatter.
"""

from __future__ import annotations

import argparse

from diffusion_model_tpu_torch.cli.common import (
    add_device,
    device,
    load_results,
)
from diffusion_model_tpu_torch.evals.cn2 import (
    cn2_statistics,
    filter_si_o_si,
    r2score,
)
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--artifact", type=str,
                   default="generated_graph_save_path")
    add_device(p)
    args = p.parse_args(argv)
    dev = device(args.device)

    results = load_results(args.run_dir, args.artifact)
    logger = RunLogger(args.run_dir)

    keep_o, trip_o = filter_si_o_si(
        results["original_pos"], results["original_species"], results["mask"])
    keep_g, trip_g = filter_si_o_si(
        results["generated_pos"], results["generated_species"],
        results["mask"])
    both = sorted(set(keep_o) & set(keep_g))
    if not both:
        print("no structures with a 2-Si-coordinated exO in both sets")
        return
    io = [keep_o.index(i) for i in both]
    ig = [keep_g.index(i) for i in both]
    angles_o = cn2_statistics(trip_o[io], device=dev)["angle_deg"]
    angles_g = cn2_statistics(trip_g[ig], device=dev)["angle_deg"]
    r2 = r2score(angles_o, angles_g)

    plt = pyplot("si_o_si_angle")
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot([0, 180], [0, 180], "-", color="red", alpha=0.5)
    ax.plot(angles_o, angles_g, "o", alpha=0.5)
    ax.set_xlabel("original Si-O-Si angle [deg]")
    ax.set_ylabel("generated Si-O-Si angle [deg]")
    ax.set_title(f"Si-O-Si angle (R^2 = {r2:.4f}, n = {len(both)})")
    logger.log_figure("si_o_si_angle", fig)
    plt.close(fig)

    logger.log({"si_o_si_angle_r2": r2, "si_o_si_count": len(both)})
    print(f"Si-O-Si angle R^2: {r2:.4f} over {len(both)} structures")


if __name__ == "__main__":
    main()
