"""CN2 angle and bond evaluator CLI, as ``diffusion_model_tpu/cli/
evaluate_cn2.py``.

For the conditions whose exO has two Si: the Si-exO-Si angle and the two
bond lengths of each sample, averaged per condition over its
``gen_num_per_spectrum`` samples, the R² of generated against original, a
scatter with marginal histograms of the angles and one of the bonds, and
both R² logged. The geometry is numpy on the host.
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model_tpu_torch.cli.common import load_results
from diffusion_model_tpu_torch.evals.cn2 import (
    _cn2_sample_geometry,
    conditional_angle_parity,
    conditional_bond_parity,
    r2score,
)
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger, load_run_config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True)
    args = p.parse_args(argv)

    cfg = load_run_config(args.run_dir)
    # accepted_only=False: the group means need the contiguous groups of g;
    # a rejected or invalid sample is NaN, so its group drops out
    results = load_results(args.run_dir, accepted_only=False)
    logger = RunLogger(args.run_dir)
    g = cfg.gen_num_per_spectrum

    # the per-sample geometry once, shared by both readouts and the scatter
    geo = _cn2_sample_geometry(results)
    avg_theta, avg_phi = conditional_angle_parity(results, g, geo=geo)
    n = len(avg_theta)
    r2 = r2score(avg_theta, avg_phi)

    plt = pyplot("cn2_angle_scatter")
    from matplotlib.gridspec import GridSpec

    gs = GridSpec(2, 2, height_ratios=[1, 4], width_ratios=[4, 1])
    fig = plt.figure(figsize=(10, 10))
    ax_sc = fig.add_subplot(gs[1, 0])
    ax_hx = fig.add_subplot(gs[0, 0], sharex=ax_sc)
    ax_hy = fig.add_subplot(gs[1, 1], sharey=ax_sc)
    ax_sc.plot([0, 180], [0, 180], zorder=3, alpha=0.7)
    ax_sc.plot(avg_theta, avg_phi, "o", alpha=0.5)
    ax_sc.set_xlabel("original angle [deg]")
    ax_sc.set_ylabel("generated angle [deg]")
    ax_hx.hist(avg_theta, bins=50, range=(70, 180))
    ax_hy.hist(avg_phi, bins=50, range=(70, 180),
               orientation="horizontal")
    ax_sc.set_title(f"Si-exO-Si angle (R^2 = {r2:.4f})")
    logger.log_figure("cn2_angle_scatter", fig)
    plt.close(fig)

    avg_bo, avg_bg = conditional_bond_parity(results, g, geo=geo)
    r2_bond = r2score(avg_bo, avg_bg)
    rejected2 = np.concatenate([geo["invalid"], geo["invalid"]])
    bonds_orig = np.where(rejected2, np.nan,
                          np.concatenate([geo["bond1_o"], geo["bond2_o"]]))
    bonds_gen = np.where(rejected2, np.nan,
                         np.concatenate([geo["bond1_g"], geo["bond2_g"]]))
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(bonds_orig, bonds_gen, "o", alpha=0.4)
    # with no valid sample every bond is NaN: a fixed 2 A axis then
    finite_bonds = np.concatenate([bonds_orig, bonds_gen])
    finite_bonds = finite_bonds[np.isfinite(finite_bonds)]
    lims = [0, (finite_bonds.max() * 1.1) if finite_bonds.size else 2.0]
    ax.plot(lims, lims, "-", color="red", alpha=0.5)
    ax.set_xlabel("original bond length [A]")
    ax.set_ylabel("generated bond length [A]")
    ax.set_title(f"exO-Si bond length (R^2 = {r2_bond:.4f})")
    logger.log_figure("cn2_bond_scatter", fig)
    plt.close(fig)

    logger.log({"cn2_angle_r2": r2, "cn2_bond_r2": r2_bond})
    print(f"cn2 angle R^2: {r2:.4f}; bond R^2: {r2_bond:.4f} "
          f"over {n} conditions")


if __name__ == "__main__":
    main()
