"""Permutation-exhaustive RMSD CLI, as ``diffusion_model_tpu/cli/
evaluate_rmsd.py``.

For each accepted graph of at most ``--max_atoms`` atoms, the least RMSD
over all (N-1)! orders of the non-exO atoms (on ``--device``), the aligned
xyz pair under ``run_dir/rmsd_xyz/<id>/``, the sorted RMSDs in
``rmsd_xyz/sorted_id_rmsd.npz`` and their plot.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from diffusion_model_tpu_torch.cli.common import (
    add_device,
    device,
    load_results,
    trim,
)
from diffusion_model_tpu_torch.data.xyz import write_xyz
from diffusion_model_tpu_torch.evals.rmsd import permutation_min_rmsd
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--max_atoms", type=int, default=10)
    add_device(p)
    args = p.parse_args(argv)
    dev = device(args.device)

    results = load_results(args.run_dir)
    logger = RunLogger(args.run_dir)
    out_dir = os.path.join(args.run_dir, "rmsd_xyz")
    os.makedirs(out_dir, exist_ok=True)

    rows = []
    seen: dict = {}
    for i in range(len(results["ids"])):
        o = trim(results["original_pos"], results["mask"], i)
        g = trim(results["generated_pos"], results["mask"], i)
        res = permutation_min_rmsd(o, g, max_atoms=args.max_atoms,
                                   device=dev)
        if res is None:
            continue
        rmsd, order, aligned = res
        base = results["ids"][i]
        seen[base] = seen.get(base, 0) + 1
        uid = f"{base}_{seen[base]}"
        rows.append((uid, rmsd))
        d = os.path.join(out_dir, uid)
        os.makedirs(d, exist_ok=True)
        sp_o = trim(results["original_species"], results["mask"], i)
        sp_g = trim(results["generated_species"], results["mask"], i)[order]
        comment = f"{uid} {rmsd}"
        write_xyz(os.path.join(d, "original.xyz"), o - o[0], sp_o, comment)
        write_xyz(os.path.join(d, "generated.xyz"), aligned, sp_g, comment)

    rows.sort(key=lambda x: x[1])
    rmsds = np.asarray([r[1] for r in rows])

    plt = pyplot("perm_rmsd")
    fig, ax = plt.subplots()
    ax.plot(rmsds, marker="o", linestyle="None")
    ax.set_xlabel("sorted_index")
    ax.set_ylabel("rmsd")
    ax.set_yscale("log")
    ax.set_title("permutation-min rmsd")
    logger.log_figure("perm_rmsd", fig)
    plt.close(fig)

    np.savez(os.path.join(out_dir, "sorted_id_rmsd.npz"),
             ids=np.asarray([r[0] for r in rows]), rmsd=rmsds)
    if rows:
        print(f"best: {rows[0]}  mid: {rows[len(rows) // 2]}  "
              f"worst: {rows[-1]}")


if __name__ == "__main__":
    main()
