"""Fingerprint similarity CLI, as ``diffusion_model_tpu/cli/
evaluate_fingerprint.py``: the count Tanimoto similarity of topological
fingerprints (atom pair, or Morgan radius 2) between each accepted
original and generated structure, its mean logged and its histogram drawn.
The fingerprints are numpy on the host."""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model_tpu_torch.cli.common import load_results, trim
from diffusion_model_tpu_torch.evals.fingerprint import fingerprint_similarity
from diffusion_model_tpu_torch.utils.figures import pyplot
from diffusion_model_tpu_torch.utils.logging import RunLogger


def _symbols(species):
    """One-hot rows -> element symbols by column order: SiO2's O, Si, or
    QM9's H, C, N, O, F."""
    width = np.asarray(species).shape[1]
    if width == 2:
        names = ("O", "Si")
    elif width == 5:
        from diffusion_model_tpu_torch.data.qm9 import QM9_SPECIES

        names = QM9_SPECIES
    else:
        raise SystemExit(f"no element mapping for {width}-wide one-hots")
    return [names[int(np.argmax(s))] for s in species]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--method", type=str, default="atom_pair",
                   choices=("atom_pair", "morgan"),
                   help="fingerprint family: atom_pair, or morgan (radius "
                        "2, circular)")
    args = p.parse_args(argv)

    results = load_results(args.run_dir)
    logger = RunLogger(args.run_dir)
    sims = []
    for i in range(len(results["ids"])):
        o = trim(results["original_pos"], results["mask"], i)
        g = trim(results["generated_pos"], results["mask"], i)
        sp_o = _symbols(trim(results["original_species"], results["mask"], i))
        sp_g = _symbols(trim(results["generated_species"], results["mask"],
                             i))
        sims.append(fingerprint_similarity(o, sp_o, g, sp_g,
                                           method=args.method))
    sims = np.asarray(sims)

    plt = pyplot("fingerprint_similarity")
    fig, ax = plt.subplots()
    ax.hist(sims, bins=30, range=(0, 1))
    ax.set_xlabel("tanimoto similarity")
    ax.set_ylabel("count")
    ax.set_title(f"{args.method} fingerprint similarity "
                 f"(mean {sims.mean():.4f})")
    logger.log_figure("fingerprint_similarity", fig)
    plt.close(fig)
    logger.log({"fingerprint_similarity_mean": float(sims.mean())})
    print(f"fingerprint similarity: mean {sims.mean():.4f} "
          f"std {sims.std():.4f} over {len(sims)} pairs")


if __name__ == "__main__":
    main()
