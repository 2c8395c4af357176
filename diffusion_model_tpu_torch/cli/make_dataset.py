"""Dataset builder CLI, as ``diffusion_model_tpu/cli/make_dataset.py``.

Walks sample directories holding a CASTEP ``coreloss.cell`` and its
``coreloss_core_edge.dat``, extracts the requested shells around the
excited oxygen (``data.shells.build_dataset``: the native shell builder
where g++ can build it, else numpy, the same selection) and writes one
``dataset.npz``. All of it runs on the host.

    python -m diffusion_model_tpu_torch.cli.make_dataset --range 2NN \\
        --cell_dir_path corpus/ --save_dir_path data/
"""

from __future__ import annotations

import argparse
import os

from diffusion_model_tpu_torch.data.io import save_dataset
from diffusion_model_tpu_torch.data.shells import (
    RANGE_TO_SHELLS,
    build_dataset,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--range", type=str, default="2NN",
                   choices=sorted(RANGE_TO_SHELLS))
    p.add_argument("--cell_dir_path", type=str, required=True)
    p.add_argument("--save_dir_path", type=str, required=True)
    args = p.parse_args(argv)

    dataset = build_dataset(args.cell_dir_path, nn_range=args.range)
    os.makedirs(args.save_dir_path, exist_ok=True)
    out = os.path.join(args.save_dir_path, "dataset.npz")
    save_dataset(dataset, out)
    print(f"saved {len(dataset)} graphs to {out}")


if __name__ == "__main__":
    main()
