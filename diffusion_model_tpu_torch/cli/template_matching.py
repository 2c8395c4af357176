"""Template matching CLI, as ``diffusion_model_tpu/cli/
template_matching.py``: the best 3 spectrum-MSE neighbours of each target
graph in a reference dataset, each scored by the cosine similarity of
local descriptors (computed on ``--device``), saved as
``template_matching_result.json``."""

from __future__ import annotations

import argparse
import json
import os

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.cli.common import add_device, device
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.io import load_dataset
from diffusion_model_tpu_torch.evals.template import template_match


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reference_dataset_path", type=str, required=True)
    p.add_argument("--target_dataset_path", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    add_device(p)
    args = p.parse_args(argv)
    dev = device(args.device)

    cfg = Config()
    reference = api.prepare_dataset(
        load_dataset(args.reference_dataset_path), cfg)
    target = api.prepare_dataset(load_dataset(args.target_dataset_path), cfg)
    result = template_match(target, reference, device=dev)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "template_matching_result.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"saved best-3 matches for {len(result)} targets to {out}")


if __name__ == "__main__":
    main()
