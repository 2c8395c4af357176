"""Shared helpers of the driver CLIs, as ``diffusion_model_tpu/cli/
common.py``: a run's generated results, one sample's real rows, and the
``--device`` every driver that puts work on a device takes."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffusion_model_tpu_torch.utils.logging import RunLogger


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="where the work runs: the card (cuda, the default) "
                        "or cpu; without a card, cuda raises")


def device(name: str) -> torch.device:
    """``--device``: never the CPU unless it is asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA card; pass --device cpu "
                         "to run on the CPU")
    return dev


def load_results(run_dir: str, artifact: str = "generated_graph_save_path",
                 accepted_only: bool = True) -> dict:
    """A run's generated results, from the npz its artifact registry names.

    ``accepted_only`` drops the rejected samples (``accepted`` false): the
    generation keeps them with their mask, and each evaluator filters at
    load time; a trajectory's samples are on its axis 1.
    """
    path = RunLogger(run_dir).artifact(artifact)
    z = np.load(path, allow_pickle=False)
    results = {k: z[k] for k in z.files if k != "ids"}
    results["ids"] = [str(i) for i in z["ids"]]
    if accepted_only and "accepted" in results:
        keep = np.nonzero(results["accepted"])[0]
        results["ids"] = [results["ids"][i] for i in keep]
        for k, v in results.items():
            if k == "ids":
                continue
            if k.startswith("trajectory"):
                results[k] = np.asarray(v)[:, keep]
            else:
                results[k] = np.asarray(v)[keep]
    return results


def trim(pos, mask, i):
    """Sample ``i``'s real rows of ``pos``."""
    n = int(mask[i].sum())
    return np.asarray(pos[i][:n])
