"""The real-data pass on public crystallography, through the port's library
calls: the port's ``examples/real_data_e2e.py``.

    python -m diffusion_model_tpu_torch.evals.real_data_check \\
        [--epochs 3000] [--out runs/real_data_check.json]

1. ``data.polymorphs.write_corpus(seed=0)``: the SiO2 polymorph corpus
   (alpha-quartz, alpha-cristobalite, coesite; one sample per O site) as
   CASTEP ``coreloss.cell`` and OptaDOS edge files, 46 samples;
2. ``data.shells.build_dataset`` at 2NN (9-atom graphs, for the RDF and
   species readouts) and 1NN (3-atom CN2 graphs, for the Si-exO-Si angle
   readouts), through ``data.io.save_dataset`` / ``load_dataset``;
3. ``api.train`` on each dataset with the record's hyperparameters (the
   default config, batch 16, lr 2e-4, RAdamScheduleFree, T=1000, float32,
   ``n_max`` fitted to the data), on the card through K1;
4. ``api.generate`` on each test split at the config's seed and at four
   more sampling seeds, then the readouts of ``docs/quality/
   real_data_e2e.json``: 2NN RDF cosine and atom-type accuracy; 1NN CN2
   angle and bond R², bond MAE, the per-polymorph breakdown; and the 1-NN
   spectrum-space ceilings (``evals.baseline.nn_ceiling_r2``) on the true
   geometry of the 1NN split, which depend on the data path alone.

Prints one JSON object and writes it to ``--out``: every score at each seed,
its mean and sample sd over the seeds, the record's value, and whether the
first seed's score lies beyond the record by more than 3·√2 of that sd.
Runs on the card unless ``--device cpu``. ``real_data_check`` itself also
takes config overrides, sampling seeds and a cut corpus, which the tests use
for a miniature on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time
from typing import Optional

import numpy as np
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data import polymorphs
from diffusion_model_tpu_torch.data.io import load_dataset, save_dataset
from diffusion_model_tpu_torch.data.shells import build_dataset
from diffusion_model_tpu_torch.data.split import split_dataset
from diffusion_model_tpu_torch.evals.baseline import nn_ceiling_r2
from diffusion_model_tpu_torch.evals.cn2 import (
    _cn2_sample_geometry,
    conditional_angle_parity,
    conditional_bond_parity,
    r2score,
)
from diffusion_model_tpu_torch.evals.rdf import evaluate_rdf_lists
from diffusion_model_tpu_torch.evals.retrain_check import device_name
from diffusion_model_tpu_torch.ops.angles import cn2_angle_deg
from diffusion_model_tpu_torch.train.trainer import params_tree

RECORD = "docs/quality/real_data_e2e.json"
# the record's hyperparameters (examples/real_data_e2e.py)
OVERRIDES = {"batch_size": 16, "lr": 2e-4, "optimizer": "RAdamScheduleFree",
             "num_diffusion_timestep": 1000, "compute_dtype": "float32"}
SAMPLE_SEEDS = (0, 1, 2, 3)
# score -> (section, key in the record, +1 where higher is better)
SCORES = {
    "rdf_cos_mean": ("2NN", "rdf_cos_mean", 1),
    "atom_type_accuracy_2NN": ("2NN", "atom_type_accuracy", 1),
    "cn2_angle_r2": ("1NN", "cn2_angle_r2", 1),
    "cn2_bond_r2": ("1NN", "cn2_bond_r2", 1),
    "cn2_bond_mae_A": ("1NN", "cn2_bond_mae_A", -1),
    "atom_type_accuracy_1NN": ("1NN", "atom_type_accuracy", 1),
}


def bond_pair(graphs: list) -> np.ndarray:
    """The two exO-Si bonds of each CN2 graph, ``[G, 2]``."""
    p = np.stack([g["pos"][:3] for g in graphs])
    return np.stack([np.linalg.norm(p[:, 1] - p[:, 0], axis=-1),
                     np.linalg.norm(p[:, 2] - p[:, 0], axis=-1)], 1)


def ceilings(graphs: list, seed: int = 2024) -> dict:
    """The 1-NN spectrum-space ceilings of the CN2 angle and bonds on the
    true geometry of the split by ``seed``, as the record computes them
    (float32 angles, numpy regression)."""
    tr, _, te = split_dataset(graphs, seed)
    if len(tr) < 3 or len(te) < 3:
        return {"cn2_angle_r2_nn_ceiling": None,
                "cn2_bond_r2_nn_ceiling": None}

    def angles(gs):
        pos = torch.from_numpy(np.stack([g["pos"][:3] for g in gs]))
        return cn2_angle_deg(pos).numpy()

    tr_sp = np.stack([g["spectrum"][0] for g in tr])
    te_sp = np.stack([g["spectrum"][0] for g in te])
    return {
        "cn2_angle_r2_nn_ceiling": nn_ceiling_r2(tr_sp, angles(tr), te_sp,
                                                 angles(te), r2score),
        "cn2_bond_r2_nn_ceiling": nn_ceiling_r2(tr_sp, bond_pair(tr), te_sp,
                                                bond_pair(te), r2score),
    }


def train_range(nn_range: str, corpus: str, work_dir: str, cfg: Config,
                epochs: int, device) -> tuple:
    """Build, save and load one range's dataset and train on it: (cfg with
    the fitted ``n_max``, test split, eval parameters, run record)."""
    ds_path = os.path.join(work_dir, f"dataset_{nn_range}", "dataset.npz")
    os.makedirs(os.path.dirname(ds_path), exist_ok=True)
    save_dataset(build_dataset(corpus, nn_range), ds_path)
    graphs = api.prepare_dataset(load_dataset(ds_path), cfg)
    cfg = cfg.replace(n_max=api.fit_n_max(graphs))
    run_dir = os.path.join(work_dir, f"run_{nn_range}")
    t0 = time.perf_counter()
    trainer, state, (train, val, test) = api.train(
        cfg, graphs, run_dir, num_epochs=epochs, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    losses = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train_loss" in row:
                losses.append((row["train_loss"], row["eval_loss"]))
    record = {"graphs": len(graphs), "n_max": cfg.n_max,
              "train_graphs": len(train), "val_graphs": len(val),
              "test_conditions": len(test), "epochs": len(losses),
              "steps": state.step, "train_s": train_s,
              "ms_per_step": 1e3 * train_s / max(state.step, 1),
              "final_train_loss": losses[-1][0] if losses else None,
              "final_eval_loss": losses[-1][1] if losses else None}
    return cfg, test, params_tree(state.eval_params(cfg)), record


def generated(cfg: Config, params: dict, test: list, seed: int, device):
    generator = torch.Generator(device=device).manual_seed(seed)
    return api.generate(cfg, params, test, generator, device=device)


def scores_2nn(results: dict, device) -> dict:
    keep = np.nonzero(results["accepted"])[0]
    rdf = float("nan")
    if len(keep):
        rows = evaluate_rdf_lists(
            results["original_pos"][keep], results["mask"][keep],
            results["generated_pos"][keep], results["mask"][keep],
            device=device)
        rdf = float(np.mean([r["cos"] for r in rows]))
    return {"rdf_cos_mean": rdf,
            "atom_type_accuracy_2NN": api.evaluate_numbers(
                results, device)["atom_type_accuracy"],
            "accepted_2NN": int(len(keep)),
            "samples_2NN": int(len(results["accepted"]))}


def bond_mae(geo: dict, valid: np.ndarray) -> Optional[float]:
    if not valid.sum():
        return None
    return float(np.mean(0.5 * (
        np.abs(geo["bond1_g"][valid] - geo["bond1_o"][valid])
        + np.abs(geo["bond2_g"][valid] - geo["bond2_o"][valid]))))


def r2_or_none(a, b) -> Optional[float]:
    return float(r2score(a, b)) if len(a) >= 2 else None


def scores_1nn(results: dict, group: int, device) -> dict:
    geo = _cn2_sample_geometry(results)
    angle_o, angle_g = conditional_angle_parity(results, group, geo=geo)
    bond_o, bond_g = conditional_bond_parity(results, group, geo=geo)
    ids = [str(i) for i in results["ids"]]
    per_poly = {}
    for poly in sorted({i.split("_")[2] for i in ids
                        if len(i.split("_")) > 2}):
        smask = np.asarray([i.split("_")[2] == poly for i in ids])
        valid = smask & ~geo["invalid"]
        if valid.sum() < 2:
            continue
        th, ph = conditional_angle_parity(
            results, group, geo={k: v[smask] for k, v in geo.items()})
        per_poly[poly] = {
            "conditions": int(smask.sum()) // group,
            "angle_r2": r2_or_none(th, ph),
            "angle_mae_deg": float(np.mean(np.abs(
                geo["angle_g"][valid] - geo["angle_o"][valid]))),
            "bond_mae_A": bond_mae(geo, valid)}
    return {"cn2_angle_r2": r2_or_none(angle_o, angle_g),
            "cn2_bond_r2": r2_or_none(bond_o, bond_g),
            "cn2_bond_mae_A": bond_mae(geo, ~geo["invalid"]),
            "cn2_conditions": int(len(angle_o)),
            "atom_type_accuracy_1NN": api.evaluate_numbers(
                results, device)["atom_type_accuracy"],
            "accepted_1NN": int(np.sum(results["accepted"])),
            "samples_1NN": int(len(results["accepted"])),
            "per_polymorph_1NN": per_poly}


def against_record(draws: list, record: dict) -> dict:
    """Per score: the value at each seed, mean, sample sd, the record's
    value and whether the first seed's lies beyond it by more than 3·√2 sd
    (in the worse direction)."""
    out = {}
    for name, (section, key, sign) in SCORES.items():
        values = [d.get(name) for d in draws]
        finite = [v for v in values if v is not None and np.isfinite(v)]
        sd = float(np.std(finite, ddof=1)) if len(finite) > 1 else None
        want = record.get(section, {}).get(key)
        first = values[0]
        beyond = None
        if sd is not None and want is not None and first is not None:
            beyond = bool(sign * (want - first) > 3 * math.sqrt(2) * sd)
        out[name] = {"values": values,
                     "mean": float(np.mean(finite)) if finite else None,
                     "sd": sd, "record": want,
                     "beyond_3sqrt2_sd": beyond}
    return out


def real_data_check(work_dir: str, epochs: int = 3000, device=None,
                    seeds: Optional[tuple] = None,
                    config_overrides: Optional[dict] = None,
                    max_sites: Optional[int] = None,
                    record_path: str = RECORD) -> dict:
    """Run the pass (see the module docstring) and return its record."""
    device = torch.device("cuda" if device is None else device)
    cfg = Config().replace(**{**OVERRIDES, **(config_overrides or {})})
    seeds = (cfg.seed,) + SAMPLE_SEEDS if seeds is None else tuple(seeds)
    shutil.rmtree(work_dir, ignore_errors=True)
    corpus = os.path.join(work_dir, "corpus")
    manifest = polymorphs.write_corpus(corpus, seed=0,
                                       max_sites_per_polymorph=max_sites)
    angles = [m[3] for m in manifest]
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "nvidia_smi": (device_name(device) if device.type == "cuda"
                          else None),
           "torch": torch.__version__, "epochs": epochs,
           "train_overrides": {**OVERRIDES, **(config_overrides or {})},
           "sampling_seeds": list(seeds)}
    draws = [dict() for _ in seeds]
    runs = {}
    for nn_range in ("2NN", "1NN"):
        rcfg, test, params, runs[nn_range] = train_range(
            nn_range, corpus, work_dir, cfg, epochs, device)
        gen_s = []
        for d, seed in zip(draws, seeds):
            t0 = time.perf_counter()
            results = generated(rcfg, params, test, seed, device)
            gen_s.append(time.perf_counter() - t0)
            d.update(scores_2nn(results, device) if nn_range == "2NN"
                     else scores_1nn(results, rcfg.gen_num_per_spectrum,
                                     device))
        runs[nn_range]["generate_s"] = gen_s
    graphs_1nn = load_dataset(os.path.join(work_dir, "dataset_1NN",
                                           "dataset.npz"))
    bonds = bond_pair(graphs_1nn)
    with open(record_path) as f:
        record = json.load(f)
    ceil = ceilings(graphs_1nn)
    out.update({
        "corpus": {"samples": len(manifest),
                   "polymorphs": sorted({m[1] for m in manifest}),
                   "angle_deg_min": min(angles),
                   "angle_deg_max": max(angles),
                   "bond_mean_A": float(bonds.mean()),
                   "bond_sd_A": float(bonds.std()),
                   "bond_range_A": [float(bonds.min()), float(bonds.max())]},
        "runs": runs,
        **ceil,
        "ceilings_equal_record_to_1e-6": {
            k: (v is not None and abs(v - record["1NN"][k]) <= 1e-6)
            for k, v in ceil.items()},
        "draws": draws,
        "scores": against_record(draws, record),
        "record": record_path,
    })
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--work_dir", default="runs/real_data_check")
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--device", default=None)
    p.add_argument("--record", default=RECORD)
    p.add_argument("--out", default="runs/real_data_check.json")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = real_data_check(args.work_dir, args.epochs, args.device,
                          record_path=args.record)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
