"""``evals/real_data_check.py``, the port's ``examples/real_data_e2e.py``,
on the CPU.

* The data path alone: the full corpus (46 samples) through the port's
  writer, shell builder and dataset files gives the record's 1-NN ceilings
  (``docs/quality/real_data_e2e.json``: angle 0.9720596, bond 0.9999874)
  to 1e-6, and the record's corpus statistics.
* A miniature of the whole pass (as the JAX package's
  ``tests/test_polymorphs.py`` ``test_corpus_to_training_e2e``): 4 O sites a
  polymorph, tiny widths, T=20, 30 epochs of both ranges, two sampling
  seeds: finite, decreasing losses and every readout of the record present.
"""

import json

import numpy as np
import torch

from diffusion_model_tpu_torch.data import polymorphs
from diffusion_model_tpu_torch.data.io import load_dataset, save_dataset
from diffusion_model_tpu_torch.data.shells import build_dataset
from diffusion_model_tpu_torch.evals import real_data_check as rdc

torch.set_num_threads(4)

TINY = dict(L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
            m_size=16, compressed_spectrum_size=8, compressor_hidden_dim=(8,),
            num_diffusion_timestep=20, batch_size=8, optimizer="Adam",
            lr=1e-3)


def test_ceilings_and_corpus_equal_the_record(tmp_path):
    with open(rdc.RECORD) as f:
        record = json.load(f)
    manifest = polymorphs.write_corpus(str(tmp_path / "corpus"), seed=0)
    assert len(manifest) == record["corpus"]["samples"] == 46
    save_dataset(build_dataset(str(tmp_path / "corpus"), "1NN"),
                 str(tmp_path / "ds.npz"))
    graphs = load_dataset(str(tmp_path / "ds.npz"))
    got = rdc.ceilings(graphs)
    for k, v in got.items():
        assert abs(v - record["1NN"][k]) <= 1e-6, k
    bonds = rdc.bond_pair(graphs)
    assert round(float(bonds.mean()), 4) == record["corpus"]["bond_mean_A"]
    assert round(float(bonds.std()), 4) == record["corpus"]["bond_sd_A"]


def test_miniature_pass_on_the_cpu(tmp_path):
    out = rdc.real_data_check(str(tmp_path / "work"), epochs=30,
                              device="cpu", seeds=(2024, 0),
                              config_overrides=TINY, max_sites=4)
    json.dumps(out)
    assert out["corpus"]["samples"] == 12
    for nn_range in ("2NN", "1NN"):
        run = out["runs"][nn_range]
        assert run["epochs"] == 30 and run["graphs"] == 12
        lines = [json.loads(x) for x in open(
            tmp_path / "work" / f"run_{nn_range}" / "metrics.jsonl")]
        losses = [r["train_loss"] for r in lines if "train_loss" in r]
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert out["runs"]["2NN"]["n_max"] == 16
    assert out["runs"]["1NN"]["n_max"] == 8
    assert len(out["draws"]) == 2
    for d in out["draws"]:
        assert d["samples_1NN"] == 5 * out["runs"]["1NN"]["test_conditions"]
        assert set(rdc.SCORES) <= set(d)
    assert set(out["scores"]) == set(rdc.SCORES)
    for s in out["scores"].values():
        assert len(s["values"]) == 2 and s["record"] is not None
