"""``evals.size_gen_check`` on the CPU at tiny widths, and the committed
record of its run on the card.

* Its ``config`` name is the one ``examples/size_generalization.py`` writes
  for the same flags (the example run with its training and generation
  stubbed out), so a result finds its record by name.
* Two epochs on eight network cells, scored at 24 atoms (two conditions):
  one JSON line with every field the example's summary has, the record's
  numbers and gates beside it, and the training's loss curve; a second call
  scores the finished run without training it again, and ``--params``
  scores the run's ``params.npz`` at another ``--sample_seed``.
* ``tests/fixtures/torch_port/size_gen_192_hres_vn.json`` (the recipe's
  seed, 2024) and ``..._seed2025.json`` to ``..._seed2028.json``, the
  port's retrains of the record's ``h_residual+virtual_node`` arm on the
  card: their fields, config name and gates as measured; the later seeds'
  scores at sampling seeds 2024 and 0-3 (``sample_seeds``).
"""

import json
import math
import os
import sys

import numpy as np
import pytest

from diffusion_model_tpu_torch.evals import size_gen_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "docs", "quality", "size192net_lever_sweep.json")
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
ROW = ("finite_fraction", "accepted", "generate_seconds", "aggregate_rdf_cos",
       "nn_dist_median_generated", "nn_dist_median_original",
       "o_density_mae", "panel", "rdf_ceiling")
# the panel's entries on any stack; those of bonds and angles need generated
# structures that have some (a trained model's)
PANEL = ("aggregate_rdf_cos", "excess_rdf_cos", "pair_dist_w1",
         "cn_si_mean_generated", "radius_profile_generated",
         "envelope_scale_ratio_p50")
BONDED = ("bond_peak_width_generated", "angle_siosi_w1_deg")
CEILING = ("mean", "sd", "min", "excess_mean", "excess_sd", "pairs",
           "num_cells")
TINY = ["--generator", "network", "--train_cells", "8", "--train_min",
        "16", "--train_max", "24", "--neighbor_k", "8", "--L", "2",
        "--hidden", "32", "--m_size", "16", "--batch_size", "4",
        "--timesteps", "100", "--sizes", "24", "--gen_cells", "2",
        "--chunk", "2", "--h_residual", "--virtual_node", "--h_init_scale",
        "1e-3"]


def example_config_name(flags, tmp_path, monkeypatch) -> str:
    """The ``config`` the example writes for ``flags``, its training and
    generation stubbed out (nothing accepted, so nothing is scored)."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    import size_generalization
    from diffusion_model_tpu import api as jax_api

    def generate(cfg, trainer, state, cells, batch_size):
        g = len(cells) * cfg.gen_num_per_spectrum
        return {"accepted": np.zeros(g, bool), "finite": np.ones(g)}

    monkeypatch.setattr(jax_api, "train", lambda *a, **k: (None, None, None))
    monkeypatch.setattr(jax_api, "generate", generate)
    out = tmp_path / "example"
    monkeypatch.setattr(sys, "argv", [
        "size_generalization.py", *flags, "--out_dir", str(out),
        "--cell_cache", str(tmp_path / "cache"), "--train_cells", "1",
        "--sizes", "16", "--gen_cells", "1", "--train_min", "16",
        "--train_max", "16"])
    size_generalization.main()
    with open(out / "size_gen_summary.json") as f:
        return json.load(f)["config"]


@pytest.mark.parametrize("flags", [
    ["--generator", "network", "--neighbor_k", "32", "--epochs", "2000",
     "--lr", "2e-4", "--max_grad_norm", "1", "--h_residual",
     "--virtual_node"],
    ["--epochs", "3300", "--h_residual", "--edge_rbf", "8", "--remat",
     "--t_bias_frac", "0.3", "--t_loss_weight", "2", "--L", "4",
     "--x_parameterization", "x0", "--global_radius", "--optimizer", "Adam",
     "--ema_decay", "0.999", "--init_from", "runs/prev"],
])
def test_config_name_is_the_examples(flags, tmp_path, monkeypatch):
    args = size_gen_check.parser().parse_args(
        [*flags, "--train_min", "16", "--train_max", "16"])
    want = example_config_name(flags, tmp_path, monkeypatch)
    assert size_gen_check.config_name(args) == want


def test_recorded_arm_names_are_the_recipes():
    with open(RECORD) as f:
        arms = json.load(f)["arms"]
    base = ["--generator", "network", "--neighbor_k", "32", "--epochs",
            "2000", "--train_min", "160", "--train_max", "192"]
    for arm, extra in (("ctl", []),
                       ("h_residual+virtual_node",
                        ["--h_residual", "--virtual_node"]),
                       ("h_residual+virtual_node+edge_rbf8",
                        ["--h_residual", "--virtual_node", "--edge_rbf",
                         "8"])):
        args = size_gen_check.parser().parse_args(base + extra)
        assert size_gen_check.config_name(args) == arms[arm]["config"], arm


def test_tiny_run_end_to_end(tmp_path, capsys):
    run_dir, cache = str(tmp_path / "run"), str(tmp_path / "cache")
    common = [*TINY, "--device", "cpu", "--run_dir", run_dir,
              "--cell_cache", cache, "--epochs", "2", "--curve_every", "1",
              "--record", RECORD, "--arm", "h_residual+virtual_node"]
    assert size_gen_check.main(common) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == ("size_gen_knn8_train16-24_2ep_network_lr0.0002"
                             "_clip1_hres_L2_vn")
    assert out["card"] == "cpu" and out["epochs_done"] == 2
    assert out["segment"]["from_epoch"] == 0
    assert [r[0] for r in out["loss_curve"]["rows"]] == [0, 1]
    assert all(math.isfinite(r[1]) for r in out["loss_curve"]["rows"])
    row = out["sizes"]["n24"]
    assert row["finite_fraction"] == 1.0 and row["accepted"] == 4
    for k in ROW:
        assert k in row, k
    for k in PANEL:
        assert k in row["panel"], k
    assert sorted(row["rdf_ceiling"]) == sorted(CEILING)
    assert row["rdf_ceiling"]["num_cells"] == 2
    assert row["rdf_ceiling"]["pairs"] == 3
    rec = out["against_record"]
    assert rec["record_config"] == ("size_gen_knn32_train160-192_2000ep"
                                    "_network_lr0.0002_clip1_hres_vn")
    np.testing.assert_allclose(rec["floor"]["aggregate_rdf_cos"],
                               0.9191 - 3 * math.sqrt(2) * 0.0089)
    np.testing.assert_allclose(rec["floor"]["excess_rdf_cos"],
                               0.5696 - 3 * math.sqrt(2) * 0.0672)
    assert sorted(rec["within_gate"]) == ["aggregate_rdf_cos",
                                          "excess_rdf_cos", "finite_fraction"]
    assert rec["ctl"]["aggregate_rdf_cos"] == 0.8727
    assert os.path.exists(os.path.join(run_dir, "positions_n24.npz"))
    # the cells went through the cache: 8 training and 2 evaluation cells,
    # the ceiling's 3 pairs of 2 blocks of 2
    assert len(os.listdir(cache)) == 8 + 2 + 12
    # a finished run is scored again, not trained
    assert size_gen_check.main(common) == 0
    again = json.loads(capsys.readouterr().out)
    assert "segment" not in again
    assert again["sizes"]["n24"]["panel"] == row["panel"]
    # the run's float16 params.npz scored over another sampling draw
    assert size_gen_check.main(
        [*common[:-4], "--params", os.path.join(run_dir, "params.npz"),
         "--sample_seed", "3", "--run_dir", str(tmp_path / "seed3")]) == 0
    seed3 = json.loads(capsys.readouterr().out)
    assert seed3["sample_seed"] == 3 and "loss_curve" not in seed3
    assert seed3["params"].endswith("params.npz")
    assert seed3["sizes"]["n24"]["finite_fraction"] == 1.0


def test_needs_the_card_unless_asked(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert size_gen_check.main(TINY) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name,seed", [("size_gen_192_hres_vn", None),
                                       ("size_gen_192_hres_vn_seed2025",
                                        2025),
                                       ("size_gen_192_hres_vn_seed2026",
                                        2026),
                                       ("size_gen_192_hres_vn_seed2027",
                                        2027),
                                       ("size_gen_192_hres_vn_seed2028",
                                        2028),
                                       ("size_gen_192_hres_vn_seed2024_2b",
                                        2024)])
def test_the_cards_retrain_record(name, seed):
    with open(os.path.join(FIXTURES, name + ".json")) as f:
        out = json.load(f)
    assert out.get("seed") == seed
    assert out["config"] == ("size_gen_knn32_train160-192_2000ep_network"
                             "_lr0.0002_clip1_hres_vn")
    assert out["card"].startswith("NVIDIA H100")
    assert out["epochs_done"] == 2000
    row = out["sizes"]["n192"]
    for k in ROW:
        assert k in row, k
    for k in PANEL + BONDED:
        assert k in row["panel"], k
    assert row["accepted"] <= 32
    rec = out["against_record"]
    assert rec["arm"] == "h_residual+virtual_node"
    assert rec["record_config"] == out["config"]
    assert rec["port"]["aggregate_rdf_cos"] == row["aggregate_rdf_cos"]
    assert rec["port"]["excess_rdf_cos"] == row["panel"]["excess_rdf_cos"]
    gates = rec["within_gate"]
    assert gates["aggregate_rdf_cos"] == (
        row["aggregate_rdf_cos"] >= rec["floor"]["aggregate_rdf_cos"])
    assert gates["excess_rdf_cos"] == (
        row["panel"]["excess_rdf_cos"] >= rec["floor"]["excess_rdf_cos"])
    assert gates["finite_fraction"] == (row["finite_fraction"] == 1.0)
    curve = out["loss_curve"]
    assert curve["every"] == 50
    epochs = [r[0] for r in curve["rows"]]
    assert epochs[0] == 0 and epochs[-1] == 1999
    assert all(math.isfinite(r[1]) for r in curve["rows"])
    if "sample_seeds" in out:
        # F9 step (b): each training seed scored at sampling seeds 2024
        # and 0-3, the file's own row that of 2024
        rows = out["sample_seeds"]
        assert sorted(rows) == ["0", "1", "2", "2024", "3"]
        assert out["sample_seed"] == 2024
        assert rows["2024"]["aggregate_rdf_cos"] == row["aggregate_rdf_cos"]
        assert rows["2024"]["excess_rdf_cos"] == \
            row["panel"]["excess_rdf_cos"]
        for r in rows.values():
            assert 0.0 < r["aggregate_rdf_cos"] <= 1.0
            assert r["accepted"] <= 32


def test_recipe_train_step_at_full_width_matches_jax():
    """One train step of the retrained recipe at its full widths (L=5, 1024
    / 256, kNN-32, ``h_residual``, ``virtual_node``, ``h_init_scale``
    1e-3, from the JAX package's fresh initialisation) on two network cells
    of 40-48 atoms, float32, in both packages on JAX's draws: the loss at
    rtol 1e-5 and every gradient through ``assert_leaves_close`` at 5e-3
    (``test_torch_trainer.py``'s tolerances)."""
    import jax

    from diffusion_model_tpu.config import Config as JaxConfig
    from diffusion_model_tpu.data import split as jax_split
    from diffusion_model_tpu.train import Trainer as JaxTrainer
    from diffusion_model_tpu_torch.config import from_dict
    from diffusion_model_tpu_torch.train.trainer import Trainer
    from test_torch_trainer import assert_leaves_close, np_tree, port_names
    from torch_port_fixtures import ReplayDraws, jax_loss_draws, port_batch

    args = size_gen_check.parser().parse_args([
        "--generator", "network", "--train_min", "40", "--train_max", "48",
        "--neighbor_k", "32", "--h_init_scale", "1e-3", "--h_residual",
        "--virtual_node", "--cell_cache", ""])
    cfg = size_gen_check.recipe(args).replace(compute_dtype="float32",
                                              batch_size=2)
    jcfg = JaxConfig(**cfg.to_dict())
    assert from_dict(jcfg.to_dict()) == cfg
    graphs = size_gen_check.train_cells(
        args, cfg, size_gen_check.cell_maker(args, cfg.spectrum_size))[:2]
    jb = next(jax_split.batch_iterator(graphs, 2, cfg.n_max, seed=1))
    jtrainer = JaxTrainer(jcfg)
    params = jtrainer.init_state(jax.random.key(0), jb).params
    key = jax.random.key(5)
    (loss, (sum_sq, _)), grads = jax.jit(jax.value_and_grad(
        jtrainer._loss, has_aux=True))(params, key, jb)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=np_tree(params))
    got_loss, got_sq, _, got_grads = trainer.loss_and_grads(
        state, ReplayDraws(jax_loss_draws(key, jcfg, 2, cfg.n_max)),
        port_batch(jb))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got_sq), float(sum_sq), rtol=1e-5)
    assert_leaves_close(got_grads, port_names(grads), 5e-3)
