"""``evals.retrain_check`` end to end on the CPU at tiny widths: a recipe
embedded in an npz trained in two segments through ``api.train(...,
resume=True)`` equals one uninterrupted call, then is scored; and
``--score_only``'s spread over sampling seeds."""

import json

import numpy as np
import pytest
import torch

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.evals import retrain_check
from diffusion_model_tpu_torch.train.checkpoint import save_params_npz
from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree

torch.set_num_threads(4)

TINY = Config(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
              x_hidden_size=32, m_size=16, spectrum_size=32,
              compressed_spectrum_size=8, compressor_hidden_dim=(16,),
              num_diffusion_timestep=20, batch_size=8, lr=1e-3,
              num_epochs=3, checkpoint_every=1, gen_num_per_spectrum=2)
NUM, SHELLS = 30, 1


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    path = tmp_path_factory.mktemp("npz") / "tiny.npz"
    trainer = Trainer(TINY, device="cpu")
    state = trainer.init_state(TINY.seed)
    save_params_npz(params_tree(state.eval_params(TINY)), str(path),
                    cfg=TINY)
    return str(path)


def run(*args):
    return retrain_check.main([*args, "--device", "cpu", "--num", str(NUM),
                               "--shells", str(SHELLS)])


def test_segments_resume_to_the_uninterrupted_run(recipe, tmp_path, capsys):
    assert run(recipe, "--run_dir", str(tmp_path / "whole")) == 0
    whole = json.loads(capsys.readouterr().out)
    for _ in range(2):
        assert run(recipe, "--run_dir", str(tmp_path / "cut"),
                   "--segment_epochs", "2") == 0
    segments = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [s["segment"]["from_epoch"] for s in segments] == [0, 2]
    assert [s["epochs_done"] for s in segments] == [2, 3]
    assert "scores" not in segments[0]
    cut = segments[-1]
    # the same losses, epoch for epoch (the seconds differ)
    assert [r[:3] for r in cut["loss_curve"]["rows"]] == \
        [r[:3] for r in whole["loss_curve"]["rows"]]
    timing = ("gen_seconds", "evaluate_ms")
    assert json.dumps({k: v for k, v in cut["scores"].items()
                       if k not in timing}) == json.dumps(
        {k: v for k, v in whole["scores"].items() if k not in timing})
    assert cut["card"] == "cpu" and cut["checkpoints"] == ["1", "2", "3"]
    for k in ("rdf_cos_mean", "rmsd_median", "atom_type_accuracy",
              "num_accepted"):
        assert k in cut["scores"]
    assert [r[0] for r in cut["loss_curve"]["rows"]] == [0, 1, 2]
    # a finished run is scored again, not trained
    assert run(recipe, "--run_dir", str(tmp_path / "cut"),
               "--segment_epochs", "2", "--curve_every", "2") == 0
    again = json.loads(capsys.readouterr().out)
    assert "segment" not in again
    assert [r[0] for r in again["loss_curve"]["rows"]] == [0, 2]


def test_score_only_gives_the_spread_over_seeds(recipe, capsys):
    assert run(recipe, "--score_only", "--seeds", "0", "1", "2") == 0
    out = json.loads(capsys.readouterr().out)
    assert [r["seed"] for r in out["rows"]] == [0, 1, 2]
    # a fresh model's chains leave the accepted range: nothing to read
    assert [r["num_accepted"] for r in out["rows"]] == [0, 0, 0]
    assert out["spread"]["rmsd_median"] == {"n": 0}


def test_spread_over_seeds(monkeypatch):
    rows = [{"rmsd_median": v, "rdf_cos_mean": 0.9, "rdf_cos_median": 0.9,
             "cn2_angle_r2": None, "rmsd_best": 0.5,
             "atom_type_accuracy": 1.0} for v in (1.0, 2.0, 4.0)]
    monkeypatch.setattr(retrain_check, "scored",
                        lambda cfg, params, test, device, seed: rows[seed])
    monkeypatch.setattr(retrain_check, "load_params_npz", lambda npz: {})
    monkeypatch.setattr(retrain_check, "load_config_npz",
                        lambda npz: TINY)
    monkeypatch.setattr(retrain_check, "held_out_conditions",
                        lambda cfg, num, shells: [])
    out = retrain_check.score_only("x.npz", torch.device("cpu"), [0, 1, 2])
    spread = out["spread"]["rmsd_median"]
    assert spread["n"] == 3 and spread["min"] == 1.0 and spread["max"] == 4.0
    np.testing.assert_allclose(spread["std"], np.std([1, 2, 4], ddof=1))
    assert out["spread"]["cn2_angle_r2"] == {"n": 0}


def test_gates_are_read_against_the_record():
    record = retrain_check.RECORD["q_predef_r5"]
    scores = {**record, "cn2_angle_r2": 0.95}
    verdict = retrain_check.within_gate("q_predef_r5", scores)
    assert all(verdict.values())
    assert set(verdict) >= {"rdf_cos_mean", "rdf_cos_median", "cn2_angle_r2"}
    scores["rdf_cos_mean"] -= 0.05
    assert not retrain_check.within_gate("q_predef_r5",
                                         scores)["rdf_cos_mean"]


def test_needs_the_card_unless_asked(recipe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert retrain_check.main([recipe, "--score_only"]) == 1
    assert "no CUDA" in capsys.readouterr().err


def test_evaluate_gates_come_from_the_committed_spread():
    from pathlib import Path

    path = (Path(__file__).parent / "fixtures" / "torch_port"
            / "evaluate_spread_predef_r5.json")
    spread = json.load(open(path))["spread"]
    assert len(json.load(open(path))["seeds"]) >= 5
    for k, std in retrain_check.EVALUATE_SPREAD.items():
        assert std == spread[k]["std"]
        np.testing.assert_allclose(retrain_check.GATE["q_predef_r5"][k],
                                   3 * np.sqrt(2) * std)
