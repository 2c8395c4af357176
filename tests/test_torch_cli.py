"""The port's orchestrator and generation CLIs (``cli/main.py``,
``cli/common.py``, ``cli/generate_amorphous.py``, ``cli/cn.py``) against the
JAX package's, on the CPU.

* ``main``: both packages train and generate on the same micro config
  (``tests/test_cli.py``'s) and ``--synthetic 24``: the same files in the
  run directory (the port adds ``params.npz``), the same ``Config``, test
  split and ``generated.npz`` keys, shapes and ids, ``metrics.jsonl`` with
  the same epochs and JAX's keys (the port adds ``epoch_s``) and
  ``profile.json`` with the same phases and counts. The runs' numbers
  differ: each package draws its own initialisation and noise. Then JAX's
  trained weights, carried into a run directory of the port, and JAX's
  ``generated.npz``: ``evaluate_only`` logs JAX's numbers (RMSDs at rtol
  1e-5, ``test_torch_evaluate.py``'s tolerance; the rest equal). QM9: the
  same widened, unconditional config from a few GDB-9 files.
* ``load_results`` drops rejected samples as JAX's does, trajectories along
  their sample axis.
* ``generate_amorphous``: network cells with ``--panel``: the panel's keys
  and the npz's keys, shapes and ids as JAX's; ``--ring`` in a world of one
  (the CLI starts it) as the CLI without it, within 2e-4.
* ``cn``: from JAX's initialisation on the same split, the printed train
  MSEs within rtol 1e-4 and the test MAE, accuracy and macro-F1 within one
  unit of the last printed digit (Adam in float32 on both sides);
  ``macro_f1`` bit for bit.
"""

import json
import re
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from diffusion_model_tpu import api as jax_api
from diffusion_model_tpu.cli import cn as jax_cn
from diffusion_model_tpu.cli import common as jax_common
from diffusion_model_tpu.cli import generate_amorphous as jax_amorphous
from diffusion_model_tpu.cli import main as jax_main
from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.data.split import split_dataset as jax_split
from diffusion_model_tpu.data.synthetic import (
    synthetic_sio2_dataset as jax_synthetic,
)
from diffusion_model_tpu.nn import CNPredictor as JaxCNPredictor
from diffusion_model_tpu_torch.cli import cn, common, generate_amorphous, main
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.train.checkpoint import save_checkpoint
from diffusion_model_tpu_torch.train.trainer import Trainer
from diffusion_model_tpu_torch.utils.logging import RunLogger

torch.set_num_threads(4)

MICRO_CFG = dict(
    L=1, m_hidden_size=16, h_hidden_size=16, x_hidden_size=16, m_size=8,
    spectrum_size=16, compressed_spectrum_size=8, compressor_hidden_dim=[8],
    num_diffusion_timestep=4, batch_size=8, lr=1e-3, optimizer="Adam",
    noise_precision=0.05, gen_num_per_spectrum=2, num_epochs=2,
)
CPU = ["--device", "cpu"]
RTOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX run dir, port run dir) of ``train_and_generate``."""
    root = tmp_path_factory.mktemp("cli")
    cfg_path = root / "micro.yaml"
    cfg_path.write_text(yaml.safe_dump(MICRO_CFG))
    dirs = root / "jax", root / "port"
    for mod, d, extra in ((jax_main, dirs[0], []), (main, dirs[1], CPU)):
        mod.main(["--mode", "train_and_generate", "--run_dir", str(d),
                  "--config", str(cfg_path), "--synthetic", "24",
                  "--create_xyz_file", *extra])
    return dirs


def lines(path: Path) -> list:
    return [json.loads(x) for x in open(path)]


def test_main_writes_the_jax_run_directory(runs):
    jax_dir, port_dir = runs
    want = {p.name for p in jax_dir.iterdir()}
    assert {p.name for p in port_dir.iterdir()} == want | {"params.npz"}
    assert {"profile.json", "generated.npz", "metrics.jsonl"} <= want
    for d in ("figures", "checkpoints"):
        assert {p.name for p in (port_dir / d).iterdir()} == \
            {p.name for p in (jax_dir / d).iterdir()}, d
    with open(port_dir / "artifacts.json") as f:
        got = json.load(f)
    with open(jax_dir / "artifacts.json") as f:
        want = json.load(f)
    assert sorted(got) == sorted(want)


def test_main_config_split_and_generated_npz_as_jax(runs):
    jax_dir, port_dir = runs
    got, want = (from_dict(json.load(open(d / "config.json")))
                 for d in (port_dir, jax_dir))
    assert got == want
    assert got.n_max == 16 and got.L == 1
    g, w = (np.load(d / "generated.npz") for d in (port_dir, jax_dir))
    assert sorted(g.files) == sorted(w.files)
    for k in w.files:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
    np.testing.assert_array_equal(g["ids"], w["ids"])
    # the test split of the run's config, each condition twice
    graphs = jax_synthetic(2024, 24, 16, spectrum_size=16, shells=2)
    test = jax_split(graphs, 2024)[2]
    assert list(w["ids"]) == [gr["id"] for gr in test for _ in range(2)]


def test_main_metrics_and_profile_as_jax(runs):
    jax_dir, port_dir = runs
    got, want = (lines(d / "metrics.jsonl") for d in (port_dir, jax_dir))
    assert [r.get("step") for r in got] == [r.get("step") for r in want]
    for g, w in zip(got, want):
        extra = {"epoch_s"} if "train_loss" in w else set()
        assert set(g) == set(w) | extra
    epochs = [r for r in got if "train_loss" in r]
    assert [r["step"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in epochs)
    got, want = (json.load(open(d / "profile.json"))
                 for d in (port_dir, jax_dir))
    assert sorted(got) == sorted(want) == ["checkpoint", "eval_epoch",
                                           "train_epoch"]
    for phase, row in want.items():
        assert sorted(got[phase]) == sorted(row)
        assert got[phase]["count"] == row["count"], phase


def test_evaluate_only_with_jax_weights_logs_jax_numbers(runs, tmp_path):
    jax_dir, _ = runs
    jcfg = jax_main.load_run_config(str(jax_dir))
    example = jax_collate(jax_synthetic(2024, 1, 16, spectrum_size=16), 16)
    _, jstate = jax_api.load_trained(str(jax_dir), jcfg, example)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jstate.eval_params(jcfg))
    cfg = from_dict(jcfg.to_dict())
    port_dir = tmp_path / "port"
    logger = RunLogger(str(port_dir), cfg)
    trainer = Trainer(cfg, device="cpu")
    save_checkpoint(str(port_dir / "checkpoints"),
                    trainer.init_state(cfg.seed, params=params), cfg, step=2)
    shutil.copy(jax_dir / "generated.npz", port_dir / "generated.npz")
    logger.register_artifact("generated_graph_save_path",
                             str(port_dir / "generated.npz"))

    argv = ["--mode", "evaluate_only", "--synthetic", "24"]
    jax_main.main(argv + ["--run_dir", str(jax_dir)])
    main.main(argv + ["--run_dir", str(port_dir), *CPU])
    want = lines(jax_dir / "metrics.jsonl")[-1]
    got = lines(port_dir / "metrics.jsonl")[-1]
    assert sorted(got) == sorted(want)
    assert "rmsd_median" in want
    for k, v in want.items():
        if k.startswith("rmsd"):
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
        elif k != "time":
            assert got[k] == v, k


def test_main_reads_qm9_as_jax(tmp_path):
    """A few GDB-9 files: the same widened, unconditional config, and the
    run's first checkpoint (no epoch trained)."""
    from test_torch_data_readers import write_qm9

    root = write_qm9(tmp_path / "qm9")
    cfg_path = tmp_path / "micro.yaml"
    cfg_path.write_text(yaml.safe_dump(MICRO_CFG))
    for mod, name, extra in ((jax_main, "jax", []), (main, "port", CPU)):
        mod.main(["--mode", "train_only", "--run_dir", str(tmp_path / name),
                  "--config", str(cfg_path), "--test_by_provided_data", "QM9",
                  "--dataset_path", str(root), "--num_epochs", "0", *extra])
    got, want = (from_dict(json.load(open(tmp_path / d / "config.json")))
                 for d in ("port", "jax"))
    assert got == want
    assert (got.atom_type_size, got.conditional, got.give_exO) == (5, False,
                                                                   False)
    got, want = (json.load(open(tmp_path / d / "profile.json"))
                 for d in ("port", "jax"))
    assert {k: v["count"] for k, v in got.items()} == \
        {k: v["count"] for k, v in want.items()} == {"checkpoint": 1}


def test_main_refuses_without_data_or_card(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="--synthetic"):
        main.main(["--mode", "train_only", "--run_dir", str(tmp_path / "x"),
                   *CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main.main(["--mode", "train_only", "--run_dir", str(tmp_path / "y"),
                   "--synthetic", "8"])


@pytest.mark.parametrize("accepted_only", [True, False])
def test_load_results_drops_rejects_as_jax(tmp_path, accepted_only):
    rng = np.random.default_rng(0)
    s, n = 6, 4
    res = {"original_pos": rng.normal(size=(s, n, 3)),
           "mask": np.ones((s, n)), "trajectory_pos":
           rng.normal(size=(3, s, n, 3)),
           "accepted": np.array([1, 0, 1, 1, 0, 1], bool)}
    out = tmp_path / "generated.npz"
    np.savez(out, **res, ids=np.asarray([f"c{i // 2}" for i in range(s)]))
    RunLogger(str(tmp_path)).register_artifact("generated_graph_save_path",
                                               str(out))
    got = common.load_results(str(tmp_path), accepted_only=accepted_only)
    want = jax_common.load_results(str(tmp_path),
                                   accepted_only=accepted_only)
    assert sorted(got) == sorted(want)
    assert got["ids"] == want["ids"]
    for k in res:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["trajectory_pos"].shape[1] == (4 if accepted_only else 6)
    np.testing.assert_array_equal(common.trim(got["original_pos"],
                                              got["mask"], 1),
                                  jax_common.trim(want["original_pos"],
                                                  want["mask"], 1))


def nested_keys(d: dict, prefix="") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= nested_keys(v, prefix + k + "/")
    return out


def test_generate_amorphous_panel_as_jax(runs):
    argv = ["--amorphous", "2", "--num_atoms", "24", "--generator",
            "network", "--gen_num_per_spectrum", "1", "--batch_size", "2",
            "--panel"]
    jax_amorphous.main(["--run_dir", str(runs[0]), *argv])
    generate_amorphous.main(["--run_dir", str(runs[1]), *argv, *CPU])
    got, want = (json.load(open(d / "amorphous_panel.json")) for d in runs)
    assert nested_keys(got) == nested_keys(want)
    assert {"accepted", "finite_fraction"} <= set(want)
    g, w = (np.load(d / "generated_amorphous.npz") for d in runs)
    assert sorted(g.files) == sorted(w.files)
    for k in w.files:
        assert g[k].shape == w[k].shape, k
    np.testing.assert_array_equal(g["ids"], w["ids"])
    assert (runs[1] / "figures" / "atom_type_eval_amorphous.png").exists()


def test_generate_amorphous_ring_in_a_world_of_one(runs, tmp_path):
    import shutil

    import torch.distributed as dist

    dirs = tmp_path / "ring", tmp_path / "dense"
    for d in dirs:
        shutil.copytree(runs[1], d)
    argv = ["--synthetic", "1", "--gen_num_per_spectrum", "1", *CPU]
    try:
        generate_amorphous.main(["--run_dir", str(dirs[0]), *argv, "--ring"])
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    generate_amorphous.main(["--run_dir", str(dirs[1]), *argv])
    got, want = (np.load(d / "generated_amorphous.npz") for d in dirs)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["generated_pos"], want["generated_pos"],
                               rtol=2e-4, atol=2e-4)


def test_macro_f1_bit_for_bit():
    rng = np.random.default_rng(1)
    for _ in range(5):
        y = rng.integers(3, 10, 40)
        p = np.where(rng.random(40) < 0.7, y, rng.integers(2, 11, 40))
        assert cn.macro_f1(y, p) == jax_cn.macro_f1(y, p)


def printed(out: str) -> tuple:
    mse = [float(v) for v in re.findall(r"train_mse ([-\d.eE+]+)", out)]
    final = re.search(r"test MAE ([\d.]+)  rounded accuracy ([\d.]+)  "
                      r"macro-F1 ([\d.]+)", out)
    return mse, [float(v) for v in final.groups()]


def test_cn_trains_as_jax_from_its_init(capsys):
    argv = ["--synthetic", "64", "--epochs", "101", "--seed", "7"]
    jax_cn.main(argv)
    want_mse, want_final = printed(capsys.readouterr().out)
    graphs = jax_synthetic(7, 64, 16, spectrum_size=JaxConfig().spectrum_size)
    x_tr, _ = jax_cn.graphs_to_xy(jax_split(graphs, 7)[0])
    params = jax.tree.map(np.asarray, JaxCNPredictor().init(
        jax.random.key(7), x_tr[:1]))
    got = cn.main(argv + CPU, params=params)
    got_mse, got_final = printed(capsys.readouterr().out)
    assert len(got_mse) == len(want_mse) == 3
    np.testing.assert_allclose(got_mse, want_mse, rtol=1e-4)
    np.testing.assert_allclose(got_final, want_final, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        [got["mae"], got["accuracy"], got["macro_f1"]], want_final, rtol=0,
        atol=5e-5 + 1e-4)
