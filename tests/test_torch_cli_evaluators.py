"""The port's dataset and evaluator CLIs (``cli/make_dataset.py``,
``create_xyz.py``, ``template_matching.py``, ``evaluate_rdf.py``,
``evaluate_rmsd.py``, ``evaluate_cn2.py``, ``evaluate_si_o_si.py``,
``evaluate_fingerprint.py``) against the JAX package's, on the CPU.

Each pair runs on one ``generated.npz`` (seeded synthetic conditions of
5-9 atoms, each sampled twice as a jittered copy, a few species flipped in
the graphs of 7 or more atoms, two samples rejected), in a run directory
of its own. The numbers each logs to ``metrics.jsonl`` and the files each
writes are held equal, with
the tolerances of the functions underneath (``test_torch_evals.py``,
``test_torch_evaluate.py``): numpy on both sides (CN2 readout,
fingerprints, dataset files) bit for bit, the float32 Kabsch RMSDs (and
the RMSD an xyz comment quotes) at rtol 1e-5, the RDF metrics at the
curves' rtol 1e-5, the Si-O-Si angles at rtol 1e-6, descriptor
similarities at atol 1e-5.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_tpu.cli import create_xyz as jax_create_xyz
from diffusion_model_tpu.cli import evaluate_cn2 as jax_evaluate_cn2
from diffusion_model_tpu.cli import evaluate_fingerprint as jax_fingerprint
from diffusion_model_tpu.cli import evaluate_rdf as jax_evaluate_rdf
from diffusion_model_tpu.cli import evaluate_rmsd as jax_evaluate_rmsd
from diffusion_model_tpu.cli import evaluate_si_o_si as jax_evaluate_si_o_si
from diffusion_model_tpu.cli import make_dataset as jax_make_dataset
from diffusion_model_tpu.cli import template_matching as jax_template
from diffusion_model_tpu.data import native as jax_native
from diffusion_model_tpu.data.io import load_dataset as jax_load_dataset
from diffusion_model_tpu_torch.cli import (
    create_xyz,
    evaluate_cn2,
    evaluate_fingerprint,
    evaluate_rdf,
    evaluate_rmsd,
    evaluate_si_o_si,
    make_dataset,
    template_matching,
)
from diffusion_model_tpu_torch.cli.main import save_generated
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.io import load_dataset
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.utils.logging import RunLogger

torch.set_num_threads(4)

CASTEP = Path(__file__).resolve().parent / "fixtures" / "castep"
G = 2          # samples a condition
RTOL = 1e-5    # float32 Kabsch, RDF curves
CPU = ["--device", "cpu"]


def generated_results(seed=5, conditions=12) -> dict:
    """A results dict as ``api.generate`` returns it."""
    graphs = synthetic_sio2_dataset(seed, conditions, 16, spectrum_size=16,
                                    shells=2)
    cond = collate(graphs, 16, "cpu")
    rng = np.random.default_rng(seed)
    mask = np.repeat(cond.mask.numpy(), G, 0)
    pos = np.repeat(cond.pos.numpy(), G, 0)
    species = np.repeat(cond.species.numpy(), G, 0)
    gen_pos = (pos + rng.normal(0, 0.05, pos.shape)) * mask[..., None]
    gen_species = species.copy()
    # species flipped in the larger graphs only, so the CN2 ones (5 atoms)
    # keep their two Si and their groups count
    flip = (rng.random(mask.shape) < 0.1) & (mask > 0) & \
        (mask.sum(-1) >= 7)[:, None]
    gen_species[flip] = gen_species[flip][:, ::-1]
    accepted = np.ones(len(mask), bool)
    accepted[[3, 10]] = False
    return {"ids": [g["id"] for g in graphs for _ in range(G)],
            "original_pos": pos, "original_species": species, "mask": mask,
            "generated_pos": gen_pos.astype(np.float32),
            "generated_species": gen_species,
            "generated_h": gen_species,
            "finite": np.ones(len(mask), bool), "accepted": accepted}


@pytest.fixture
def run_dirs(tmp_path):
    """(JAX run dir, port run dir): the same config, ``generated.npz`` and
    artifact registry in each."""
    first = tmp_path / "jax"
    logger = RunLogger(str(first), Config(gen_num_per_spectrum=G))
    out = first / "generated.npz"
    save_generated(generated_results(), str(out))
    logger.register_artifact("generated_graph_save_path", str(out))
    second = tmp_path / "port"
    shutil.copytree(first, second)
    RunLogger(str(second)).register_artifact("generated_graph_save_path",
                                             str(second / "generated.npz"))
    return first, second


def metrics(run_dir: Path) -> list:
    path = run_dir / "metrics.jsonl"
    if not path.exists():
        return []
    return [{k: v for k, v in json.loads(x).items() if k != "time"}
            for x in open(path)]


def figures(run_dir: Path) -> set:
    return {p.name for p in (run_dir / "figures").iterdir()}


def same_metrics(got: list, want: list, rtol: float) -> None:
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=rtol, err_msg=k)
            else:
                assert g[k] == v, k


def same_xyz_trees(got: Path, want: Path) -> None:
    """The same files and lines, the elements and ids equal; the RMSD a
    comment quotes at ``RTOL``, and the coordinates (an aligned set is the
    float32 Kabsch rotation's on each side) at ``RTOL`` with an absolute
    floor of ``RTOL`` of the set's scale."""
    names = sorted(p.relative_to(want) for p in want.rglob("*.xyz"))
    assert names and names == sorted(p.relative_to(got)
                                     for p in got.rglob("*.xyz"))
    for name in names:
        g_lines = (got / name).read_text().split("\n")
        w_lines = (want / name).read_text().split("\n")
        assert len(g_lines) == len(w_lines), name
        g_id, g_rmsd = g_lines[1].rsplit(" ", 1)
        w_id, w_rmsd = w_lines[1].rsplit(" ", 1)
        assert g_lines[0] == w_lines[0] and g_id == w_id, name
        np.testing.assert_allclose(float(g_rmsd), float(w_rmsd), rtol=RTOL)
        g_rows = [line.split() for line in g_lines[2:] if line]
        w_rows = [line.split() for line in w_lines[2:] if line]
        assert [r[0] for r in g_rows] == [r[0] for r in w_rows], name
        w_xyz = np.asarray([r[1:] for r in w_rows], float)
        np.testing.assert_allclose(
            np.asarray([r[1:] for r in g_rows], float), w_xyz, rtol=RTOL,
            atol=RTOL * np.abs(w_xyz).max(), err_msg=str(name))


@pytest.mark.parametrize("metric", ["cos", "euclidean", "mse",
                                    "wasserstein"])
def test_evaluate_rdf_matches_jax(run_dirs, metric):
    jax_dir, port_dir = run_dirs
    jax_evaluate_rdf.main(["--run_dir", str(jax_dir), "--metric", metric])
    evaluate_rdf.main(["--run_dir", str(port_dir), "--metric", metric, *CPU])
    same_metrics(metrics(port_dir), metrics(jax_dir), RTOL)
    assert figures(port_dir) == figures(jax_dir) == {
        f"rdf_{metric}_hist.png", f"rdf_{metric}_panels.png"}


def test_evaluate_rmsd_matches_jax(run_dirs):
    """Graphs of at most 7 atoms (the 9-atom ones skipped as too large)."""
    jax_dir, port_dir = run_dirs
    jax_evaluate_rmsd.main(["--run_dir", str(jax_dir), "--max_atoms", "7"])
    evaluate_rmsd.main(["--run_dir", str(port_dir), "--max_atoms", "7",
                        *CPU])
    want = np.load(jax_dir / "rmsd_xyz" / "sorted_id_rmsd.npz")
    got = np.load(port_dir / "rmsd_xyz" / "sorted_id_rmsd.npz")
    assert 0 < len(want["ids"]) < 22
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["rmsd"], want["rmsd"], rtol=RTOL)
    same_xyz_trees(port_dir / "rmsd_xyz", jax_dir / "rmsd_xyz")
    assert figures(port_dir) == figures(jax_dir) == {"perm_rmsd.png"}


def test_evaluate_cn2_matches_jax(run_dirs):
    jax_dir, port_dir = run_dirs
    jax_evaluate_cn2.main(["--run_dir", str(jax_dir)])
    evaluate_cn2.main(["--run_dir", str(port_dir)])
    want = metrics(jax_dir)
    assert metrics(port_dir) == want
    assert np.isfinite(want[0]["cn2_angle_r2"])
    assert figures(port_dir) == figures(jax_dir) == {
        "cn2_angle_scatter.png", "cn2_bond_scatter.png"}


def test_evaluate_si_o_si_matches_jax(run_dirs):
    jax_dir, port_dir = run_dirs
    jax_evaluate_si_o_si.main(["--run_dir", str(jax_dir)])
    evaluate_si_o_si.main(["--run_dir", str(port_dir), *CPU])
    want = metrics(jax_dir)
    assert want and want[0]["si_o_si_count"] > 0
    same_metrics(metrics(port_dir), want, 1e-6)
    assert figures(port_dir) == figures(jax_dir) == {"si_o_si_angle.png"}


@pytest.mark.parametrize("method", ["atom_pair", "morgan"])
def test_evaluate_fingerprint_matches_jax(run_dirs, method):
    jax_dir, port_dir = run_dirs
    jax_fingerprint.main(["--run_dir", str(jax_dir), "--method", method])
    evaluate_fingerprint.main(["--run_dir", str(port_dir), "--method",
                               method])
    want = metrics(jax_dir)
    assert metrics(port_dir) == want
    assert 0.0 < want[0]["fingerprint_similarity_mean"] <= 1.0
    assert figures(port_dir) == figures(jax_dir)


def test_create_xyz_matches_jax(run_dirs):
    """Both alignment routes: 5-atom graphs by permutation, 7 and 9 by
    Kabsch on the nearest atoms and a global assignment."""
    jax_dir, port_dir = run_dirs
    jax_create_xyz.main(["--run_dir", str(jax_dir)])
    create_xyz.main(["--run_dir", str(port_dir), *CPU])
    assert len(list((port_dir / "xyz_pairs").iterdir())) == 22
    same_xyz_trees(port_dir / "xyz_pairs", jax_dir / "xyz_pairs")


def test_make_dataset_and_template_matching_match_jax(tmp_path, monkeypatch,
                                                      capsys):
    """The dataset files of both packages hold the same graphs (positions
    to 1e-6 A, where the port's native shell builder may have built
    them); template matching over them ranks alike."""
    # the JAX package's numpy route: its native library is not built here
    monkeypatch.setattr(jax_native, "_load_failed", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    corpus = tmp_path / "corpus"
    shutil.copytree(CASTEP, corpus)
    out = {}
    for name, mod, extra in (("jax", jax_make_dataset, []),
                             ("port", make_dataset, [])):
        mod.main(["--range", "2NN", "--cell_dir_path", str(corpus),
                  "--save_dir_path", str(tmp_path / name), *extra])
        out[name] = str(tmp_path / name / "dataset.npz")
    want, got = jax_load_dataset(out["jax"]), load_dataset(out["port"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "pos":
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g[k], w[k])
    assert "saved 2 graphs" in capsys.readouterr().out

    results = {}
    for name, mod, extra in (("jax", jax_template, []),
                             ("port", template_matching, CPU)):
        mod.main(["--reference_dataset_path", out["jax"],
                  "--target_dataset_path", out["jax"], "--save_dir",
                  str(tmp_path / f"tm_{name}"), *extra])
        with open(tmp_path / f"tm_{name}" /
                  "template_matching_result.json") as f:
            results[name] = json.load(f)
    assert list(results["port"]) == list(results["jax"])
    for tid, rows in results["jax"].items():
        got_rows = results["port"][tid]
        assert [list(r) for r in got_rows] == [list(r) for r in rows]
        for g, w in zip(got_rows, rows):
            (g_mse, g_sim), = g.values()
            (w_mse, w_sim), = w.values()
            assert g_mse == w_mse
            np.testing.assert_allclose(g_sim, w_sim, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mod,argv,figure", [
    (evaluate_rdf, CPU, "rdf_cos_hist"),
    (evaluate_rmsd, CPU, "perm_rmsd"),
    (evaluate_cn2, [], "cn2_angle_scatter"),
    (evaluate_si_o_si, CPU, "si_o_si_angle"),
    (evaluate_fingerprint, [], "fingerprint_similarity"),
], ids=["rdf", "rmsd", "cn2", "si_o_si", "fingerprint"])
def test_without_matplotlib_a_figure_raises_naming_it(run_dirs, monkeypatch,
                                                      mod, argv, figure):
    _, port_dir = run_dirs
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match=f"matplotlib.*{figure}|"
                       f"{figure}.*matplotlib"):
        mod.main(["--run_dir", str(port_dir), *argv])
    assert not (port_dir / "figures" / f"{figure}.png").exists()


def test_a_driver_on_the_card_without_one_refuses(run_dirs, monkeypatch):
    _, port_dir = run_dirs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        evaluate_rdf.main(["--run_dir", str(port_dir)])
