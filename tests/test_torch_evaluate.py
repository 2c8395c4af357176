"""The port's run evaluation (``ops.kabsch``, ``evals.rmsd``,
``evals.density``, ``data.xyz``, ``api.evaluate``, ``api.record_schedule``)
against the JAX package's, on the CPU.

Kabsch and the RMSD evaluators are float32 with a 3 x 3 SVD on each side
(LAPACK through XLA, LAPACK through PyTorch): rotations, aligned sets and
RMSDs at rtol 1e-5 (atol 1e-5 of the set's scale for entries near zero),
orders and indices equal. The O densities are numpy on both sides: bit for
bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu import api as jax_api
from diffusion_model_tpu.data import xyz as jax_xyz
from diffusion_model_tpu.evals import density as jax_density
from diffusion_model_tpu.evals import rmsd as jax_rmsd
from diffusion_model_tpu.ops.kabsch import kabsch as jax_kabsch
from diffusion_model_tpu.ops.kabsch import kabsch_rmsd as jax_kabsch_rmsd
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu.train.checkpoint import (
    load_config_npz as jax_load_config,
)
from diffusion_model_tpu.train.checkpoint import (
    load_params_npz as jax_load_params,
)
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.data import xyz
from diffusion_model_tpu_torch.evals import density, rmsd
from diffusion_model_tpu_torch.ops import kabsch
from diffusion_model_tpu_torch.train.checkpoint import (
    load_config_npz,
    load_params_npz,
)
from diffusion_model_tpu_torch.train.trainer import Trainer
from torch_port_fixtures import SNAPSHOT, SnapshotState

torch.set_num_threads(4)

LEARNED = SNAPSHOT.parent / "q_learned_r5_s2025.npz"
RTOL = 1e-5


def random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def point_sets(seed, b=6, n=8, reflect=False):
    """``p`` a rotated, shifted, jittered copy of ``q`` (mirrored where
    ``reflect``), and a mask of 3..n real points a set."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n, 3)).astype(np.float32) * 2.0
    p = np.empty_like(q)
    for i in range(b):
        rot = random_rotation(rng)
        if reflect:
            rot = rot @ np.diag([1.0, 1.0, -1.0])
        p[i] = q[i] @ rot.T + rng.normal(size=3) \
            + 0.1 * rng.normal(size=(n, 3))
    sizes = rng.integers(3, n + 1, size=b)
    mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)
    return p.astype(np.float32), q, mask


def close(got, want, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_kabsch_matches_jax(reflect, masked):
    p, q, mask = point_sets(3 + reflect, reflect=reflect)
    m = mask if masked else None
    want = jax_kabsch(jnp.asarray(p), jnp.asarray(q),
                             None if m is None else jnp.asarray(m))
    got = kabsch.kabsch(torch.from_numpy(p), torch.from_numpy(q),
                        None if m is None else torch.from_numpy(m))
    for g, w in zip(got, want):
        close(g.numpy(), w, scale=float(np.abs(q).max()))
    r = got[0].numpy()
    np.testing.assert_allclose(np.linalg.det(r), 1.0, rtol=1e-5)
    close(kabsch.kabsch_rmsd(torch.from_numpy(p), torch.from_numpy(q),
                             None if m is None else torch.from_numpy(m)),
          jax_kabsch_rmsd(jnp.asarray(p), jnp.asarray(q),
                          None if m is None else jnp.asarray(m)))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_kabsch_of_a_set_that_is_not_finite_is_nan_as_in_jax(bad):
    """A set with a non-finite point reads NaN in both packages (the CPU's
    SVD would raise on it); the other sets keep their values and their
    gradients bit for bit."""
    p, q, mask = point_sets(5)
    p[2, 1, 0] = p[4, 0, 2] = bad
    want = np.asarray(jax_kabsch_rmsd(jnp.asarray(p), jnp.asarray(q),
                                      jnp.asarray(mask)))
    pt = torch.from_numpy(p).requires_grad_(True)
    got = kabsch.kabsch_rmsd(pt, torch.from_numpy(q), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                  np.isnan(want))
    assert np.isnan(want).sum() == 2
    ok = [0, 1, 3, 5]
    close(got.detach().numpy()[ok], want[ok])
    got[ok].sum().backward()
    alone = torch.from_numpy(p[ok]).requires_grad_(True)
    ref = kabsch.kabsch_rmsd(alone, torch.from_numpy(q[ok]),
                             torch.from_numpy(mask[ok]))
    ref.sum().backward()
    assert torch.equal(got.detach()[ok], ref.detach())
    assert torch.equal(pt.grad[ok], alone.grad)


def test_kabsch_recovers_a_rotation_exactly_up_to_rounding():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(7, 3)).astype(np.float32)
    rot = random_rotation(rng).astype(np.float32)
    p = (q @ rot.T).astype(np.float32)
    r = kabsch.kabsch_rmsd(torch.from_numpy(p), torch.from_numpy(q))
    assert float(r) < 1e-5


def evaluation_results(seed=0, g=14, n=8):
    """A seeded results dict as ``generate`` returns it: original and
    generated structures (some species flipped), a mask, ids, and a few
    rejected samples."""
    rng = np.random.default_rng(seed)
    p, q, mask = point_sets(seed, b=g, n=n)
    species = np.zeros((g, n, 2), np.float32)
    species[..., 0] = rng.random((g, n)) < 0.7
    species[..., 1] = 1.0 - species[..., 0]
    gen_species = species.copy()
    flip = rng.random((g, n)) < 0.1
    gen_species[flip] = gen_species[flip][:, ::-1]
    accepted = np.ones(g, bool)
    accepted[[2, 9]] = False
    return {
        "ids": [f"c{i // 2}" for i in range(g)],
        "original_pos": q * mask[..., None],
        "original_species": species * mask[..., None],
        "mask": mask,
        "generated_pos": p * mask[..., None],
        "generated_species": gen_species * mask[..., None],
        "finite": np.ones(g, bool),
        "accepted": accepted,
    }


def test_evaluate_by_rmsd_matches_jax():
    res = evaluation_results()
    args = (res["original_pos"], res["generated_pos"], res["mask"])
    want = jax_rmsd.evaluate_by_rmsd(*args, ids=res["ids"])
    got = rmsd.evaluate_by_rmsd(*args, ids=res["ids"], device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want]
    close([r[1] for r in got], [r[1] for r in want])


def test_evaluate_by_rmsd_and_atom_type_matches_jax():
    res = evaluation_results(1)
    args = (res["original_pos"], res["original_species"],
            res["generated_pos"], res["generated_species"], res["mask"])
    want = jax_rmsd.evaluate_by_rmsd_and_atom_type(*args)
    got = rmsd.evaluate_by_rmsd_and_atom_type(*args, device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want]
    close([r[1] for r in got], [r[1] for r in want])
    assert [r[2] for r in got] == [r[2] for r in want]


def test_permutation_min_rmsd_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.normal(size=(6, 3)).astype(np.float32)
    g = (o[[0, 3, 1, 5, 2, 4]] @ random_rotation(rng).T.astype(np.float32)
         + 0.05 * rng.normal(size=(6, 3))).astype(np.float32)
    want = jax_rmsd.permutation_min_rmsd(o, g)
    got = rmsd.permutation_min_rmsd(o, g, device="cpu")
    assert got[1] == want[1] == [0, 2, 4, 1, 5, 3]
    close(got[0], want[0])
    close(got[2], want[2], scale=float(np.abs(o).max()))
    assert rmsd.permutation_min_rmsd(np.zeros((11, 3)), np.zeros((11, 3)),
                                     device="cpu") is None


def test_hungarian_align_matches_jax():
    rng = np.random.default_rng(7)
    o = rng.normal(size=(14, 3)).astype(np.float32) * 2
    perm = np.concatenate([[0], 1 + rng.permutation(13)])
    g = (o[perm] @ random_rotation(rng).T.astype(np.float32)
         + 0.05 * rng.normal(size=(14, 3))).astype(np.float32)
    want = jax_rmsd.hungarian_align(o, g)
    got = rmsd.hungarian_align(o, g, device="cpu")
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    close(got[3], want[3], scale=float(np.abs(o).max()))
    assert rmsd._nearest_to_exo(o) == jax_rmsd._nearest_to_exo(o)


def test_o_density_and_accuracy_bit_for_bit():
    res = evaluation_results(2)
    for species in ("original_species", "generated_species"):
        np.testing.assert_array_equal(
            density.o_density(res[species], res["mask"]),
            jax_density.o_density(res[species], res["mask"]))
    a = density.o_density(res["original_species"], res["mask"])
    b = density.o_density(res["generated_species"], res["mask"])
    assert density.density_accuracy(a, b) == \
        jax_density.density_accuracy(a, b)


def test_xyz_writers_byte_equal(tmp_path):
    res = evaluation_results(3)
    n = int(res["mask"][0].sum())
    args = (res["original_pos"][0][:n], res["original_species"][0][:n],
            res["generated_pos"][0][:n], res["generated_species"][0][:n])
    xyz.write_xyz_overlay(str(tmp_path / "port.xyz"), *args, comment="c")
    jax_xyz.write_xyz_overlay(str(tmp_path / "jax.xyz"), *args, comment="c")
    assert (tmp_path / "port.xyz").read_bytes() == \
        (tmp_path / "jax.xyz").read_bytes()
    traj = np.stack([res["generated_pos"][0][:n]] * 3)
    xyz.write_xyz_trajectory(str(tmp_path / "pt.xyz"), traj, args[3])
    jax_xyz.write_xyz_trajectory(str(tmp_path / "jt.xyz"), traj, args[3])
    assert (tmp_path / "pt.xyz").read_bytes() == \
        (tmp_path / "jt.xyz").read_bytes()
    pos, onehot, symbols = xyz.read_xyz(str(tmp_path / "port.xyz"))
    want = jax_xyz.read_xyz(str(tmp_path / "port.xyz"))
    np.testing.assert_array_equal(pos, want[0])
    np.testing.assert_array_equal(onehot, want[1])
    assert symbols == want[2]


def metrics(path):
    return [{k: v for k, v in json.loads(x).items() if k != "time"}
            for x in open(path)]


def rmsd_in_comment(line: str) -> float:
    return float(line.rsplit("rmsd: ", 1)[1])


def test_evaluate_matches_jax(tmp_path):
    res = evaluation_results(4)
    want = jax_api.evaluate(res, str(tmp_path / "jax"), create_xyz=True)
    got = api.evaluate(res, str(tmp_path / "port"), create_xyz=True,
                       device="cpu")
    assert sorted(got) == sorted(want)
    assert got["num_accepted"] == want["num_accepted"] == 12
    assert got["atom_type_accuracy"] == want["atom_type_accuracy"]
    assert [r[0] for r in got["sorted_rmsd"]] == \
        [r[0] for r in want["sorted_rmsd"]]
    close([r[1] for r in got["sorted_rmsd"]],
          [r[1] for r in want["sorted_rmsd"]])
    (g_line,), (w_line,) = (metrics(tmp_path / d / "metrics.jsonl")
                            for d in ("port", "jax"))
    assert sorted(g_line) == sorted(w_line)
    for k, v in w_line.items():
        if k.startswith("rmsd"):
            close(g_line[k], v)
        else:
            assert g_line[k] == v, k
    for d in ("figures", "."):
        names = {p.name for p in (tmp_path / "jax" / d).iterdir()
                 if p.suffix in (".png", ".xyz")}
        assert names == {p.name for p in (tmp_path / "port" / d).iterdir()
                         if p.suffix in (".png", ".xyz")}
    assert len(list((tmp_path / "port").glob("*.xyz"))) == 5
    assert {p.name for p in (tmp_path / "port" / "figures").iterdir()} == {
        "rmsd.png", "atom_type_eval.png"}
    for path in (tmp_path / "jax").glob("*.xyz"):
        got_lines = (tmp_path / "port" / path.name).read_text().split("\n")
        want_lines = path.read_text().split("\n")
        # every line byte for byte but the RMSD the comment quotes, which
        # is the float32 SVD's on each side (rtol 1e-5)
        assert got_lines[0] == want_lines[0]
        assert got_lines[1].rsplit("rmsd: ", 1)[0] == \
            want_lines[1].rsplit("rmsd: ", 1)[0]
        close(rmsd_in_comment(got_lines[1]), rmsd_in_comment(want_lines[1]))
        assert got_lines[2:] == want_lines[2:]
    assert json.load(open(tmp_path / "port" / "artifacts.json")) == {
        "rmsd_xyz_path": str(tmp_path / "port")}


def test_evaluate_with_nothing_accepted_follows_jax(tmp_path):
    res = evaluation_results(5)
    res["accepted"][:] = False
    want = jax_api.evaluate(res, str(tmp_path / "jax"))
    got = api.evaluate(res, str(tmp_path / "port"), device="cpu")
    assert got["num_accepted"] == want["num_accepted"] == 0
    assert got["sorted_rmsd"] == want["sorted_rmsd"] == []
    assert np.isnan(got["atom_type_accuracy"])
    assert metrics(tmp_path / "port" / "metrics.jsonl") == metrics(
        tmp_path / "jax" / "metrics.jsonl") == [{"num_accepted": 0}]


def test_evaluate_numbers_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        api.evaluate_numbers(evaluation_results())


class CurveLogger:
    """Keeps the curve of every figure logged (both packages' loggers have
    this method)."""

    def __init__(self):
        self.curves = {}

    def log_figure(self, name, fig):
        self.curves[name] = np.asarray(fig.axes[0].lines[0].get_ydata())
        return name


@pytest.mark.parametrize("npz", [SNAPSHOT, LEARNED], ids=["predefined",
                                                          "learned"])
def test_record_schedule_matches_jax(npz, tmp_path):
    jcfg = jax_load_config(str(npz))
    want = CurveLogger()
    paths = jax_api.record_schedule(jcfg, JaxTrainer(jcfg), SnapshotState(
        jax_load_params(str(npz))), str(tmp_path / "jax"), want)
    cfg = load_config_npz(str(npz)).replace(optimizer="Adam")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(cfg.seed, params=load_params_npz(str(npz)),
                               skip_gamma_fit=True)
    got = CurveLogger()
    assert api.record_schedule(cfg, trainer, state, str(tmp_path / "port"),
                               got) == paths
    names = ["alpha", "sigma", "SNR"] + (
        ["gamma"] if cfg.noise_schedule == "learned" else [])
    assert list(got.curves) == list(want.curves) == names
    if cfg.noise_schedule == "predefined":
        for name in names:
            np.testing.assert_allclose(got.curves[name], want.curves[name],
                                       rtol=1e-6, err_msg=name)
        return
    # the learned table: gamma at 1e-5 of its scale, alpha and sigma at
    # atol 5e-6, as tests/test_torch_gamma.py holds the same table (XLA's
    # and PyTorch's sigmoid, softplus and sum order part gamma by 3.1e-5
    # of its 24.6), and the SNR, exp(-gamma), at the same 1e-5 of gamma's
    # scale relative
    scale = float(np.abs(want.curves["gamma"]).max())
    np.testing.assert_allclose(got.curves["gamma"], want.curves["gamma"],
                               rtol=0, atol=1e-5 * scale)
    for name in ("alpha", "sigma"):
        np.testing.assert_allclose(got.curves[name], want.curves[name],
                                   rtol=0, atol=5e-6, err_msg=name)
    np.testing.assert_allclose(got.curves["SNR"], want.curves["SNR"],
                               rtol=1e-5 * scale)
    figures = api.record_schedule(cfg, trainer, state, str(tmp_path / "f"))
    assert sorted(figures) == sorted(names)
