"""The whole slice: ``api.generate`` from the learned-schedule snapshot in
both packages, and the port's scoring (``evals.restore_check``) against
the JAX scoring tail of ``benchmarks/npz_restore_check.py``.

Both sides sample three test conditions of ``q_learned_r5_s2025.npz`` x 2
in float32 over 10 snr-grid steps, in chunks of two (the last padded and
trimmed), with the trajectory; the port replays JAX's draws. Flags and
species equal; positions and frames rtol 1e-3 / atol 1e-2 A, or, where
larger, the distance JAX's own run moves when its denoiser's output is
perturbed by 1e-6 relative: this chain is chaotic in both packages (a
difference grows ~5x a step over its last six steps; 0.095 A from a 1e-6
perturbation, against 0.015 A between the packages), and
``test_torch_gamma.py`` holds each of its steps at 1e-2 A. Scores of one
result dict agree within 1e-6 (the RDF curves are float32 on both sides).
"""

import json

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu import api as jax_api
from diffusion_model_tpu.evals import (
    conditional_angle_parity,
    evaluate_rdf_lists,
    r2score,
)
from diffusion_model_tpu.train import Trainer
from diffusion_model_tpu.train import checkpoint as jax_ckpt
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.evals import restore_check
from diffusion_model_tpu_torch.evals.restore_check import (
    held_out_conditions,
    score,
)
from test_torch_evals import cn2_results
from torch_port_fixtures import (
    SNAPSHOT,
    Replay,
    SnapshotState,
    jax_sample_draws,
)

torch.set_num_threads(4)

LEARNED = SNAPSHOT.parent / "q_learned_r5_s2025.npz"
COPIES = 2
BATCH = 2
STEPS = 10
EVERY = 3
POS_TOL = dict(rtol=1e-3, atol=1e-2)
SCORES = ("finite_fraction", "accepted_fraction", "rdf_cos_mean",
          "rdf_cos_median", "cn2_angle_r2", "cn2_angle_conditions")


def jax_score(results: dict, group: int) -> dict:
    """``benchmarks/npz_restore_check.py:77-87`` on one result dict."""
    keep = np.nonzero(results["accepted"])[0]
    rdf_rows = evaluate_rdf_lists(
        results["original_pos"][keep], results["mask"][keep],
        results["generated_pos"][keep], results["mask"][keep])
    rdf_cos = np.asarray([r["cos"] for r in rdf_rows])
    avg_o, avg_g = conditional_angle_parity(results, group)
    angle_r2 = r2score(avg_o, avg_g) if len(avg_o) >= 3 else None
    return {
        "finite_fraction": float(results["finite"].mean()),
        "accepted_fraction": float(results["accepted"].mean()),
        "rdf_cos_mean": float(rdf_cos.mean()),
        "rdf_cos_median": float(np.median(rdf_cos)),
        "cn2_angle_r2": None if angle_r2 is None else float(angle_r2),
        "cn2_angle_conditions": len(avg_o),
    }


class PerturbedTrainer(Trainer):
    """The JAX trainer whose denoiser's output is multiplied by
    ``1 + 1e-6 N(0, 1)`` elementwise (a fixed key): the size of a float32
    rounding difference."""

    def denoise_fn(self, params):
        inner = super().denoise_fn(params)

        def denoise(*args):
            k = jax.random.key(7)
            return tuple(e * (1 + 1e-6 * jax.random.normal(k, e.shape))
                         for e in inner(*args))
        return denoise


def assert_scores_close(got: dict, want: dict, tol: float = 1e-6):
    assert sorted(got) == sorted(want) == sorted(SCORES)
    for k in SCORES:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.fixture(scope="module")
def both():
    jcfg = jax_ckpt.load_config_npz(str(LEARNED))
    params = jax_ckpt.load_params_npz(str(LEARNED))
    jcfg = jcfg.replace(compute_dtype="float32", sample_steps=STEPS,
                        sample_grid="snr", snapshot_every=EVERY)
    cfg = from_dict(jcfg.to_dict())
    graphs = held_out_conditions(cfg)[:3]
    key = jax.random.key(41)
    run = dict(key=key, gen_num_per_spectrum=COPIES, batch_size=BATCH,
               return_trajectory=True)
    want = jax_api.generate(jcfg, Trainer(jcfg), SnapshotState(params),
                            graphs, **run)
    moved = jax_api.generate(jcfg, PerturbedTrainer(jcfg),
                             SnapshotState(params), graphs, **run)
    spread = {k: float(np.abs(want[k] - moved[k]).max())
              for k in ("generated_pos", "trajectory_pos")}
    draws, k = [], key
    for _ in range(0, len(graphs), BATCH):
        k, sub = jax.random.split(k)
        draws += jax_sample_draws(sub, BATCH * COPIES, cfg.n_max,
                                  cfg.atom_type_size, STEPS, stochastic=True)
    noise = Replay(draws)
    got = api.generate(cfg, params, graphs, gen_num_per_spectrum=COPIES,
                       batch_size=BATCH, device="cpu", noise=noise,
                       return_trajectory=True)
    assert not noise.draws
    return want, got, spread


def pos_tol(spread: float) -> dict:
    return dict(rtol=POS_TOL["rtol"], atol=max(POS_TOL["atol"], spread))


def test_learned_generation_matches_jax(both):
    want, got, spread = both
    assert sorted(got) == sorted(want)
    for k in ("finite", "accepted", "original_pos", "original_species",
              "mask", "generated_species"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["accepted"].all()
    np.testing.assert_allclose(got["generated_h"], want["generated_h"],
                               **POS_TOL)
    np.testing.assert_allclose(got["generated_pos"], want["generated_pos"],
                               **pos_tol(spread["generated_pos"]))


def test_trajectory_matches_jax(both):
    want, got, spread = both
    frames = -(-STEPS // EVERY)
    for k, width, tol in (
            ("trajectory_pos", 3, pos_tol(spread["trajectory_pos"])),
            ("trajectory_h", 2, POS_TOL)):
        assert got[k].shape == want[k].shape == (frames, 3 * COPIES, 16,
                                                 width), k
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)
    # frame 0 is the pure noise: CoM-free over the real rows
    mask = got["mask"][..., None]
    com = (got["trajectory_pos"][0] * mask).sum(1) / mask.sum(1)
    np.testing.assert_allclose(com, 0.0, atol=1e-6)


def test_score_equals_the_jax_scoring_tail(both):
    _, got, _ = both
    assert_scores_close(score(got, COPIES, device="cpu"),
                        jax_score(got, COPIES))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_of_a_made_up_result_equals_jax(seed):
    res = cn2_results(seed)
    assert res["accepted"].mean() < 1
    want = jax_score(res, 5)
    assert want["cn2_angle_r2"] is not None
    assert_scores_close(score(res, 5, device="cpu"), want)


def test_restore_check_scores_its_own_generation(tmp_path, capsys):
    """The entry point end to end on the CPU, on a copy of the flagship
    snapshot cut to 4 snr steps, in float32, with a 20-graph dataset (two
    test conditions) and sampling seed 5, against ``score`` of
    ``api.generate`` on the same conditions and seed."""
    with np.load(SNAPSHOT) as z:
        arrays = {k: z[k] for k in z.files}
    cfg_json = json.loads(str(arrays["__config_json__"][()]))
    cfg_json.update(sample_steps=4, sample_grid="snr")
    arrays["__config_json__"] = np.array(json.dumps(cfg_json))
    path = tmp_path / "cut.npz"
    np.savez(path, **arrays)
    out = tmp_path / "score.json"

    assert restore_check.main([str(path), "--device", "cpu", "--num", "20",
                               "--compute_dtype", "float32", "--seed", "5",
                               "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == printed
    assert printed["device"] == "cpu" and printed["seed"] == 5
    assert printed["compute_dtype"] == "float32"
    assert printed["n_test_conditions"] == 2
    assert printed["samples"] == 10

    cfg = from_dict(cfg_json).replace(compute_dtype="float32")
    conditions = held_out_conditions(cfg, 20)
    results = api.generate(cfg, restore_check.load_params_npz(str(path)),
                           conditions, torch.Generator().manual_seed(5),
                           device="cpu")
    assert_scores_close({k: printed[k] for k in SCORES},
                        score(results, cfg.gen_num_per_spectrum, "cpu"),
                        tol=0.0)


@pytest.mark.parametrize("grid", ["uniform", "snr"])
def test_restore_check_samples_strided(tmp_path, capsys, monkeypatch, grid):
    """``--sample_steps 250 --sample_grid <grid>`` on a tiny snapshot (one
    EGCL of width 16, 1000-step schedule, no retry: an untrained chain is
    not accepted): the chunk reaches ``sample`` with the 250-step grid of
    the schedule (251 denoiser calls), and the JSON line names the steps
    and the grid."""
    from diffusion_model_tpu_torch.config import Config
    from diffusion_model_tpu_torch.diffusion import sampler
    from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
    from diffusion_model_tpu_torch.train.checkpoint import save_params_npz
    from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree

    cfg = Config(L=1, m_hidden_size=16, h_hidden_size=16, x_hidden_size=16,
                 m_size=8, compressed_spectrum_size=8,
                 compressor_hidden_dim=(16,), optimizer="Adam",
                 max_nan_retries=0)
    state = Trainer(cfg, device="cpu").init_state(0)
    path = tmp_path / "tiny.npz"
    save_params_npz(params_tree(state.eval_params(cfg)), str(path), cfg=cfg)
    grids, calls = [], [0]
    strided = sampler._strided

    def recording(schedule, c):
        out = strided(schedule, c)
        grids.append((c.sample_steps, c.sample_grid, out[2],
                      out[0].alphas.shape[0]))
        return out

    forward = DiffusionDenoiser.forward

    def counting(self, *args):
        calls[0] += 1
        return forward(self, *args)

    monkeypatch.setattr(sampler, "_strided", recording)
    monkeypatch.setattr(DiffusionDenoiser, "forward", counting)
    assert restore_check.main([str(path), "--device", "cpu", "--num", "20",
                               "--sample_steps", "250", "--sample_grid",
                               grid]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["sample_steps"] == 250
    assert printed["sample_grid"] == grid
    assert printed["samples"] == 10
    assert grids == [(250, grid, 250, 251)]
    assert calls[0] == 251
