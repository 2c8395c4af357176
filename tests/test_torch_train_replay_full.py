"""F9's full-width training replay (``tests/jax_replay_training_full.py``,
``tests/torch_replay_training_full.py``; record
``tests/fixtures/torch_port/train_replay_full_hres_vn.{json,npz}``): the
large-cell recipe at its own widths (12.5 M parameters, network cells of
160-192 atoms, kNN-32, batch 4), JAX's float32 and bfloat16 tracks of 150
steps from one numpy start.

* The port's first step on the CPU (plain route, float32) from the numpy
  start on the record's first batch and draws: its loss at rtol 1e-5 and
  gradient norm at 5e-3 of JAX's (the one-step tolerances), its leaf norms
  and sketch within the float32 drift bound of step 1.
* The sketch estimates a planted gap (the whole tree, a large leaf) within
  its ±25%, and the record's own estimates of JAX's bfloat16-to-float32 gap
  sit within that of the exact gap.
* The rule of F9 (``verdict``) passes a track equal to JAX's and refuses one
  that parts, in either dtype, by its parameters or its losses.
* The card's record (both tracks, 150 steps, through K2) carries the
  verdict the rule gives it.
"""

import copy
import json

import numpy as np
import pytest
import torch

import torch_replay_training_full as full

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def record():
    return full.load_fixture()


@pytest.fixture(scope="module")
def sketch(record):
    meta, _ = record
    start = full.port_leaves(full.numpy_start(meta["start"]["spec"],
                                              meta["start"]["seed"]))
    return full.Sketch(start, meta["sketch"]["seed"], meta["sketch"]["k"])


def test_first_step_on_the_cpu_matches_jax(record, sketch):
    meta, npz = record
    full.check_inputs(meta, npz, sketch)
    assert meta["parameters"] == 12_454_047
    port = full.replay_track(meta, npz, "float32", 1, "cpu", sketch)
    jax_f32 = meta["tracks"]["float32"]
    np.testing.assert_allclose(port["loss"], jax_f32["loss"][:1],
                               rtol=full.LOSS_RTOL)
    np.testing.assert_allclose(port["grad_norm"], jax_f32["grad_norm"][:1],
                               rtol=full.GRAD_RTOL)
    (rec,) = port["records"]
    assert rec["step"] == 1
    assert rec["gap"]["tree"] <= full.f32_l2_bound(1, meta["lr"],
                                                   meta["parameters"])
    bound = full.drift_bounds(1, meta["lr"])["param_abs"]
    for name, gap in rec["gap"]["top"].items():
        leaf = sketch.origin[name].size
        assert gap <= bound * leaf ** 0.5, name
    # each leaf's norm after the step, as JAX's to float32 rounding
    np.testing.assert_allclose(rec["norms"],
                               full.sketch_from(npz, "float32_1")["norms"],
                               rtol=1e-5)


def test_the_sketch_reads_a_planted_gap_within_its_tolerance(record, sketch):
    meta, _ = record
    origin = sketch.origin
    rng = np.random.default_rng(5)
    big = sketch.top[0]
    planted = {n: v + 1e-4 * rng.standard_normal(v.shape).astype(np.float32)
               for n, v in origin.items()}
    planted[big] = origin[big] + 3e-3 * rng.standard_normal(
        origin[big].shape).astype(np.float32)
    exact = full.exact_gap(planted, origin)
    zero = {"tree": np.zeros(sketch.k), "top": np.zeros((full.TOP_LEAVES,
                                                         sketch.k)),
            "small": np.zeros((len(sketch.names), full.SKETCH_K_SMALL))}
    est = sketch.gap(sketch(planted), zero)
    tol = full.SKETCH_TOL
    assert abs(est["tree"] / exact["tree"] - 1) <= tol
    assert abs(est["top"][big] / exact["leaf"][big] - 1) <= tol
    # the record's own estimates of JAX's bf16-to-f32 gap, from step 10
    for r in meta["jax_gap"]:
        if r["step"] < 10:
            continue
        assert abs(r["sketch"]["tree"] / r["exact"]["tree"] - 1) <= tol
        for n, g in r["sketch"]["top"].items():
            assert abs(g / r["exact"]["leaf"][n] - 1) <= tol, (r["step"], n)


def jax_as_port(meta: dict, npz) -> dict:
    """A port record equal to JAX's tracks: its losses and gradient norms,
    and at every record a zero gap (its sketches are JAX's own)."""
    out = {}
    for d in full.TRACKS:
        records = []
        for step in meta["records"]:
            s = full.sketch_from(npz, f"{d}_{step}")
            gap = {"tree": 0.0, "top": {n: 0.0 for n in meta["sketch"]["top"]},
                   "leaf": {n: 0.0 for n in meta["sketch"]["names"]}}
            assert s["tree"].shape == (meta["sketch"]["k"],)
            records.append({"step": step, "gap": gap})
        out[d] = {"loss": list(meta["tracks"][d]["loss"]),
                  "grad_norm": list(meta["tracks"][d]["grad_norm"]),
                  "records": records}
    return out


def test_the_rule_refuses_a_track_that_parts(record):
    meta, npz = record
    assert meta["steps"] == full.STEPS == 150
    assert meta["records"] == full.record_steps(150)
    assert meta["flags"] == full.FLAGS
    same = jax_as_port(meta, npz)
    assert full.verdict(meta, same)["outcome"] == "i"
    lr, size = meta["lr"], meta["parameters"]
    jgap = {r["step"]: r["exact"]["tree"] for r in meta["jax_gap"]}

    parted = copy.deepcopy(same)      # bf16 parameters part at step 50
    parted["bfloat16"]["records"][5]["gap"]["tree"] = 1.01 * \
        full.BF16_FACTOR * jgap[50]
    v = full.verdict(meta, parted)
    assert v["outcome"] == "ii" and v["bfloat16"]["gap_records_off"] == [50]

    parted = copy.deepcopy(same)      # bf16 losses part in steps 71-80
    jb, jf = meta["tracks"]["bfloat16"]["loss"], meta["tracks"]["float32"][
        "loss"]
    block = sum(abs(jb[k] - jf[k]) for k in range(70, 80))
    parted["bfloat16"]["loss"][75] += 2 * full.BF16_FACTOR * block + 1e-2 * \
        abs(jb[75])
    v = full.verdict(meta, parted)
    assert v["outcome"] == "ii" and v["bfloat16"]["loss_blocks_off"] == [71]

    parted = copy.deepcopy(same)      # f32 parameters part at step 150
    parted["float32"]["records"][-1]["gap"]["tree"] = 1.01 * \
        full.f32_l2_bound(150, lr, size)
    v = full.verdict(meta, parted)
    assert v["outcome"] == "iii" and v["float32"]["gap_records_off"] == [150]

    parted = copy.deepcopy(same)      # one f32 loss parts at step 1
    parted["float32"]["loss"][0] *= 1 + 2 * full.LOSS_RTOL
    v = full.verdict(meta, parted)
    assert v["outcome"] == "iii" and v["float32"]["loss_steps_off"] == [1]
    assert full.f32_l2_bound(150, 2e-4, 12_454_047) == pytest.approx(
        12_454_047 ** 0.5 * 150 * 2e-4 * 2 * 5e-3 * 0.1 / 0.001 ** 0.5)


def test_the_cards_record_carries_its_verdict(record):
    meta, _ = record
    with open(full.CARD_RECORD) as f:
        card = json.load(f)
    assert card["card"].startswith("NVIDIA H100")
    assert card["flags"] == full.FLAGS and card["steps"] == meta["steps"]
    for t in full.TRACKS:
        track = card["tracks"][t]
        assert len(track["loss"]) == len(track["grad_norm"]) == 150
        assert np.isfinite(track["loss"]).all()
        assert [r["step"] for r in track["records"]] == meta["records"]
    assert card["verdict"] == full.verdict(meta, card["tracks"])
