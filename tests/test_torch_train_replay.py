"""Training of the large-cell recipe (``h_residual+virtual_node``, kNN-32,
schedule-free RAdam at lr 2e-4, clip 1) replayed in both packages from
JAX's initialisation on JAX's batches and draws, on the CPU in float32
(``tests/jax_replay_training.py``; its record
``tests/fixtures/torch_port/train_replay_hres_vn.json``, 200 steps).

* The first 5 steps run live in both packages and are held to the record:
  each package's loss at the one-step loss tolerance (rtol 1e-5, that of
  ``test_torch_size_gen_check.py``), and the largest leaf gap within the
  drift bound of its step.
* The record's whole track is held to ``jax_replay_training.drift_bounds``:
  after k steps every parameter within ``k * lr * 2 * 5e-3 * (1 - b1) /
  sqrt(1 - b2)`` of JAX's (the gradient tolerance 5e-3 carried through
  clipping and RAdam's largest step), the final eval parameters too, and
  each step's loss gap within ``1e-5 * |loss| + grad_norm * ||param
  gap||_2``; the bound is shown to catch a track that parts. The track
  keeps well inside it: every step's loss agrees at the one-step loss
  tolerance itself.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax_replay_training as replay

torch.set_num_threads(4)

LIVE_STEPS = 5


@pytest.fixture(scope="module")
def record():
    with open(replay.FIXTURE) as f:
        return json.load(f)


def test_first_steps_replay_live_as_recorded(record):
    live = replay.replay(LIVE_STEPS, gap_every=LIVE_STEPS)
    for side in ("loss_jax", "loss_port"):
        np.testing.assert_allclose(live[side], record[side][:LIVE_STEPS],
                                   rtol=replay.LOSS_RTOL, err_msg=side)
    np.testing.assert_allclose(live["loss_port"], live["loss_jax"],
                               rtol=replay.LOSS_RTOL)
    gap, = live["leaf_gaps"]
    assert gap["step"] == LIVE_STEPS
    assert gap["max_abs"] <= replay.drift_bounds(LIVE_STEPS,
                                                 live["lr"])["param_abs"]
    assert replay.verdict(live)["held"]


def test_the_recorded_track_stays_within_float32_drift(record):
    assert record["recipe"] == "h_residual+virtual_node"
    assert (record["steps"], record["lr"], record["max_grad_norm"],
            record["neighbor_k"], record["optimizer"],
            record["compute_dtype"]) == (200, 2e-4, 1.0, 32,
                                         "RAdamScheduleFree", "float32")
    assert record["flags"] == replay.FLAGS
    for k in ("loss_jax", "loss_port", "grad_norm_jax", "param_l2_gap"):
        assert len(record[k]) == record["steps"]
        assert np.isfinite(record[k]).all(), k
    assert [r["step"] for r in record["leaf_gaps"]] == list(
        range(20, 201, 20))
    got = replay.verdict(record)
    assert got == {"params_within_drift": True, "loss_steps_off": [],
                   "held": True}
    assert record["verdict"] == got
    np.testing.assert_allclose(record["loss_port"], record["loss_jax"],
                               rtol=replay.LOSS_RTOL)
    bound = replay.drift_bounds(record["steps"], record["lr"])["param_abs"]
    assert record["eval_params_gap"]["max_abs"] <= bound
    # the loss fell: the replay trained
    assert np.mean(record["loss_jax"][-20:]) < np.mean(
        record["loss_jax"][:20])


def test_the_drift_check_catches_a_track_that_parts(record):
    parted = copy.deepcopy(record)
    parted["loss_port"][50] *= 1.01
    assert replay.verdict(parted)["loss_steps_off"] == [50]
    parted = copy.deepcopy(record)
    last = parted["leaf_gaps"][-1]
    last["max_abs"] = 1.01 * replay.drift_bounds(last["step"],
                                                 parted["lr"])["param_abs"]
    assert not replay.verdict(parted)["params_within_drift"]
    assert replay.drift_bounds(200, 2e-4)["param_abs"] == pytest.approx(
        200 * 2e-4 * 2 * 5e-3 * 0.1 / 0.001 ** 0.5)
