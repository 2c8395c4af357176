"""The replayed 1000-step chains (``tests/jax_replay_chains.py``) and the
JAX package's 250-step scores (``tests/jax_strided_scores.py``): the
committed fixtures' schema and provenance, and the verdicts ROADMAP.md
section 3 records for faults F7 and F4 held to the numbers they hold.

A fault is closed as no fault of the port when, from JAX's state with
JAX's draw, every reverse step and the epilogue of the port land on JAX's
next state to float32 rounding (``F32_STEP_RTOL`` of the state's largest
coordinate; over JAX's schedule table for a learned schedule, see
``forced``), the epilogue gives JAX's species for every structure, and the
port's whole chain on the card (K1, float32) from JAX's draws ends on
JAX's species for every structure; it is a fault of the port otherwise.
"""

import json

import pytest

from torch_port_fixtures import REPO

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
# a step's gap to JAX's next state, relative to the state's scale, that
# float32 rounding of two implementations of the same sums explains
F32_STEP_RTOL = 1e-4
REPLAYS = {
    "F7": dict(file="replay_q_predef_r5_2024.json",
               snapshot="artifacts/q_predef_r5.npz", key=2024,
               conditions="test split", structures=135,
               verdict="no fault of the port"),
    "F4": dict(file="replay_q_learned_r5_s2025_2025.json",
               snapshot="artifacts/q_learned_r5_s2025.npz", key=2025,
               conditions="cn2 test conditions", structures=25,
               verdict="no fault of the port"),
}


def load(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text())


def forced(fx: dict) -> dict:
    """The teacher-forced steps the verdict reads: over the JAX package's
    schedule table where the fixture has them (a learned table differs
    from JAX's by its gamma network's float32 rounding, which
    ``test_torch_gamma.py`` holds and flat stretches of the schedule
    amplify), else over the port's own."""
    return fx.get("forced_jax_table") or {
        "max_rel_gap_pos": fx["forced_max_rel_gap_pos"],
        "max_rel_gap_h": fx["forced_max_rel_gap_h"],
        "epilogue_species_equal": fx["forced_epilogue_species_equal"]}


def verdict(fx: dict) -> str:
    steps = forced(fx)
    agree = (steps["max_rel_gap_pos"] <= F32_STEP_RTOL
             and steps["max_rel_gap_h"] <= F32_STEP_RTOL
             and steps["epilogue_species_equal"] == fx["structures"]
             and fx["forced_epilogue_species_equal"] == fx["structures"]
             and fx["card"]["float32"]["species_equal_jax"]
             == fx["structures"])
    return "no fault of the port" if agree else "a fault of the port"


@pytest.mark.parametrize("fault", list(REPLAYS))
def test_replay_fixture_provenance(fault):
    want = REPLAYS[fault]
    fx = load(want["file"])
    assert fx["snapshot"] == want["snapshot"]
    assert fx["key"] == want["key"]
    assert fx["dtype"] == "float32" and fx["device"] == "CPU"
    assert fx["steps"] == 1000
    assert fx["conditions"] == want["conditions"]
    assert fx["script"].startswith(
        "JAX_PLATFORMS=cpu python tests/jax_replay_chains.py "
        + want["snapshot"])
    assert f"--seed {want['key']}" in fx["script"]
    assert fx["structures"] == want["structures"] == len(fx["per_structure"])


@pytest.mark.parametrize("fault", list(REPLAYS))
def test_replay_summary_counts_its_structures(fault):
    fx = load(REPLAYS[fault]["file"])
    rows = fx["per_structure"]
    for key in ("o_fraction_exact_jax", "o_fraction_exact_port",
                "species_equal", "forced_epilogue_species_equal"):
        assert fx[key] == sum(r[key] for r in rows), key
    assert fx["parted"] == sum(r["first_step_parted"] >= 0 for r in rows)
    for r in rows:
        gaps = r["max_gap"]
        assert set(gaps) == {"1", "10", "100", "1000", "final"}
        # a structure whose O fraction reads otherwise has other species
        if r["o_fraction_exact_jax"] != r["o_fraction_exact_port"]:
            assert not r["species_equal"]


@pytest.mark.parametrize("fault", list(REPLAYS))
def test_replay_verdict_holds(fault):
    fx = load(REPLAYS[fault]["file"])
    assert verdict(fx) == REPLAYS[fault]["verdict"]


@pytest.mark.parametrize("fault", list(REPLAYS))
def test_replay_on_the_card_is_recorded(fault):
    fx = load(REPLAYS[fault]["file"])
    card = fx["card"]
    assert card["device"].startswith("NVIDIA H100")
    assert card["device"].endswith(" W")
    assert card["script"] == fx["script"] + " --phase card"
    for dtype in ("bfloat16", "float32"):
        row = card[dtype]
        assert 0 <= row["species_equal_jax"] <= fx["structures"]
        assert 0 <= row["o_fraction_exact"] <= fx["structures"]
        assert row["max_final_gap"] >= 0.0


def test_replay_records_cn2_angles_on_both_sides():
    fx = load(REPLAYS["F4"]["file"])
    # a learned schedule's steps are also replayed over JAX's table
    assert fx["forced_jax_table"]["script"].endswith(
        "--phase forced --jax_table")
    assert 0.0 < fx["table_max_rel_diff"] < 1e-4
    rows = fx["per_structure"]
    assert all({"cn2_angle_jax", "cn2_angle_port",
                "cn2_angle_original"} <= set(r) for r in rows)
    assert fx["cn2_angles_valid_jax"] == sum(
        r["cn2_angle_jax"] is not None for r in rows)
    assert fx["cn2_angles_valid_port"] == sum(
        r["cn2_angle_port"] is not None for r in rows)


def test_strided_fixture_provenance():
    fx = load("jax_strided_250.json")
    assert fx["script"] == "JAX_PLATFORMS=cpu python tests/jax_strided_scores.py"
    assert fx["device"].startswith("CPU, float32")
    assert fx["sample_steps"] == 250 and fx["sample_grid"] == "uniform"
    runs = [(r["npz"], r["seed"]) for r in fx["rows"]]
    assert runs == [("artifacts/q_predef_r5.npz", 2024),
                    ("artifacts/q_predef_r5.npz", 0),
                    ("artifacts/q_learned_r5_s2025.npz", 2025),
                    ("artifacts/q_learned_r5_s2025.npz", 0)]
    for r in fx["rows"]:
        assert r["dtype"] == "float32" and r["sample_steps"] == 250
        assert r["conditions"] == 27 and r["samples"] == 135
        assert 0 < r["accepted"] <= r["samples"]
        assert 0.0 < r["rdf_cos_mean"] <= 1.0
        assert 0.0 <= r["atom_type_accuracy"] <= 1.0
