"""The chained-product probe's plain version against the TPU probe, and the
kernel's wrapper.

``chain_reference`` is held against ``benchmarks/probe_matmul_rate.py``'s
``pallas_chain`` and ``pallas_chain_ilp``, run in TPU interpret mode at
M=32, K=N=64, two links: the int8 chain bit for bit, the bf16 chain within
relative L2 1e-2. So is ``sliced_link``, a link computed as the kernel's
cluster computes it (column slices of the transposed w). ``chain_plan``,
the launch plan the kernel must agree with, is held to its invariants over
shapes, dtypes and schedules. The CUDA kernel is held against the plain
version on the card in ``test_torch_cuda.py``.
"""

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_model_tpu_torch.probes import matmul_rate
from torch_port_fixtures import tpu_probe

torch.set_num_threads(4)

M, N, STEPS = 32, 64, 2


@pytest.fixture
def probe(monkeypatch):
    module = tpu_probe("probe_matmul_rate")
    for name, value in dict(M=M, K=N, N=N, K_INNER=STEPS).items():
        monkeypatch.setattr(module, name, value)
    return module


def inputs(dtype, seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    a, w = rng.normal(size=(m, n)), rng.normal(size=(n, n))
    if dtype == "int8":
        return tuple(np.clip(v * 20, -127, 127).astype(np.int8)
                     for v in (a, w))
    return tuple(v.astype(np.float32) for v in (a, w))


def as_jax(v, dtype):
    return jnp.asarray(v) if dtype == "int8" else jnp.asarray(v).astype(
        jnp.bfloat16)


def as_torch(v, dtype):
    t = torch.from_numpy(v)
    return t if dtype == "int8" else t.to(torch.bfloat16)


@pytest.mark.parametrize("ilp", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_matches_tpu_probe(probe, dtype, ilp):
    a, w = inputs(dtype)
    jdt, acc = ((jnp.int8, jnp.int32) if dtype == "int8"
                else (jnp.bfloat16, jnp.float32))
    make = probe.pallas_chain_ilp if ilp else probe.pallas_chain
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(make(jdt, acc)(as_jax(a, dtype), as_jax(w, dtype))
                          .astype(jnp.float32))
    got = matmul_rate.chain_reference(as_torch(a, dtype), as_torch(w, dtype),
                                      STEPS).float().numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).mean() > 0.5     # the chain did not die out
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2


def test_int8_product_is_exact_at_the_bound():
    # every partial sum of 1024 products of +-127 stays below 2**24
    a = torch.full((32, 1024), -127, dtype=torch.int8)
    w = torch.full((1024, 256), 127, dtype=torch.int8)
    w[::2] = -127
    o = matmul_rate.product(a, w)
    assert o.dtype == torch.int32
    assert torch.equal(o, torch.zeros_like(o))
    o = matmul_rate.product(a, torch.full_like(w, 127))
    assert int(o[0, 0]) == -1024 * 127 * 127


def test_requant_is_an_arithmetic_shift_and_clip():
    o = torch.tensor([-1 << 20, -513, -512, -1, 0, 511, 512, 1 << 20],
                     dtype=torch.int32)
    got = matmul_rate.requant(o, torch.int8)
    assert got.tolist() == [-127, -2, -1, -1, 0, 0, 1, 127]


@pytest.mark.parametrize("schedule", ["block", "warp"])
def test_cpu_tensors_take_the_plain_version_uncounted(schedule):
    a, w = (as_torch(v, "int8") for v in inputs("int8", 1))
    before = matmul_rate.probe_matmul_rate_launches
    got = matmul_rate.chain(a, w, 3, schedule)
    assert matmul_rate.probe_matmul_rate_launches == before
    assert torch.equal(got, matmul_rate.chain_reference(a, w, 3))


def test_unknown_schedule_refused():
    a, w = (as_torch(v, "int8") for v in inputs("int8"))
    with pytest.raises(ValueError, match="schedule"):
        matmul_rate.chain(a, w, 1, "ilp4")


def test_other_devices_refused():
    a = torch.empty((256, 256), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no chain kernel"):
        matmul_rate.chain(a, a, 1)


def _valid(dtype=torch.int8, m=128, n=256):
    return (torch.zeros((m, n), dtype=dtype), torch.zeros((n, n), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["block", "warp"])
def test_check_accepts_kernel_layout(dtype, schedule):
    matmul_rate._check(*_valid(dtype), 4, schedule)


@pytest.mark.parametrize("change,schedule,error", [
    (lambda a, w: (a.float(), w.float()), "block", TypeError),
    (lambda a, w: (a, w.to(torch.bfloat16)), "block", TypeError),
    (lambda a, w: (a[:, :128].contiguous(), w), "block", ValueError),
    (lambda a, w: (a[:0], w), "warp", ValueError),      # no rows
    (lambda a, w: (a.t().contiguous().t(), w), "block", ValueError),
    (lambda a, w: (a.new_zeros((128, 384)), w.new_zeros((384, 384))),
     "block", ValueError),                              # N off 256 columns
])
def test_check_refuses_what_the_kernel_does_not_take(change, schedule, error):
    a, w = change(*_valid())
    with pytest.raises(error):
        matmul_rate._check(a, w, 4, schedule)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("schedule", ["block", "warp"])
@pytest.mark.parametrize("m", [1, 96, 100])
def test_check_accepts_any_row_count(dtype, schedule, m):
    # rows are padded to chains of 64 inside the kernel
    matmul_rate._check(*_valid(dtype, m=m), 2, schedule)


def test_check_refuses_negative_steps():
    with pytest.raises(ValueError, match="steps"):
        matmul_rate._check(*_valid(), -1, "block")


# --- a link cut into column slices, as the cluster computes it ---


@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("ilp", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_sliced_links_match_tpu_probe(probe, dtype, ilp, cs):
    a, w = inputs(dtype, seed=3)
    jdt, acc = ((jnp.int8, jnp.int32) if dtype == "int8"
                else (jnp.bfloat16, jnp.float32))
    make = probe.pallas_chain_ilp if ilp else probe.pallas_chain
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(make(jdt, acc)(as_jax(a, dtype), as_jax(w, dtype))
                          .astype(jnp.float32))
    x, wt = as_torch(a, dtype), as_torch(w, dtype)
    for _ in range(STEPS):
        x = matmul_rate.sliced_link(x, wt, cs)
    got = x.float().numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2


@pytest.mark.parametrize("cs", [2, 8, 16])
def test_sliced_link_is_the_plain_link_bit_for_bit(cs):
    a, w = (as_torch(v, "int8") for v in inputs("int8", 5, m=48, n=256))
    want = matmul_rate.chain_reference(a, w, 1)
    assert torch.equal(matmul_rate.sliced_link(a, w, cs), want)


# --- the launch plan ---

DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}

# Clusters an H100 SXM (132 SMs) holds at once where a block's shared memory
# leaves one block an SM, as every shape at N = 1024 does: the card's answers
# (cudaOccupancyMaxActiveClusters), which the probe's main() prints as
# ``clusters_held_at_once``. Fewer than 132 // cluster: a cluster lies within one
# GPC, and not every GPC has all its SMs.
H100_HELD = {4: 30, 8: 15, 16: 7}


def h100_active(cluster, ns, smem):
    assert smem > 232448 // 2                    # one block an SM
    return H100_HELD[cluster]



@hypothesis.settings(max_examples=200, deadline=None, database=None)
@hypothesis.given(m=st.integers(1, 20000), n=st.sampled_from(
    [256, 512, 768, 1024, 1280, 1536, 2048]), dtype=st.sampled_from(
        sorted(DTYPES)), schedule=st.sampled_from(["block", "warp"]),
    max_cluster=st.sampled_from([1, 2, 4, 8, 16]),
    max_stages=st.sampled_from([2, 3, 4, 8, 32]), held=st.integers(0, 132))
def test_plan_invariants(m, n, dtype, schedule, max_cluster, max_stages,
                         held):
    # whatever the card answers (``held`` clusters of 16 blocks, in
    # proportion for smaller ones)
    eb = 1 if dtype == "int8" else 2
    try:
        plan = matmul_rate.chain_plan(
            m, n, DTYPES[dtype], schedule, max_cluster, max_stages,
            active=lambda cluster, ns, smem: held * 16 // cluster)
    except ValueError:
        # nothing fits: every slice width the kernel has is too wide for
        # the cluster, or x alone is too large
        chains = matmul_rate.SCHEDULES[schedule]
        for cs in (1, 2, 4, 8, 16):
            ns = n // cs
            fits = (n % cs == 0 and ns in (64, 128, 256)
                    and ns * eb % 128 == 0 and chains * cs <= max_cluster
                    and matmul_rate._block_memory(n, eb, ns, max_stages)
                    is not None)
            assert not fits
        return
    cluster = plan["chains"] * plan["cs"]
    assert plan["smem"] <= 232448
    assert plan["cs"] * plan["ns"] == n          # slices cover N once
    assert cluster in (1, 2, 4, 8, 16) and cluster <= max_cluster
    assert plan["chains"] == matmul_rate.SCHEDULES[schedule]
    assert plan["row_groups"] * 64 >= m > (plan["row_groups"] - 1) * 64
    clusters = -(-plan["row_groups"] // plan["chains"])
    assert plan["blocks"] == clusters * cluster
    assert plan["ns"] * eb % 128 == 0            # whole K-blocks of x
    stage = plan["ns"] * 128
    per_link = n * eb // 128
    assert min(3, max_stages, per_link) <= plan["stages"] <= max_stages
    assert plan["resident"] == int(plan["stages"] == per_link)
    assert plan["smem"] == 2048 + 64 * n * eb + plan["stages"] * stage


@pytest.mark.parametrize("dtype,schedule,m,want", [
    # few chains: as wide as the card holds all clusters at once (8 chains
    # are more than the 7 clusters of 16 blocks it holds)
    ("bf16", "block", 512, dict(cs=8, ns=128, stages=6, resident=0,
                                blocks=64)),
    ("bf16", "warp", 512, dict(cs=8, ns=128, chains=2, stages=6, blocks=64)),
    ("int8", "block", 512, dict(cs=8, ns=128, stages=8, resident=1,
                                blocks=64)),
    ("int8", "warp", 512, dict(cs=8, ns=128, chains=2, resident=1,
                               blocks=64)),
    # many chains: the narrowest cluster
    ("bf16", "block", 16896, dict(cs=4, ns=256, stages=3, blocks=1056)),
    ("bf16", "warp", 16896, dict(cs=4, ns=256, stages=3, blocks=1056)),
    ("int8", "block", 16896, dict(cs=4, ns=256, stages=5, blocks=1056)),
    ("int8", "warp", 16896, dict(cs=4, ns=256, stages=5, blocks=1056)),
])
def test_plan_at_the_probe_shapes(dtype, schedule, m, want):
    plan = matmul_rate.chain_plan(m, 1024, DTYPES[dtype], schedule,
                                  active=h100_active)
    assert {k: plan[k] for k in want} == want


def test_plan_follows_the_cards_answer():
    # 7 chains fit the 7 clusters of 16 blocks the card holds; 8 do not
    plan = matmul_rate.chain_plan(448, 1024, torch.bfloat16, "block",
                                  active=h100_active)
    assert (plan["cs"], plan["ns"], plan["blocks"]) == (16, 64, 112)
    plan = matmul_rate.chain_plan(449, 1024, torch.bfloat16, "block",
                                  active=h100_active)
    assert (plan["cs"], plan["ns"], plan["blocks"]) == (8, 128, 64)
    # a card that held nothing at once would get the narrowest cluster
    plan = matmul_rate.chain_plan(64, 1024, torch.bfloat16, "block",
                                  active=lambda *shape: 0)
    assert (plan["cs"], plan["ns"]) == (4, 256)


def test_plan_has_no_default_for_what_only_the_card_knows():
    with pytest.raises(TypeError, match="active"):
        matmul_rate.chain_plan(512, 1024, torch.bfloat16, "block")


def test_plan_picks_a_smaller_cluster_for_a_narrow_n():
    def active(cluster, ns, smem):
        return 132 // cluster
    wide = matmul_rate.chain_plan(128, 1024, torch.int8, "block",
                                  active=active)
    narrow = matmul_rate.chain_plan(128, 256, torch.int8, "block",
                                    active=active)
    assert (wide["cs"], narrow["cs"]) == (8, 2)


def test_plan_refuses_what_no_cluster_carries():
    with pytest.raises(ValueError, match="no cluster"):
        matmul_rate.chain_plan(64, 1024, torch.bfloat16, "block",
                               max_cluster=2, active=h100_active)
    with pytest.raises(ValueError, match="multiples of 256"):
        matmul_rate.chain_plan(64, 320, torch.int8, "block",
                               active=h100_active)
    with pytest.raises(ValueError, match="schedule"):
        matmul_rate.chain_plan(64, 256, torch.int8, "ilp4",
                               active=h100_active)


@pytest.mark.parametrize("dtype,m,max_stages,want", [
    # a capped ring: bf16 streams through fewer stages, int8 no longer
    # keeps its slice of w (8 stages) and streams it
    ("bf16", 512, 2, dict(cs=8, ns=128, stages=2, resident=0)),
    ("bf16", 512, 4, dict(cs=8, ns=128, stages=4, resident=0)),
    ("bf16", 512, 8, dict(cs=8, ns=128, stages=6, resident=0)),
    ("int8", 512, 4, dict(cs=8, ns=128, stages=4, resident=0)),
    ("int8", 512, 8, dict(cs=8, ns=128, stages=8, resident=1)),
    ("bf16", 16896, 2, dict(cs=4, ns=256, stages=2, resident=0)),
])
def test_plan_with_a_capped_ring(dtype, m, max_stages, want):
    plan = matmul_rate.chain_plan(m, 1024, DTYPES[dtype], "block",
                                  max_stages=max_stages, active=h100_active)
    assert {k: plan[k] for k in want} == want
    assert plan["smem"] == (2048 + 64 * 1024 * (1 if dtype == "int8" else 2)
                            + plan["stages"] * plan["ns"] * 128)


@pytest.mark.parametrize("max_stages", [0, 1, 33])
def test_plan_refuses_a_ring_the_kernel_cannot_run(max_stages):
    # one stage cannot hold the products in flight and the next load
    with pytest.raises(ValueError, match="max_stages"):
        matmul_rate.chain_plan(512, 1024, torch.int8, "block",
                               max_stages=max_stages, active=h100_active)


def test_timing_lives_in_an_instantiation_of_its_own():
    # the kernel that chain launches reads no clock: every reading hangs on
    # the template parameter, and the launch picks by the phases pointer
    from diffusion_model_tpu_torch.ops import _build
    source = (_build.CSRC / matmul_rate._SOURCE).read_text()
    assert "template <typename T, int NS, bool Timed>" in source
    assert source.count("Timed && p.phases != nullptr") == 1
    kernel = source[source.index("chain_kernel(const __grid_constant__"):
                    source.index("void configure(")]
    reads = [line for line in kernel.splitlines() if "clock64()" in line]
    assert reads and all("timed" in line for line in reads)
    assert "#ifndef CHAIN_" not in source        # one build, no switches


def test_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert matmul_rate.main() != 0
    assert "CUDA card" in capsys.readouterr().err
