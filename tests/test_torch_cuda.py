"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA card; skipped elsewhere. This file imports no JAX, so it also
runs on a machine that has only PyTorch (the tests' conftest.py imports
JAX, hence ``--noconftest`` there):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.probes import (
    kernel_stages,
    matmul_rate,
    overlap,
    pipeline,
)
from torch_port_fixtures import (
    edge_args,
    edge_inputs,
    knn_args,
    knn_inputs,
    stage_args,
    stage_inputs,
)

torch.set_num_threads(4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a "
                    "and have no CPU mode")
    return torch.device("cuda", 0)


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,f1,fm", [(80, 16, 1024, 256),
                                       (1, 192, 1024, 256),
                                       (3, 24, 1024, 256),
                                       (2, 5, 320, 64)])
def test_kernel_matches_plain(cuda_device, dtype, b, n, f1, fm):
    inputs = edge_inputs(8, b=b, n=n, f1=f1, fm=fm,
                         n_real=[n - (g % 5) for g in range(b)])
    args = edge_args(inputs, cuda_device, dtype)
    before = egcl_pair.egcl_pair_launches
    got_m, got_x = egcl_pair.egcl_pair_edges(*args)
    torch.cuda.synchronize()
    assert egcl_pair.egcl_pair_launches == before + 1
    want_m, want_x = egcl_pair.egcl_pair_edges_reference(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got_m, want_m, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got_x, want_x, rtol=2e-4, atol=2e-5)
    else:
        assert _rel_l2(got_m, want_m) <= 1e-2
        assert _rel_l2(got_x - args[4], want_x - args[4]) <= 1e-2
    pad = args[5][..., 0] == 0
    assert torch.equal(got_m[pad], torch.zeros_like(got_m[pad]))
    assert torch.equal(got_x[pad], args[4][pad])
    if dtype == torch.bfloat16:
        assert int(egcl_pair.last_rows) == egcl_pair.edge_tiles(args[5]).rows


def _scatter_mask(inputs, seed):
    """Real atoms spread over the graph instead of forming a prefix."""
    rng = np.random.default_rng(seed)
    for g in range(inputs["mask"].shape[0]):
        inputs["mask"][g] = inputs["mask"][g][rng.permutation(
            inputs["mask"].shape[1])]
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_real", [(6, 16, (0, 1, 2, 16, 5, 0)),
                                        (3, 70, (70, 1, 33)),
                                        (2, 192, (192, 100))])
def test_bf16_kernel_computes_live_pairs_only(cuda_device, b, n, n_real):
    inputs = _scatter_mask(edge_inputs(15, b=b, n=n, f1=256, fm=128,
                                       n_real=n_real), 15)
    args = edge_args(inputs, cuda_device, torch.bfloat16)
    got_m, got_x = egcl_pair.egcl_pair_edges(*args)
    torch.cuda.synchronize()
    want_m, want_x = egcl_pair.egcl_pair_edges_reference(*args)
    assert _rel_l2(got_m, want_m) <= 1e-2
    assert _rel_l2(got_x - args[4], want_x - args[4]) <= 1e-2
    sched = egcl_pair.edge_tiles(args[5])
    assert int(egcl_pair.last_rows) == sched.rows
    assert sched.rows <= sched.live_edges + 63 * len(sched.blocks)
    lonely = args[5][..., 0] == 0
    assert torch.equal(got_m[lonely], torch.zeros_like(got_m[lonely]))
    assert torch.equal(got_x[lonely], args[4][lonely])


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    args = edge_args(edge_inputs(9, b=4, n=40, f1=1024, fm=256,
                                 n_real=(40, 33, 17, 2)),
                     cuda_device, torch.bfloat16)
    first = egcl_pair.egcl_pair_edges(*args)
    second = egcl_pair.egcl_pair_edges(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_grad_inputs_refused_on_the_card(cuda_device):
    args = list(edge_args(edge_inputs(10, f1=64, fm=64), cuda_device))
    args[8] = args[8].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        egcl_pair.egcl_pair_edges(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,k", [(80, 16, 15),    # served chunk, K = N-1
                                   (1, 2048, 32),   # large cell
                                   (3, 24, 7),
                                   (2, 40, 20),     # K does not divide 64
                                   (2, 90, 70)])    # K above one tile
def test_knn_kernel_matches_plain(cuda_device, dtype, b, n, k):
    inputs = knn_inputs(11, b=b, n=n, k=k, hdim=36, f1=1024, fm=256,
                        n_real=[n - 1 - (g % 5) for g in range(b)])
    args = knn_args(inputs, cuda_device, dtype)
    before = egcl_knn.egcl_knn_launches
    got_m, got_x = egcl_knn.egcl_knn_edges(*args)
    torch.cuda.synchronize()
    assert egcl_knn.egcl_knn_launches == before + 1
    want_m, want_x = egcl_knn.egcl_knn_edges_reference(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got_m, want_m, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got_x, want_x, rtol=2e-4, atol=2e-5)
    else:
        assert _rel_l2(got_m, want_m) <= 1e-2
        assert _rel_l2(got_x - args[3], want_x - args[3]) <= 1e-2
    pad = args[5].sum(dim=-1) == 0           # targets with no live slot
    assert bool(pad.any())
    assert torch.equal(got_m[pad], torch.zeros_like(got_m[pad]))
    assert torch.equal(got_x[pad], args[3][pad])
    if dtype == torch.bfloat16:
        assert int(egcl_knn.last_rows) == egcl_knn.edge_tiles(
            args[4], args[5]).rows


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,f1,fm", [(80, 16, 15, 1024, 256),
                                         (2, 90, 70, 320, 64),
                                         (3, 40, 33, 256, 192)])
def test_bf16_knn_kernel_computes_live_slots_only(cuda_device, b, n, k, f1,
                                                  fm):
    inputs = knn_inputs(16, b=b, n=n, k=k, hdim=36, f1=f1, fm=fm,
                        n_real=[n - 1 - (g % 7) for g in range(b)])
    rng = np.random.default_rng(16)
    for name in ("idx", "edge_mask"):       # live slots no longer a prefix
        inputs[name] = inputs[name][..., rng.permutation(k)].copy()
    inputs["edge_mask"][0, 1] = 0.0          # a real target with no slot
    args = knn_args(inputs, cuda_device, torch.bfloat16)
    got_m, got_x = egcl_knn.egcl_knn_edges(*args)
    torch.cuda.synchronize()
    want_m, want_x = egcl_knn.egcl_knn_edges_reference(*args)
    assert _rel_l2(got_m, want_m) <= 1e-2
    assert _rel_l2(got_x - args[3], want_x - args[3]) <= 1e-2
    sched = egcl_knn.edge_tiles(args[4], args[5])
    assert int(egcl_knn.last_rows) == sched.rows
    assert sched.rows <= sched.live_edges + 63 * len(sched.blocks)
    pad = args[5].sum(dim=-1) == 0
    assert torch.equal(got_m[pad], torch.zeros_like(got_m[pad]))
    assert torch.equal(got_x[pad], args[3][pad])


@pytest.mark.cuda
def test_knn_kernel_is_deterministic(cuda_device):
    args = knn_args(knn_inputs(12, b=3, n=64, k=32, hdim=36, f1=1024,
                               fm=256, n_real=(64, 40, 9)),
                    cuda_device, torch.bfloat16)
    first = egcl_knn.egcl_knn_edges(*args)
    second = egcl_knn.egcl_knn_edges(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_kernel_never_reads_outside_the_graph(cuda_device):
    inputs = knn_inputs(13, b=2, n=24, k=6, hdim=36, f1=256, fm=64,
                        n_real=(24, 24))
    args = list(knn_args(inputs, cuda_device))
    wild = args[4].clone()
    wild[:, :, -1] = 1 << 30                 # slot out of range, unmasked
    wild[0, 0, 0] = -5
    got = egcl_knn.egcl_knn_edges(*args[:4], wild, *args[5:])
    em = args[5].clone()
    em[:, :, -1] = 0.0
    em[0, 0, 0] = 0.0
    want = egcl_knn.egcl_knn_edges(*args[:5], em, *args[6:])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_grad_inputs_refused_on_the_card(cuda_device):
    args = list(knn_args(knn_inputs(14, f1=64, fm=64), cuda_device))
    args[6] = args[6].clone().requires_grad_(True)
    before = egcl_knn.egcl_knn_launches
    with pytest.raises(ValueError, match="requires grad"):
        egcl_knn.egcl_knn_edges(*args)
    assert egcl_knn.egcl_knn_launches == before


# --- the hardware probes (P1-P4) ---


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "warp"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,n,steps", [
    (128, 256, 3), (256, 512, 2), (512, 1024, 4), (128, 256, 0),
    (100, 512, 3),      # rows that do not fill the last chain of 64
    (200, 1024, 5),     # four chains: an odd half-cluster for "warp"
])
def test_chain_kernel_matches_plain(cuda_device, dtype, schedule, m, n,
                                    steps):
    a, w = matmul_rate.make_inputs(m, n, dtype, cuda_device, seed=m + n)
    before = matmul_rate.probe_matmul_rate_launches
    got = matmul_rate.chain(a, w, steps, schedule)
    torch.cuda.synchronize()
    assert matmul_rate.probe_matmul_rate_launches == before + 1
    want = matmul_rate.chain_reference(a, w, steps)
    if dtype == torch.int8 or steps == 0:
        assert torch.equal(got, want)
    else:
        assert _rel_l2(got.float(), want.float()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "warp"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,n,max_cluster", [
    (512, 1024, 16), (512, 1024, 8), (512, 512, 4),
    (128, 256, 16),                 # a narrow N: a smaller cluster
    (100, 512, 16), (4096, 1024, 16), (64, 256, 2),
])
def test_chain_kernel_uses_the_plan(cuda_device, dtype, schedule, m, n,
                                    max_cluster):
    a, w = matmul_rate.make_inputs(m, n, dtype, cuda_device, seed=1)
    want = matmul_rate.card_plan(m, n, dtype, schedule, max_cluster)
    got, used = matmul_rate._launch(a, w, 2, schedule, max_cluster)
    torch.cuda.synchronize()
    assert {k: used[k] for k in matmul_rate.PLAN_KEYS} == want
    assert used["chains"] * used["cs"] <= max_cluster
    assert used["active_clusters"] >= 1
    if n == 256:
        assert want["cs"] < matmul_rate.card_plan(m, 1024, dtype,
                                                  schedule)["cs"]
    ref = matmul_rate.chain_reference(a, w, 2)
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert _rel_l2(got.float(), ref.float()) <= 1e-2


@pytest.mark.cuda
def test_chain_refuses_a_cluster_the_plan_cannot_cut(cuda_device):
    a, w = matmul_rate.make_inputs(64, 1024, torch.bfloat16, cuda_device)
    before = matmul_rate.probe_matmul_rate_launches
    with pytest.raises(ValueError, match="no cluster"):
        matmul_rate.chain(a, w, 1, "warp", max_cluster=2)
    assert matmul_rate.probe_matmul_rate_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "warp"])
def test_chain_phases_add_up(cuda_device, schedule):
    a, w = matmul_rate.make_inputs(512, 1024, torch.int8, cuda_device)
    rec = matmul_rate.chain_phases(a, w, 8, schedule)
    per_link = rec["cycles_per_link"]
    assert all(v >= 0 for v in per_link.values())
    assert per_link["products"] > 0
    assert (per_link["ring_wait"] + per_link["x_wait"]
            + per_link["mma_wait"]) <= per_link["products"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,max_stages", [(512, 2), (512, 4), (4096, 2)])
def test_chain_with_a_capped_ring_matches_plain(cuda_device, dtype, m,
                                                max_stages):
    a, w = matmul_rate.make_inputs(m, 1024, dtype, cuda_device, seed=2)
    got, used = matmul_rate._launch(a, w, 3, "block",
                                    max_stages=max_stages)
    torch.cuda.synchronize()
    assert (used["stages"], used["resident"]) == (max_stages, 0)
    want = matmul_rate.chain_reference(a, w, 3)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        assert _rel_l2(got.float(), want.float()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "warp"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m", [512, 4096])
def test_the_clocked_kernel_computes_the_same_chain(cuda_device, dtype,
                                                    schedule, m):
    a, w = matmul_rate.make_inputs(m, 1024, dtype, cuda_device, seed=3)
    cycles = torch.zeros(len(matmul_rate.PHASES) + 1, dtype=torch.int64,
                         device=cuda_device)
    clocked, _ = matmul_rate._launch(a, w, 4, schedule, phases=cycles)
    plain = matmul_rate.chain(a, w, 4, schedule)
    torch.cuda.synchronize()
    assert torch.equal(clocked, plain)
    assert int(cycles[-1]) == 4 and int(cycles[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", overlap.MODES)
@pytest.mark.parametrize("m,n,steps", [(32, 256, 3), (64, 1024, 2),
                                       (48, 512, 3)])
def test_overlap_kernel_matches_plain(cuda_device, mode, m, n, steps):
    a, w, y = overlap.make_inputs(m, n, cuda_device, seed=n)
    before = overlap.probe_overlap_launches
    got_x, got_y = overlap.overlap(a, w, y, steps, mode)
    torch.cuda.synchronize()
    assert overlap.probe_overlap_launches == before + 1
    want_x, want_y = overlap.overlap_reference(a, w, y, steps, mode)
    assert torch.equal(got_x, want_x)
    torch.testing.assert_close(got_y, want_y, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,steps", [(512, 1024, 8), (100, 512, 3),
                                       (4224, 1024, 2)])
def test_overlap_mxu_is_the_int8_block_chain(cuda_device, m, n, steps):
    a, w, y = overlap.make_inputs(m, n, cuda_device, seed=m)
    got_x, got_y = overlap.overlap(a, w, y, steps, "mxu")
    want = matmul_rate.chain(a, w, steps, "block")
    torch.cuda.synchronize()
    assert torch.equal(got_x, want)
    assert torch.equal(got_y, y)
    both_x, _ = overlap.overlap(a, w, y, steps, "both")
    vpu_x, _ = overlap.overlap(a, w, y, steps, "vpu")
    torch.cuda.synchronize()
    assert torch.equal(both_x, want) and torch.equal(vpu_x, a)


@pytest.mark.cuda
@pytest.mark.parametrize("knn", [False, True])
def test_tiny_widths_take_the_plain_route_on_the_card(cuda_device, knn):
    torch.manual_seed(0)
    hdim = 60 if knn else 12                    # 60 > MAX_H on the kNN route
    fm = 64 if knn else 16
    layer = egnn.EGCL(hdim, 32 if not knn else 64, fm,
                      32 if not knn else 64, 32, hdim)
    layer.requires_grad_(False)
    g = torch.Generator().manual_seed(1)
    h = torch.randn(3, 10, hdim, generator=g)
    x = torch.randn(3, 10, 3, generator=g)
    mask = torch.ones(3, 10)
    mask[2, 6:] = 0
    edges = knn_edges(x, mask, 4) if knn else None
    want = layer(h, x, mask, edges)
    layer.to(cuda_device)
    card = [t.to(cuda_device) for t in (h, x, mask)]
    route = egnn.edge_route(layer.mlp_m_dense0.kernel.shape[1],
                            layer.mlp_x_dense0.kernel.shape[1], fm,
                            torch.float32, hdim if knn else None)
    assert route == "plain"
    before = (egnn.plain_edge_calls, egcl_pair.egcl_pair_launches,
              egcl_knn.egcl_knn_launches)
    got = layer(*card, knn_edges(card[1], card[2], 4) if knn else None)
    torch.cuda.synchronize()
    assert (egnn.plain_edge_calls, egcl_pair.egcl_pair_launches,
            egcl_knn.egcl_knn_launches) == (before[0] + 1, *before[1:])
    scale = max(float(w.abs().max()) for w in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", pipeline.SCHEDULES)
@pytest.mark.parametrize("rows,k,n", [(256, 128, 256), (384, 1024, 128),
                                      (128 * 140, 64, 128),
                                      (640, 192, 384)])   # N off a seq tile
def test_pipeline_kernel_matches_plain(cuda_device, schedule, rows, k, n):
    a, w = pipeline.make_inputs(rows, k, n, cuda_device, seed=rows)
    before = pipeline.probe_pipeline_launches
    got = pipeline.silu_product(a, w, schedule)
    torch.cuda.synchronize()
    assert pipeline.probe_pipeline_launches == before + 1
    want = pipeline.silu_product_reference(a, w)
    assert _rel_l2(got.float(), want.float()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", kernel_stages.MODES)
@pytest.mark.parametrize("n,f1,n_real", [(20, 256, 17), (64, 512, 64),
                                         (70, 256, 66)])
def test_stage_kernel_matches_plain(cuda_device, mode, n, f1, n_real):
    args = stage_args(stage_inputs(n, n, f1, 256, n_real), cuda_device)
    before = kernel_stages.probe_kernel_stages_launches
    got = kernel_stages.edge_stage(mode, *args)
    torch.cuda.synchronize()
    assert kernel_stages.probe_kernel_stages_launches == before + 1
    want = kernel_stages.edge_stage_reference(mode, *args)
    limit = 1e-5 if mode == "mm" else 1e-2
    for g, w in zip(got[:2], want[:2]):
        assert _rel_l2(g, w) <= limit
    if mode != "full_serial":
        assert torch.equal(got[2], want[2])      # the int32 products
    if mode != "mm":
        pad = args[5][0, :, 0] == 0
        assert not got[0][0, pad].any() and not got[1][0, pad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n,f1", [(20, 256), (65, 512)])
def test_x_branch_kernel_matches_plain(cuda_device, blocked, dtype, n, f1):
    q, w, wx3 = kernel_stages.make_x_inputs(dtype, cuda_device, n, f1)
    before = kernel_stages.probe_kernel_stages_launches
    if blocked:
        got = kernel_stages.x_branch_blocked(q, w, wx3)
        want = kernel_stages.x_branch_blocked_reference(q, w, wx3)
    else:
        got = kernel_stages.x_branch(q, w)
        want = kernel_stages.x_branch_reference(q, w)
    torch.cuda.synchronize()
    assert kernel_stages.probe_kernel_stages_launches == before + 1
    assert _rel_l2(got[0], want[0]) <= 1e-2
    if dtype == torch.int8:
        assert torch.equal(got[1], want[1])
    else:
        assert _rel_l2(got[1], want[1]) <= 1e-3


@pytest.mark.cuda
def test_probe_kernels_refuse_bad_shapes_on_the_card(cuda_device):
    a, w = matmul_rate.make_inputs(96, 128, torch.int8, cuda_device)
    before = matmul_rate.probe_matmul_rate_launches
    with pytest.raises(ValueError, match="multiples"):
        matmul_rate.chain(a, w, 1, "warp")
    assert matmul_rate.probe_matmul_rate_launches == before
