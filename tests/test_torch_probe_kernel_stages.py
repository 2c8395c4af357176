"""The kernel-stages probe's plain versions against the TPU probe, and the
kernel's wrappers.

Each plain version is held against ``benchmarks/probe_kernel_stages.py``
run in TPU interpret mode at B=1, N=16, F1=32, FM=16, TI=8 (two grid steps
of E=128 edge rows; ``make_call_xblk`` at ti=8, fb=16), with the last
three targets masked:

- ``make_call`` in its three stages: mm and mm_post within relative L2
  1e-5 (float32 group sums in another order over the same bf16 summands),
  full_serial within relative L2 1e-2 (its int8 rows round 32 silu(pre),
  where the two exp functions may part at a half);
- ``make_call_x`` and ``make_call_xblk``, int8 and bf16, within relative
  L2 1e-5;
- the int32 products under every stage, before the first bf16 rounding,
  bit for bit against the JAX package's own int32 dot.

The CUDA kernel is held against the plain versions on the card in
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_model_tpu_torch.probes import kernel_stages as ks
from torch_port_fixtures import (
    STAGE_NAMES,
    stage_args,
    stage_inputs,
    tpu_probe,
)

torch.set_num_threads(4)

N, F1, FM = 16, 32, 16
SIZES = dict(B=1, N=N, F1=F1, FM=FM, TI=8, NT=2, E=8 * N)
_BF16_ARGS = ("am_i", "am_j", "ax_i", "ax_j", "w_dm", "w_dx")


@pytest.fixture
def probe(monkeypatch):
    module = tpu_probe("probe_kernel_stages")
    for name, value in SIZES.items():
        monkeypatch.setattr(module, name, value)
    return module


def jax_args(inputs):
    return [jnp.asarray(inputs[k]).astype(jnp.bfloat16) if k in _BF16_ARGS
            else jnp.asarray(inputs[k]) for k in STAGE_NAMES]


def rel_l2(got, want):
    want = np.asarray(want, dtype=np.float32)
    return np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want)


@pytest.mark.parametrize("mode,limit", [("mm", 1e-5), ("mm_post", 1e-5),
                                        ("full_serial", 1e-2)])
def test_stage_matches_tpu_probe(probe, mode, limit):
    inputs = stage_inputs(0, N, F1, FM, n_real=N - 3)
    with pltpu.force_tpu_interpret_mode():
        want_m, want_x = probe.make_call(mode)(*jax_args(inputs))
    got_m, got_x, check = ks.edge_stage_reference(mode, *stage_args(inputs))
    assert got_m.shape == (1, N, FM) and got_x.shape == (1, N, 8)
    assert check.shape == (1, N) and check.dtype == torch.int32
    assert rel_l2(got_m.numpy(), want_m) <= limit
    assert rel_l2(got_x.numpy(), want_x) <= limit
    if mode != "mm":    # the masked targets get no message and no update
        assert not got_m[0, N - 3:].any() and not got_x[0, N - 3:].any()


def x_inputs(dtype, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, N * N, F1)).astype(np.float32)
    w = rng.normal(size=(F1, F1)).astype(np.float32)
    wx3 = (rng.normal(size=(F1, 1)) * 0.05).astype(np.float32)
    if dtype == "int8":
        q, w = (np.clip(v * 40, -127, 127).astype(np.int8) for v in (q, w))
        return (q, w, wx3), (torch.from_numpy(q), torch.from_numpy(w),
                             torch.from_numpy(wx3))
    tq, tw = (torch.from_numpy(v).to(torch.bfloat16) for v in (q, w))
    return ((jnp.asarray(q).astype(jnp.bfloat16),
             jnp.asarray(w).astype(jnp.bfloat16), wx3),
            (tq, tw, torch.from_numpy(wx3)))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_x_branch_matches_tpu_probe(probe, dtype, blocked):
    (q, w, wx3), (tq, tw, twx3) = x_inputs(dtype)
    jdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        if blocked:
            want = probe.make_call_xblk(jdt, ti=8, fb=16)(q, w, wx3)
        else:
            want = probe.make_call_x(jdt)(q, w)
    if blocked:
        got, check = ks.x_branch_blocked_reference(tq, tw, twx3)
    else:
        got, check = ks.x_branch_reference(tq, tw)
    assert got.shape == (1, N, 8)
    assert check.dtype == (torch.int32 if dtype == "int8" else torch.float32)
    assert rel_l2(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("mode", ks.MODES)
def test_int32_products_match_jax_bit_for_bit(mode):
    inputs = stage_inputs(2, N, F1, FM)
    args = dict(zip(STAGE_NAMES, stage_args(inputs)))
    if mode == "full_serial":
        _, d2, _ = ks._geometry(args["x"], args["mask"])
        qm = ks._build(args["am_i"], args["am_j"], args["w_dm"], d2)
        qm = qm.reshape(1, N * N, F1).numpy()
    else:
        qm = inputs["qm"]
    want = jax.lax.dot_general(
        jnp.asarray(qm), jnp.asarray(inputs["w2m_q"]),
        (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    got = ks._product(torch.from_numpy(qm), args["w2m_q"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_serial_rows_match_the_tpu_build():
    # the bf16 build of the int8 rows, op by op, against the same jnp ops
    inputs = stage_inputs(3, N, F1, FM)
    args = dict(zip(STAGE_NAMES, stage_args(inputs)))
    _, d2, _ = ks._geometry(args["x"], args["mask"])
    got = ks._build(args["am_i"], args["am_j"], args["w_dm"], d2).numpy()
    a_i, a_j, w_d = (jnp.asarray(inputs[k]).astype(jnp.bfloat16)
                     for k in ("am_i", "am_j", "w_dm"))
    pre = (a_i[:, :, None, :] + a_j[:, None, :, :]) + jnp.asarray(
        d2.numpy()).astype(jnp.bfloat16) * w_d
    f = pre.astype(jnp.float32)
    want = jnp.clip(jnp.round(f * jax.nn.sigmoid(f) * 32.0), -127, 127)
    mismatch = np.abs(got.astype(np.int32) - np.asarray(want, np.int32))
    assert mismatch.max() <= 1 and (mismatch > 0).mean() < 1e-3


def test_checksum_wraps_like_int32():
    big = torch.full((1, 2, 3, 4), 2**30, dtype=torch.int32)
    got = ks._checksum(big)
    want = (np.full(12, 2**30, np.int64).sum() + 2**31) % 2**32 - 2**31
    assert got.tolist() == [[int(want)] * 2]


def test_cpu_tensors_take_the_plain_versions_uncounted():
    inputs = stage_inputs(4, N, F1, FM)
    args = stage_args(inputs)
    (_, _, _), (tq, tw, twx3) = x_inputs("int8", 5)
    before = ks.probe_kernel_stages_launches
    calls = [(ks.edge_stage("mm_post", *args),
              ks.edge_stage_reference("mm_post", *args)),
             (ks.x_branch(tq, tw), ks.x_branch_reference(tq, tw)),
             (ks.x_branch_blocked(tq, tw, twx3),
              ks.x_branch_blocked_reference(tq, tw, twx3))]
    assert ks.probe_kernel_stages_launches == before
    for got, want in calls:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_other_devices_refused():
    q = torch.empty((1, 256 * 256, 256), dtype=torch.int8, device="meta")
    w = torch.empty((256, 256), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel-stages kernel"):
        ks.x_branch(q, w)


def test_unknown_stage_refused():
    with pytest.raises(ValueError, match="mode"):
        ks.edge_stage("mm_full", *stage_args(stage_inputs(0, N, F1, FM)))


def _valid_stage(**changes):
    args = dict(zip(STAGE_NAMES, stage_args(stage_inputs(6, 4, 256, 256))))
    for name, change in changes.items():
        args[name] = change(args[name])
    return args


def test_check_stage_accepts_kernel_layout():
    ks._check_stage(_valid_stage())


@pytest.mark.parametrize("changes,error", [
    ({"w2m_q": lambda t: t[:, :128].contiguous(),
      "wa": lambda t: t[:128].contiguous()}, ValueError),        # FM != 256
    ({"qm": lambda t: t.to(torch.int16)}, TypeError),
    ({"am_j": lambda t: t.float()}, TypeError),
    ({"x": lambda t: t[:, :, :2].contiguous()}, ValueError),
    ({"qx": lambda t: t[:, :8].contiguous()}, ValueError),
    ({"w2x_q": lambda t: t.t()}, ValueError),                    # strides
])
def test_check_stage_refuses_what_the_kernel_does_not_take(changes, error):
    with pytest.raises(error):
        ks._check_stage(_valid_stage(**changes))


@pytest.mark.parametrize("q,w,error", [
    (torch.zeros((1, 15, 256), dtype=torch.int8),
     torch.zeros((256, 256), dtype=torch.int8), ValueError),     # not N*N
    (torch.zeros((1, 16, 128), dtype=torch.int8),
     torch.zeros((128, 128), dtype=torch.int8), ValueError),     # F1 off 256
    (torch.zeros((1, 16, 256), dtype=torch.float16),
     torch.zeros((256, 256), dtype=torch.float16), TypeError),
    (torch.zeros((1, 16, 256), dtype=torch.int8),
     torch.zeros((256, 256), dtype=torch.bfloat16), TypeError),
])
def test_check_x_refuses_what_the_kernel_does_not_take(q, w, error):
    with pytest.raises(error):
        ks._check_x(q, w)


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ks.main([]) != 0


# --- the kernel's plan: tiles of flattened edge rows, the persistent grid ---

PLAN_SHAPES = [(1, 1), (1, 5), (1, 11), (2, 16), (1, 64), (1, 128),
               (3, 70), (1, 192), (2, 192), (1, 300)]


@pytest.mark.parametrize("b,n", PLAN_SHAPES)
@pytest.mark.parametrize("active", [1, 3, 66])
def test_persistent_grid_fits_the_card_and_the_tiles(b, n, active):
    # every edge row in a tile, no tile empty
    tiles = ks.tile_count(b, n)
    assert (tiles - 1) * ks.TILE_ROWS < b * n * n <= tiles * ks.TILE_ROWS
    # clusters of two, each walking tile pairs c, c + C, ...: no more
    # clusters than the card holds at once or than there are pairs, and
    # as many as both allow
    pairs = -(-tiles // ks.CLUSTER)
    blocks = ks.grid(b, n, active)
    assert blocks % ks.CLUSTER == 0
    assert blocks // ks.CLUSTER == min(active, pairs)


def test_grid_needs_a_cluster_the_card_holds():
    with pytest.raises(ValueError, match="clusters"):
        ks.grid(1, 192, 0)


def test_plan_at_the_probe_shape():
    assert ks.tile_count(1, 192) == 288
    assert ks.grid(1, 192, 66) == 132
    assert ks.grid(2, 192, 66) == 132
    assert ks.grid(1, 11, 66) == 2


def test_full_serial_refuses_rows_too_wide_for_shared_memory():
    args = _valid_stage()
    wide = dict(zip(STAGE_NAMES, stage_args(stage_inputs(6, 2, 1280, 256))))
    ks._check_stage(args, "full_serial")
    ks._check_stage(wide, "mm_post")
    with pytest.raises(ValueError, match="full_serial"):
        ks._check_stage(wide, "full_serial")


@pytest.mark.parametrize("mode", [*ks.MODES, "x8", "xbf"])
def test_library_call_is_the_product_alone(mode):
    inputs = dict(zip(STAGE_NAMES, stage_args(stage_inputs(7, 3, 256, 256))))
    if mode in ks.MODES:
        got = ks.library_call(mode, inputs)()
        want = [ks._product(inputs[q].reshape(-1, 256), inputs[w])
                for q, w in (("qm", "w2m_q"), ("qx", "w2x_q"))]
    else:
        q, w, _ = ks.make_x_inputs(ks.X_MODES[mode][1], "cpu", 3, 256)
        got = [ks.library_call(mode, {"q": q, "w": w})()]
        want = [ks._product(q.reshape(-1, 256), w)]
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g.float(), w, rtol=1e-2, atol=1e-1)
