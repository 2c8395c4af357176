"""The overlap probe's plain version against the TPU probe, and the kernel's
wrapper.

``overlap_reference`` is held against ``benchmarks/probe_overlap.py``'s
``make_call(mode)`` in TPU interpret mode at M=32, K=N=64, two links, in
all three modes: the int8 chain bit for bit, the float32 chain within rtol
1e-5. The CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_model_tpu_torch.probes import _common, overlap
from torch_port_fixtures import tpu_probe

torch.set_num_threads(4)

M, N, STEPS = 32, 64, 2


@pytest.fixture
def probe(monkeypatch):
    module = tpu_probe("probe_overlap")
    for name, value in dict(M=M, K=N, N=N, K_INNER=STEPS).items():
        monkeypatch.setattr(module, name, value)
    return module


def inputs(seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    a, w = (np.clip(rng.normal(size=s) * 20, -127, 127).astype(np.int8)
            for s in ((m, n), (n, n)))
    return a, w, rng.normal(size=(m, n)).astype(np.float32)


@pytest.mark.parametrize("mode", overlap.MODES)
def test_plain_matches_tpu_probe(probe, mode):
    a, w, y = inputs()
    with pltpu.force_tpu_interpret_mode():
        want_x, want_y = probe.make_call(mode)(a, w, y)
    got_x, got_y = overlap.overlap_reference(
        *(torch.from_numpy(v) for v in (a, w, y)), STEPS, mode)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    if mode == "vpu":
        np.testing.assert_array_equal(got_x.numpy(), a)
    if mode == "mxu":
        np.testing.assert_array_equal(got_y.numpy(), y)


def test_cpu_tensors_take_the_plain_version_uncounted():
    args = tuple(torch.from_numpy(v) for v in inputs(1))
    before = overlap.probe_overlap_launches
    got = overlap.overlap(*args, 3, "both")
    want = overlap.overlap_reference(*args, 3, "both")
    assert overlap.probe_overlap_launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_other_devices_refused():
    a = torch.empty((16, 256), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no overlap kernel"):
        overlap.overlap(a, a, a.float(), 1)


def _valid(m=32, n=256):
    return (torch.zeros((m, n), dtype=torch.int8),
            torch.zeros((n, n), dtype=torch.int8),
            torch.zeros((m, n), dtype=torch.float32))


@pytest.mark.parametrize("mode", overlap.MODES)
def test_check_accepts_kernel_layout(mode):
    overlap._check(*_valid(), 4, mode)


@pytest.mark.parametrize("args,mode,error", [
    (_valid(), "tensor", ValueError),                          # mode
    (_valid(n=768), "both", ValueError),                       # N not 2^k
    (_valid(m=0), "both", ValueError),                         # no rows
    ((_valid()[0], _valid()[1], _valid()[2].double()), "vpu", TypeError),
    ((_valid()[0].float(), _valid()[1], _valid()[2]), "mxu", TypeError),
    ((_valid()[0], _valid()[1][:128], _valid()[2]), "mxu", ValueError),
])
def test_check_refuses_what_the_kernel_does_not_take(args, mode, error):
    with pytest.raises(error):
        overlap._check(*args, 4, mode)


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert overlap.main() != 0


def test_sfu_bound_at_the_probe_shape():
    """2 MUFU a sigmoid, 4 sigmoids a link: 1.07e9 MUFU at M = 512, 0.26
    ms on 132 SMs at 1.98 GHz and twice that on the 64 SMs of the M = 512
    chain plan; at that clock the SFU, not the int8 products (0.139 ms),
    bounds mode "both"."""
    ops = overlap.sfu_ops(512)
    assert ops == 2 * 4 * 512 * 1024 * 256
    card = _common.bound(0, sfu=ops, sm_clock_hz=1.98e9,
                         int8=2 * 512 * 1024 * 1024 * 256)
    assert card["bound_kind"] == "sfu" and card["bound_by"] == "operations"
    assert card["bound_ms"] == pytest.approx(ops / (16 * 132 * 1.98e9) * 1e3)
    assert 0.25 < card["bound_ms"] < 0.27
    assert card["bound_ms_by"]["int8"] == pytest.approx(0.1389, rel=1e-3)
    plan = _common.bound(0, sfu=ops, sms=64, sm_clock_hz=1.98e9)
    assert plan["bound_ms"] == pytest.approx(card["bound_ms"] * 132 / 64)


@pytest.mark.parametrize("plan,sms", [
    (dict(chains=1, cs=8, blocks=64, active_clusters=15), 64),    # M=512
    (dict(chains=1, cs=4, blocks=264, active_clusters=30), 120),  # M=4224
    (dict(chains=1, cs=2, blocks=2, active_clusters=0), 0),
])
def test_held_sms_counts_the_blocks_the_card_holds_at_once(plan, sms):
    assert overlap.held_sms(plan) == sms
