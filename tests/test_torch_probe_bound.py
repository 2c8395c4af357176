"""The card's bound for a kernel's work (``probes._common.bound``): the
slowest of the bytes at the memory rate, the operations at each type's
peak and the MUFU operations at the SFU's rate, on fixed inputs."""

import pytest

from diffusion_model_tpu_torch.probes import _common


@pytest.mark.parametrize("kwargs,kind,ms", [
    (dict(moved=3.35e9), "bytes", 1.0),
    (dict(moved=0, bf16=989e9), "bf16", 1.0),
    (dict(moved=0, int8=1979e9, bf16=989e8), "int8", 1.0),
    (dict(moved=0, sfu=16 * 132 * 1e6, sm_clock_hz=1e9), "sfu", 1.0),
    (dict(moved=0, sfu=16 * 66 * 2e6, sms=66, sm_clock_hz=2e9), "sfu", 1.0),
    (dict(moved=6.7e9, sfu=16 * 132 * 1e6, sm_clock_hz=1e9), "bytes", 2.0),
    (dict(moved=0, f32=67e9, sfu=16 * 132 * 5e5, sm_clock_hz=1e9), "f32",
     1.0),
])
def test_bound_is_the_slowest_unit(kwargs, kind, ms):
    got = _common.bound(kwargs.pop("moved"), **kwargs)
    assert got["bound_kind"] == kind
    assert got["bound_by"] == ("bytes" if kind == "bytes" else "operations")
    assert got["bound_ms"] == pytest.approx(ms)
    assert got["bound_ms"] == max(got["bound_ms_by"].values())


def test_an_sfu_bound_needs_the_clock():
    with pytest.raises(ValueError, match="clock"):
        _common.bound(0, sfu=1)


def test_kernel_stage_sfu_counts():
    # P1 at the probe's shape: one tanh a SiLU of the epilogue, 10 MUFU a
    # row (gate in four lanes, norm, division), ex2 + reciprocal a value of
    # full_serial's two builds
    from diffusion_model_tpu_torch.probes import kernel_stages as ks

    e = 192 * 192
    assert ks.sfu_ops("mm") == ks.sfu_ops("x8") == ks.sfu_ops("xbf") == 0
    assert ks.sfu_ops("xblk8") == ks.sfu_ops("xblkbf") == e * 1024
    assert ks.sfu_ops("mm_post") == e * (256 + 1024) + 10 * e
    assert ks.sfu_ops("full_serial") == ks.sfu_ops("mm_post") + 4 * e * 1024
    assert ks.sfu_ops("mm_post", b=2, n=7, f1=256, fm=256) == \
        2 * 49 * (512 + 10)
    # at 1980 MHz full_serial's SFU time stays under its int8 operations'
    got = _common.bound(0, int8=ks.mxu_ops(), sfu=ks.sfu_ops("full_serial"),
                        sm_clock_hz=1.98e9)
    assert got["bound_kind"] == "int8"
    assert got["bound_ms_by"]["sfu"] == pytest.approx(
        ks.sfu_ops("full_serial") / (16 * 132 * 1.98e9) * 1e3)
