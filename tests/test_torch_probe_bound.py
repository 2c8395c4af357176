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
