"""The chained-product probe's plain version against the TPU probe, and the
kernel's wrapper.

``chain_reference`` is held against ``benchmarks/probe_matmul_rate.py``'s
``pallas_chain`` and ``pallas_chain_ilp``, run in TPU interpret mode at
M=32, K=N=64, two links: the int8 chain bit for bit, the bf16 chain within
relative L2 1e-2. The CUDA kernel is held against the plain version on the
card in ``test_torch_cuda.py``.
"""

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
    (lambda a, w: (a[:96], w), "warp", ValueError),     # M off 128 rows
    (lambda a, w: (a.t().contiguous().t(), w), "block", ValueError),
    (lambda a, w: (a[:16], w), "block", ValueError),    # M off 32 rows
])
def test_check_refuses_what_the_kernel_does_not_take(change, schedule, error):
    a, w = change(*_valid())
    with pytest.raises(error):
        matmul_rate._check(a, w, 4, schedule)


def test_check_refuses_negative_steps():
    with pytest.raises(ValueError, match="steps"):
        matmul_rate._check(*_valid(), -1, "block")


def test_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert matmul_rate.main() != 0
    assert "CUDA card" in capsys.readouterr().err
