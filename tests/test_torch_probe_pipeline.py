"""The pipelining probe's plain version against the TPU probe, and the
kernel's wrapper.

``silu_product_reference`` is held against ``benchmarks/probe_pipeline.py``'s
``make_seq`` and ``make_pipelined`` in TPU interpret mode at ROWS=96,
K=N=64 (TI=2 grid steps of 3 chunks of 16 rows), within relative L2 1e-2
(bf16 output; float32 sums in another order). The CUDA kernel is held
against the plain version on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_model_tpu_torch.probes import pipeline
from torch_port_fixtures import tpu_probe

torch.set_num_threads(4)

SIZES = dict(ROWS=96, K=64, N=64, TI=2, CHUNKS=3, ROWS_PER_STEP=48,
             ROWS_PER_CHUNK=16)


@pytest.fixture
def probe(monkeypatch):
    module = tpu_probe("probe_pipeline")
    for name, value in SIZES.items():
        monkeypatch.setattr(module, name, value)
    return module


def inputs(seed=0, rows=96, k=64, n=64):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32) * 0.5)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.3)
    return a.to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.parametrize("make", ["make_seq", "make_pipelined"])
def test_plain_matches_tpu_probe(probe, make):
    a, w = inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(probe, make)()(
            *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (a, w))).astype(jnp.float32))
    got = pipeline.silu_product_reference(a, w)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2


@pytest.mark.parametrize("schedule", pipeline.SCHEDULES)
def test_cpu_tensors_take_the_plain_version_uncounted(schedule):
    a, w = inputs(1)
    before = pipeline.probe_pipeline_launches
    got = pipeline.silu_product(a, w, schedule)
    assert pipeline.probe_pipeline_launches == before
    assert torch.equal(got, pipeline.silu_product_reference(a, w))


def test_other_devices_refused():
    a = torch.empty((128, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no pipeline kernel"):
        pipeline.silu_product(a, a.t())


def _valid(rows=256, k=128, n=256):
    return (torch.zeros((rows, k), dtype=torch.bfloat16),
            torch.zeros((k, n), dtype=torch.bfloat16))


@pytest.mark.parametrize("schedule", pipeline.SCHEDULES)
def test_check_accepts_kernel_layout(schedule):
    pipeline._check(*_valid(), schedule)


@pytest.mark.parametrize("args,schedule,error", [
    (_valid(), "staggered", ValueError),
    (_valid(rows=200), "seq", ValueError),                 # rows off 128
    (_valid(n=192), "pipelined", ValueError),              # N off 128
    (_valid(k=96), "seq", ValueError),                     # K off 64
    ((_valid()[0].float(), _valid()[1]), "seq", TypeError),
    ((_valid()[0], _valid()[1][:64]), "seq", ValueError),  # K mismatch
])
def test_check_refuses_what_the_kernel_does_not_take(args, schedule, error):
    with pytest.raises(error):
        pipeline._check(*args, schedule)


def test_main_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pipeline.main() != 0
