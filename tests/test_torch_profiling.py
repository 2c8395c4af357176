"""``utils.profiling`` against the JAX package's, on the CPU: the
``PhaseTimer`` report (its keys, counts and rounding, the clock replaced by
the same ticks in both), ``device_trace`` writing a Chrome trace that holds
an ``annotate`` region, and the phases ``api.train`` writes to
``profile.json`` counted as the JAX package's loop counts them."""

import json
import time

import numpy as np
import torch

from diffusion_model_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.utils.profiling import (
    PhaseTimer,
    annotate,
    device_trace,
)

torch.set_num_threads(4)


def timed_report(timer_cls, monkeypatch) -> dict:
    ticks = iter(np.cumsum([0.1234567, 1.0, 0.33333333, 2.5, 0.7, 1e-7,
                            0.25, 3.14159265]).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    timer = timer_cls()
    for name in ("train_epoch", "eval_epoch", "train_epoch", "checkpoint"):
        with timer.phase(name):
            pass
    return timer.report()


def test_phase_timer_reports_as_jax(monkeypatch):
    got = timed_report(PhaseTimer, monkeypatch)
    want = timed_report(JaxPhaseTimer, monkeypatch)
    assert got == want
    assert list(got) == ["train_epoch", "eval_epoch", "checkpoint"]
    assert got["train_epoch"]["count"] == 2


def test_device_trace_holds_the_annotated_region(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        with annotate("reverse_steps"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "reverse_steps" in names
    assert any(n and "mm" in n for n in names)


class NanEpoch:
    """``api.train``'s noise hook, the train noise of ``bad`` epochs NaN."""

    def __init__(self, cfg, bad):
        from diffusion_model_tpu_torch.train.loss import TrainNoise

        self.make = lambda epoch, phase: TrainNoise(
            (cfg.seed, epoch, int(phase == "eval")), "cpu")
        self.bad = bad

    def __call__(self, epoch, phase):
        noise = self.make(epoch, phase)
        if phase == "train" and epoch in self.bad:
            normal = noise.normal
            noise.normal = lambda stream, shape: normal(stream, shape) * \
                float("nan")
        return noise


def test_train_profile_counts_the_phases_as_jax(tmp_path):
    """Four epochs, the second not finite (rolled back), a checkpoint
    every second epoch. The JAX package's loop counts every epoch's
    ``train_epoch``, the kept epochs' ``eval_epoch``, and each periodic
    save (epoch 4; epoch 2 was rolled back) and the final one as
    ``checkpoint``: 4, 3, 2."""
    cfg = Config(n_max=8, L=1, m_hidden_size=16, h_hidden_size=16,
                 x_hidden_size=16, m_size=8, spectrum_size=16,
                 compressed_spectrum_size=8, compressor_hidden_dim=(8,),
                 num_diffusion_timestep=10, batch_size=4, optimizer="Adam",
                 lr=1e-3, checkpoint_every=2)
    data = synthetic_sio2_dataset(0, 12, 8, spectrum_size=16)
    api.train(cfg, data, str(tmp_path), num_epochs=4, device="cpu",
              noise=NanEpoch(cfg, {1}))
    with open(tmp_path / "profile.json") as f:
        report = json.load(f)
    assert {k: v["count"] for k, v in report.items()} == {
        "train_epoch": 4, "eval_epoch": 3, "checkpoint": 2}
    for row in report.values():
        assert sorted(row) == ["count", "mean_s", "total_s"]
        assert row["total_s"] >= 0
