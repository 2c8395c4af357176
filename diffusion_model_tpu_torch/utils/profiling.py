"""Profiling and tracing, as ``diffusion_model_tpu/utils/profiling.py``:

  * ``PhaseTimer``: wall-clock seconds per named phase, and a report dict
    (``api.train`` writes it to ``run_dir/profile.json``);
  * ``device_trace(log_dir)``: a ``torch.profiler`` trace of a block (the
    host's activity and, where a CUDA card is present, the card's kernels
    and copies), written into ``log_dir`` as a Chrome trace
    (``<worker>.<ms>.pt.trace.json``) that TensorBoard and Perfetto open;
  * ``annotate(name)``: a named region of the trace
    (``torch.profiler.record_function``).

The JAX package traces through ``jax.profiler``; the port's traces name the
card's kernels as CUDA does (the K1 edge kernel is
``egcl::edge_kernel<PairOp>``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall-clock time per named phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def report(self) -> dict:
        """name -> ``total_s`` (4 decimals), ``count``, ``mean_s`` (6)."""
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "mean_s": round(self.totals[name] / self.counts[name], 6)}
            for name in self.totals
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` and write the trace into
    ``log_dir``; yields the profiler (``key_averages()``, ``events()``).
    CUDA activity is traced where a card is present; the card is
    synchronised before the trace ends, so its kernels are in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def annotate(name: str):
    """A named region of a ``device_trace``."""
    import torch

    return torch.profiler.record_function(name)
