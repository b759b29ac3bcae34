"""Tracing, profiling and timing utilities (port of
``dynmm_tpu/utils/profiling.py``).

* thop MAC counting         → ``utils/flops.py`` (``FlopCounterMode``)
* CUDA-event latency timing → ``test_time`` below (the reference's
  ``Supervised_Learning.py:350-371``)
* phase wall-clock timers   → ``PhaseTimer`` (train.py:377-381 semantics)
* ``trace``: a ``torch.profiler`` trace written as Chrome JSON
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


class PhaseTimer:
    """Accumulating named wall-clock phase timers (copy/forward/post/cm)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def as_logs(self, prefix: str = "time_") -> dict:
        return {prefix + k: v for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "dynmm_trace")):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and write its Chrome JSON trace to
    ``<log_dir>/trace_<pid>.json``. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def _synchronize(out) -> None:
    """Wait for the card to finish ``out`` (a tensor or a tuple or list
    holding one first); nothing for a CPU result."""
    while isinstance(out, (tuple, list)) and out:
        out = out[0]
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def test_time(
    apply_fn: Callable,
    loader,
    to_device_batch: Callable,
    repetitions: int = 10,
    scan_iters: int = 10,
) -> tuple[float, float]:
    """Inference latency over a full loader × ``repetitions`` (the
    reference's CUDA-event harness): the batches are moved to the device
    first, one warm-up pass runs over all of them, then each timed pass
    runs over all of them and ends in a device synchronisation. Returns
    (mean, std) seconds per pass. ``scan_iters`` is accepted for the JAX
    signature and unused, as there."""
    del scan_iters
    timings = np.zeros(repetitions)
    batches = [to_device_batch(b) for b in loader]
    out = None
    for b in batches:
        out = apply_fn(b)
    _synchronize(out)
    for rep in range(repetitions):
        t0 = time.perf_counter()
        for b in batches:
            out = apply_fn(b)
        _synchronize(out)
        timings[rep] = time.perf_counter() - t0
    return float(timings.mean()), float(timings.std())


test_time.__test__ = False  # a harness, not a pytest test
