"""Profiling instrumentation (counterpart of mingunivision_tpu/utils/profiling.py):
named ranges for `torch.profiler` traces, a host-side step timer with
summary statistics, and a synchronising scalar read.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(name: str):
    """A named range in `torch.profiler` traces (`record_function`)."""
    with torch.profiler.record_function(name):
        yield


def force_sync(out) -> float:
    """Wait for `out`'s computation and return a scalar that depends on every
    element: the float sum of every tensor in `out` (a tensor, or a dict, list
    or tuple of them), read on the host after `torch.cuda.synchronize()` when
    one lies on the card."""
    tensors = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(out)
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return float(sum(float(t.detach().float().sum()) for t in tensors))


class StepTimer:
    """Wall-clock step timers with summary statistics (host clock)."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        """Time the block; with `block_on`, wait for it (`force_sync`) before the clock stops."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            force_sync(block_on)
        self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.records.items():
            xs_sorted = sorted(xs)
            n = len(xs)
            out[name] = {"n": n, "mean_ms": 1e3 * sum(xs) / n, "p50_ms": 1e3 * xs_sorted[n // 2],
                         "min_ms": 1e3 * xs_sorted[0], "max_ms": 1e3 * xs_sorted[-1]}
        return out
