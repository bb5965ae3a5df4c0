"""Frame / pass timing (port of chord_tpu/utils/timer.py).

The reference's GPUTimestamps query-pool ring (source/graphics/query.cpp:
5-124, labeled per-pass GPU spans) and its Tracy zones
(source/utils/profiler.h). On the card a pass is timed by a pair of CUDA
events around the work the host queued inside the span; on the CPU by the
host clock. `PassTimers.scope` opens a torch.profiler `record_function`
span, so the pass shows by its label in profiler tables. Pass labels
match chord's timer label set, so profiles compare 1:1.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import record_function


class FrameTimer:
    """dt/FPS tracking on the host clock (reference: ApplicationTickData)."""

    def __init__(self) -> None:
        self._last: Optional[float] = None
        self.dt: float = 0.0
        self.frame_index: int = 0

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            self.dt = now - self._last
        self._last = now
        self.frame_index += 1
        return self.dt

    @property
    def fps(self) -> float:
        return 1.0 / self.dt if self.dt > 0 else 0.0


def _on_card(tensors) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors)


class PassTimers:
    """Labeled pass spans. `scope()` is a record_function span (shows in
    torch.profiler tables); `measure(label, *tensors)` records the span's
    ms: CUDA events when a given tensor lives on the card (the device
    time of the work queued inside the span), else the host clock."""

    def __init__(self) -> None:
        self.ms: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def scope(self, label: str) -> Iterator[None]:
        with record_function(label):
            yield

    @contextlib.contextmanager
    def measure(self, label: str, *sync_tensors) -> Iterator[None]:
        if _on_card(sync_tensors):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            self.ms[label] = start.elapsed_time(end)
            return
        t0 = time.perf_counter()
        yield
        self.ms[label] = (time.perf_counter() - t0) * 1e3

    def table(self) -> str:
        if not self.ms:
            return "(no timings)"
        width = max(len(k) for k in self.ms)
        lines = [f"{k:<{width}}  {v:8.3f} ms" for k, v in self.ms.items()]
        return "\n".join(lines)


def _sync(out) -> None:
    """Wait for the card when `out` holds a CUDA tensor (CPU ops are
    synchronous)."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    if _on_card(leaves):
        torch.cuda.synchronize()


def time_jitted(fn, *args, warmup: int = 2, iters: int = 10
                ) -> Dict[str, float]:
    """Benchmark a callable (chord_tpu's time_jitted): the wall time of
    each call up to its result, synchronised with torch.cuda.synchronize
    when the result lives on the card -> mean/min/max ms over iters."""
    for _ in range(warmup):
        _sync(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    return {
        "mean_ms": sum(samples) / len(samples),
        "min_ms": min(samples),
        "max_ms": max(samples),
    }
