"""Tracing / frame statistics.

The reference's observability is the sokol-gfx introspection UI + frame
timing (`SOKOL_TRACE_HOOKS`, `sapp_frame_duration`, debug groups labelling
GPU passes — SURVEY.md §5). Equivalents here:

- `pass_scope(name)`: `jax.named_scope` labels that show up in XLA/profiler
  traces exactly like the reference's `sg_push_debug_group` pass labels.
- `FrameStats`: rolling frame-time statistics (the sgimgui stats window).
- `trace(logdir)`: wraps `jax.profiler.trace` for full device profiles.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import jax


def pass_scope(name: str):
    """Label a render/sim pass in profiler traces (sg_push_debug_group
    analog, main.cpp:2014/2055/2192)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile viewable in TensorBoard/xprof."""
    with jax.profiler.trace(logdir):
        yield


class FrameStats:
    """Rolling frame timing + counters (the sokol-gfx stats window analog)."""

    def __init__(self, window: int = 120):
        self.times = deque(maxlen=window)
        self.counters: dict[str, float] = {}
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def frame_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1000.0 * sum(self.times) / len(self.times)

    def summary(self) -> dict:
        return {"fps": round(self.fps, 2),
                "frame_ms": round(self.frame_ms, 3),
                **self.counters}
