"""Frame timing instrumentation.

Reference parity: ``lvk::Stopwatch`` (reference Timing/Stopwatch.cpp) — a
ring-buffer of frame times with average/deviation, GPU-synced when
profiling (`sync_gpu` = cv::ocl::finish(), Stopwatch.cpp:127-131) — wrapped
around every VideoFilter::apply (Filters/VideoFilter.cpp:46-58).

The JAX equivalent of "sync to measure": `jax.block_until_ready` on the step
output before stopping the clock.  In throughput mode the runtime does NOT
sync per frame (async dispatch pipelines host and device); the stopwatch
then measures wall-clock inter-frame latency instead, which is the honest
streaming number.
"""

from __future__ import annotations

import math
import time
from collections import deque


class Stopwatch:
    def __init__(self, history: int = 300):
        self._times = deque(maxlen=history)
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self._t0 = None
        return dt

    def tick(self):
        """Lap timing: record interval since the previous tick."""
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now

    @property
    def count(self) -> int:
        return len(self._times)

    def last(self) -> float:
        """Most recent recorded interval (seconds; 0 before any sample)."""
        return self._times[-1] if self._times else 0.0

    def average(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def deviation(self) -> float:
        if len(self._times) < 2:
            return 0.0
        mean = self.average()
        var = sum((t - mean) ** 2 for t in self._times) / (len(self._times) - 1)
        return math.sqrt(var)

    def average_ms(self) -> float:
        return self.average() * 1000.0

    def deviation_ms(self) -> float:
        return self.deviation() * 1000.0


def compile_timed(jitted, *args):
    """AOT-compile a jitted function for `args`: (compiled, seconds, XLA's
    memory analysis).  The compile is the set-up cost a first call hides."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0, compiled.memory_analysis()


class TickTimer:
    """Delta/tick-count timer with an optional fixed timestep.

    Reference parity: ``lvk::TickTimer`` (reference Timing/TickTimer.hpp:
    24-43) — `tick()` reports elapsed time since the last tick; the
    fixed-timestep overload `tick(timestep)` returns True only once the
    timestep has elapsed (used for fps-locked display rendering,
    VideoProcessor.cpp:205-211).
    """

    def __init__(self):
        self._last: float | None = None
        self._acc = 0.0
        self.tick_count = 0

    def tick(self, timestep: float | None = None) -> bool | float:
        now = time.perf_counter()
        delta = 0.0 if self._last is None else now - self._last
        self._last = now
        if timestep is None:
            self.tick_count += 1
            return delta
        self._acc += delta
        if self._acc >= timestep:
            self._acc = math.fmod(self._acc, timestep) if timestep > 0 else 0.0
            self.tick_count += 1
            return True
        return False

    def reset(self):
        self._last = None
        self._acc = 0.0
        self.tick_count = 0


# ---------------------------------------------------------------------------
# Hierarchical device tracing (reference ScopedProfiler / LVK_PROFILE,
# Modules/OBS-Plugin/Utility/ScopedProfiler.cpp:26-37: RAII scopes feeding a
# hierarchical profiler).  JAX equivalent: jax.profiler traces — scopes
# become named trace annotations nested inside a per-frame step annotation,
# viewable in TensorBoard/Perfetto alongside the XLA device timeline.
# ---------------------------------------------------------------------------

import contextlib


@contextlib.contextmanager
def trace_scope(name: str):
    """Named scope on the profiler timeline (LVK_PROFILE equivalent).
    No-op cost when no trace is active."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def frame_scope(step: int):
    """Per-frame step annotation: groups all scopes/device ops of one frame
    under a step marker (the unit the reference's profiler tree roots at)."""
    import jax

    with jax.profiler.StepTraceAnnotation("frame", step_num=step):
        yield


class DeviceTrace:
    """Start/stop wrapper over jax.profiler.trace for the CLI --trace flag:
    captures host annotations + the XLA device timeline into `logdir`
    (open with TensorBoard's profile plugin or Perfetto)."""

    def __init__(self, logdir: str | None):
        self.logdir = logdir
        self._active = False

    def __enter__(self):
        if self.logdir:
            import jax

            jax.profiler.start_trace(self.logdir)
            self._active = True
        return self

    def __exit__(self, *exc):
        if self._active:
            import jax

            jax.profiler.stop_trace()
            self._active = False
        return False
