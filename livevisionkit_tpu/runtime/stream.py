"""Streaming pipeline: decode -> device step -> encode, fully overlapped.

Reference parity: ``VideoFilter::stream`` (reference Filters/VideoFilter
.cpp:62-209) — a 3-thread pipeline (reader / filter / output threads, two
15-deep bounded queues with condvar backpressure, early-termination
draining) — and the CLI driver ``VideoProcessor::run`` (reference
Modules/VideoEditor/VideoProcessor.cpp:148-230).

Design: the thread pipeline maps onto JAX's ASYNC DISPATCH.

  * a reader thread keeps a bounded queue of decoded host frames
    (the reference's 15-frame input queue);
  * the main loop uploads (`device_put`), repacks on device (uint8 HWC ->
    planar float, one tiny jitted op = FrameIngest's GPU half), and calls
    the jitted step WITHOUT syncing — dispatch returns immediately and the
    device pipelines ahead;
  * completed outputs are drained with a small in-flight window (depth 3):
    the `np.asarray` on an output from K steps ago blocks only if the
    device is K frames behind, which is exactly condvar backpressure;
  * a writer thread encodes drained frames (the reference's output thread).

The per-frame state carry is donated, so the delay queue mutates in place.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu.types import PixelFormat
from livevisionkit_tpu.utils.profiling import (
    Stopwatch,
    compile_timed,
    frame_scope,
    trace_scope,
)


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    frame_time: Stopwatch = field(default_factory=Stopwatch)
    # Per-filter GPU-synced timings, only in profile mode
    # (reference VideoProcessor -v, VideoProcessor.cpp:291-356).
    filter_times: dict = field(default_factory=dict)
    # Per-output submit→drain latency samples (seconds): the time from the
    # frame's dispatch to its pixels being host-resident, i.e. the live-mode
    # pipeline latency INCLUDING the deliberate in-flight window.  The
    # stabilizer's algorithmic delay (predictive_samples frames of delay
    # queue) is a separate, deterministic content delay — not included.
    latencies: list = field(default_factory=list)
    # Set-up cost of the fused step (trace + compile, or a persistent-cache
    # load) and XLA's memory analysis of it; unset in profile mode.
    compile_seconds: float | None = None
    step_memory: object = None

    @property
    def fps(self) -> float:
        avg = self.frame_time.average()
        return 1.0 / avg if avg > 0 else 0.0

    def latency_quantiles(self) -> dict:
        """p50/p95/p99 frame latency in ms (empty dict when no samples)."""
        if not self.latencies:
            return {}
        arr = np.sort(np.asarray(self.latencies)) * 1e3
        q = lambda p: float(arr[min(len(arr) - 1, int(p * len(arr)))])  # noqa: E731
        return {"p50_ms": q(0.50), "p95_ms": q(0.95), "p99_ms": q(0.99)}


@jax.jit
def _ingest(bgr_hwc_uint8: jax.Array) -> jax.Array:
    """On-device repack: HWC uint8 BGR -> (3, H, W) float32 [0, 1]."""
    x = bgr_hwc_uint8.astype(jnp.float32) * (1.0 / 255.0)
    return x.transpose(2, 0, 1)


def stream(
    filt: VideoFilter,
    reader,
    on_output: Callable[[np.ndarray, float], None] | None = None,
    work_format: PixelFormat = PixelFormat.YUV,
    queue_depth: int = 15,
    inflight: int = 3,
    max_frames: int | None = None,
    stop_event: threading.Event | None = None,
    profile_filters: bool = False,
    hud_budget_ms: float | None = None,
) -> StreamStats:
    """Run `filt` over `reader` (yields (bgr_hwc_uint8, timestamp)).

    on_output receives (planar_float_bgr (3,H,W), timestamp) for every VALID
    output frame, in order.  Conversion into/out of `work_format` happens on
    device around the filter, mirroring the reference's YUV inter-filter
    convention (Filters/VideoFilter.hpp:31).

    hud_budget_ms enables the reference's test-mode frame-time HUD
    (VSFilter.cpp:368-383): the host-measured frame time is stamped onto
    every output, green within budget / red over (runtime/hud.py).
    """
    stats = StreamStats()
    stop_event = stop_event or threading.Event()

    in_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    reader_exc: list[BaseException] = []

    def _put_with_stop(item) -> bool:
        """Bounded put that aborts when the pipeline stops (r3 VERDICT #9:
        a plain blocking put stranded the reader on a full queue after an
        abort)."""
        while not stop_event.is_set():
            try:
                in_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def read_loop():
        n = 0
        try:
            for frame, ts in reader:
                if stop_event.is_set():
                    break
                if not _put_with_stop((frame, ts)):
                    return
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        except BaseException as e:  # surface decode errors like encode ones
            reader_exc.append(e)
            stop_event.set()
        _put_with_stop(None)  # EOF

    reader_thread = threading.Thread(target=read_loop, daemon=True)
    reader_thread.start()

    out_q: queue.Queue = queue.Queue(maxsize=queue_depth)
    writer_exc: list[BaseException] = []

    def write_loop():
        while True:
            item = out_q.get()
            if item is None:
                return
            try:
                if on_output is not None:
                    on_output(*item)
            except BaseException as e:  # surface encode errors to caller
                writer_exc.append(e)
                stop_event.set()
                return

    writer_thread = threading.Thread(target=write_loop, daemon=True)
    writer_thread.start()

    bgr = PixelFormat.BGR

    # Profile mode: one jit per chain element + a sync after each, so
    # per-filter times are observable (the reference's sync-to-measure
    # pattern, Stopwatch.cpp:127-131). Costs pipelining; default mode runs
    # the whole chain as ONE fused program.
    from livevisionkit_tpu.filters.base import CompositeFilter

    sub_filters = (
        list(filt.filters)
        if profile_filters and isinstance(filt, CompositeFilter)
        else None
    )
    if sub_filters is not None:
        sub_steps = [jax.jit(f.step) for f in sub_filters]
        sub_keys = [f"{i}:{f.name}" for i, f in enumerate(sub_filters)]
        for k in sub_keys:
            stats.filter_times[k] = Stopwatch()

        def prep(raw, ts):
            frame = Frame.create(_ingest(raw), timestamp=ts, fmt=bgr)
            return frame.reformat(work_format)

        prep_j = jax.jit(prep)
        finish_j = jax.jit(lambda fr: fr.reformat(bgr))

    def full_step(state, raw, ts):
        frame = Frame.create(_ingest(raw), timestamp=ts, fmt=bgr)
        frame = frame.reformat(work_format)
        state, out = filt.step(state, frame)
        out = out.reformat(bgr)
        return state, (out.pixels, out.timestamp, out.valid)

    step = jax.jit(full_step, donate_argnums=0)

    state = None
    pending: deque = deque()  # ((pixels_dev, ts_dev, valid_dev), t_submit)

    def drain(block_all: bool):
        while pending and (block_all or len(pending) > inflight):
            (px, ts, valid), t_sub = pending.popleft()
            if bool(valid):  # device sync happens here (backpressure)
                out_np = np.asarray(px)
                stats.latencies.append(time.perf_counter() - t_sub)
                if hud_budget_ms is not None:
                    from livevisionkit_tpu.runtime.hud import (
                        draw_frame_time_hud,
                    )

                    out_np = draw_frame_time_hud(
                        np.array(out_np), stats.frame_time.last() * 1e3,
                        hud_budget_ms,
                    )
                stats.frames_out += 1
                # Stop-aware put: a dead writer leaves the queue full and a
                # blocking put would hang the pipeline on abort.
                while not stop_event.is_set():
                    try:
                        out_q.put((out_np, float(ts)), timeout=0.1)
                        break
                    except queue.Full:
                        continue

    try:
        while not stop_event.is_set():
            # Poll, don't block: after an abort the reader stops feeding
            # without an EOF sentinel (its puts bail on stop_event), so a
            # blocking get would hang here forever.
            try:
                item = in_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            raw_np, ts = item
            if state is None:
                spec = FrameSpec(
                    height=raw_np.shape[0],
                    width=raw_np.shape[1],
                    channels=work_format.channels,
                    format=work_format,
                )
                state = filt.init(spec)
            stats.frame_time.tick()
            # frame_scope/trace_scope: hierarchical profiler annotations
            # (reference LVK_PROFILE, ScopedProfiler.cpp:26-37) — no-ops
            # unless a jax.profiler trace is active (CLI --trace).
            with frame_scope(stats.frames_in):
                raw_dev = jax.device_put(jnp.asarray(raw_np))
                if sub_filters is not None:
                    frame = prep_j(raw_dev, jnp.float32(ts))
                    new_states = []
                    for k, fstep, sub_state in zip(sub_keys, sub_steps, state):
                        watch = stats.filter_times[k]
                        watch.start()
                        with trace_scope(k):
                            sub_state, frame = fstep(sub_state, frame)
                            jax.block_until_ready(frame.pixels)
                        watch.stop()
                        new_states.append(sub_state)
                    state = tuple(new_states)
                    outf = finish_j(frame)
                    out = (outf.pixels, outf.timestamp, outf.valid)
                else:
                    ts_dev = jnp.float32(ts)
                    if stats.compile_seconds is None:
                        step, stats.compile_seconds, stats.step_memory = (
                            compile_timed(step, state, raw_dev, ts_dev)
                        )
                    state, out = step(state, raw_dev, ts_dev)
            pending.append((out, time.perf_counter()))
            stats.frames_in += 1
            drain(block_all=False)
        drain(block_all=True)
    finally:
        stop_event.set()
        # Deliver the writer's EOF sentinel without deadlocking: the writer
        # may still be draining (keep trying) or already dead (give up).
        for _ in range(300):
            try:
                out_q.put(None, timeout=0.1)
                break
            except queue.Full:
                if not writer_thread.is_alive():
                    break
        writer_thread.join(timeout=30)
        reader_thread.join(timeout=5)
    if writer_exc:
        raise writer_exc[0]
    if reader_exc:
        raise reader_exc[0]
    return stats
