"""Multi-stream end-to-end driver: N decoders -> one sharded device step ->
N encoders.

Reference parity: the reference can only run one ``VideoFilter::stream``
pipeline per filter instance (reference Filters/VideoFilter.cpp:62-209);
serving N videos means N independent processes/threads with no shared
batching.  Here the N streams batch into ONE vmapped+sharded step over a
`Mesh` "stream" axis (parallel/streams.py), so a chip (or a pod slice) serves
all of them with one program launch per frame tick — the batched shape of
BASELINE config 5 (8x1080p60 streams).

Design:
  * one reader thread per stream feeding a bounded queue (the reference's
    15-deep input queue semantics, per stream);
  * the main loop assembles a LOCKSTEP BATCH — one frame per live stream —
    uploads it as a single (S, H, W, 3) sharded array, and dispatches the
    jitted step without syncing (async dispatch pipelines ahead);
  * streams that end early keep their slot occupied with valid=False bubbles
    (static shapes) flagged drain=True, so their delay-queue residue emits
    while the other streams still run; merely-stalled streams get
    drain=False bubbles that FREEZE their temporal state (no frame loss);
  * a small in-flight window bounds device-ahead depth; draining syncs the
    oldest batch and fans results out to per-stream writer threads.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu.types import PixelFormat
from livevisionkit_tpu.utils.profiling import Stopwatch, compile_timed


@dataclass
class MultiStreamStats:
    frames_in: int = 0  # total decoded frames across streams
    frames_out: int = 0  # total valid emitted frames
    batches: int = 0
    stalls: int = 0  # bubbles injected for slow (not ended) streams
    batch_time: Stopwatch = field(default_factory=Stopwatch)
    per_stream_out: list = field(default_factory=list)
    # Set-up cost of the batched step (trace + compile, or a persistent-cache
    # load) and XLA's memory analysis of it.
    compile_seconds: float | None = None
    step_memory: object = None

    @property
    def fps_aggregate(self) -> float:
        avg = self.batch_time.average()
        if avg <= 0 or self.batches == 0:
            return 0.0
        return (self.frames_out / self.batches) / avg


def stream_multi(
    filt: VideoFilter,
    readers: Sequence,
    on_output: Callable[[int, np.ndarray, float], None] | None = None,
    mesh=None,
    work_format: PixelFormat = PixelFormat.YUV,
    queue_depth: int = 15,
    inflight: int = 3,
    max_frames: int | None = None,
    stop_event: threading.Event | None = None,
    flush: bool = True,
    slow_stream_timeout: float | None = 0.25,
) -> MultiStreamStats:
    """Run `filt` over S concurrent `readers` (each yields
    (bgr_hwc_uint8, timestamp)).

    on_output(stream_idx, planar_float_bgr (3,H,W), timestamp) is called from
    per-stream writer threads for every VALID output frame, in stream order.
    With a `mesh` (axis "stream"), batch and state shard across devices; on
    one device the batch still runs as one vmapped program.

    `slow_stream_timeout`: a stream whose decoder has no frame ready within
    this many seconds gets a valid=False bubble for THIS batch instead of
    stalling the other S-1 streams (no frame is dropped — its next frame
    rides a later batch).  The lockstep batch otherwise has head-of-line
    blocking: one wedged decoder would freeze every stream, which a serving
    runtime can't accept.  None restores strict lockstep (bit-exact batch
    scheduling for offline transcodes).  The first frame of each stream is
    always waited for (it defines the slot shape).
    """
    n = len(readers)
    stats = MultiStreamStats(per_stream_out=[0] * n)
    stop_event = stop_event or threading.Event()

    in_qs = [queue.Queue(maxsize=queue_depth) for _ in range(n)]

    def read_loop(i, reader):
        count = 0
        for frame, ts in reader:
            if stop_event.is_set():
                break
            in_qs[i].put((frame, ts))
            count += 1
            if max_frames is not None and count >= max_frames:
                break
        in_qs[i].put(None)  # EOF

    for i, r in enumerate(readers):
        threading.Thread(target=read_loop, args=(i, r), daemon=True).start()

    out_qs = [queue.Queue(maxsize=queue_depth) for _ in range(n)]
    writer_exc: list[BaseException] = []

    def write_loop(i):
        while True:
            item = out_qs[i].get()
            if item is None:
                return
            try:
                if on_output is not None:
                    on_output(i, *item)
            except BaseException as e:
                writer_exc.append(e)
                stop_event.set()
                return

    writers = [
        threading.Thread(target=write_loop, args=(i,), daemon=True)
        for i in range(n)
    ]
    for w in writers:
        w.start()

    bgr = PixelFormat.BGR

    def one_step(state, raw_u8, ts, live, drain):
        x = raw_u8.astype(jnp.float32).transpose(2, 0, 1) * (1.0 / 255.0)
        frame = Frame.create(x, timestamp=ts, fmt=bgr, valid=live)
        frame = frame.reformat(work_format)
        state, out = filt.step(state, frame, drain=drain)
        out = out.reformat(bgr)
        return state, (out.pixels, out.timestamp, out.valid)

    def batch_step(states, raws, tss, lives, drains):
        return jax.vmap(one_step)(states, raws, tss, lives, drains)

    # `drains` is a traced per-stream flag: an EOF'd slot DRAINS its delay
    # queue (bubbles advance it with identity motion, emitting the residue
    # while other streams still run), a merely-stalled slot FREEZES it (no
    # frame loss; see VideoFilter.step).  The terminal flush drains all.
    step = jax.jit(batch_step, donate_argnums=0)

    batch_sharding = (
        NamedSharding(mesh, P("stream")) if mesh is not None else None
    )

    states = None
    pending: deque = deque()

    def drain(block_all: bool):
        while pending and (block_all or len(pending) > inflight):
            px, ts, valid = pending.popleft()
            valid_np = np.asarray(valid)  # sync point (backpressure)
            if not valid_np.any():
                continue
            px_np = np.asarray(px)
            ts_np = np.asarray(ts)
            for i in range(n):
                if valid_np[i]:
                    stats.frames_out += 1
                    stats.per_stream_out[i] += 1
                    out_qs[i].put((px_np[i], float(ts_np[i])))

    eof = [False] * n
    drained = [0] * n  # batches dispatched since stream i's EOF
    last_frame = [None] * n  # keeps slot shape for EOF bubbles
    delay = getattr(filt, "delay", 0)
    try:
        while not stop_event.is_set() and not all(eof):
            raws, tss, lives = [], [], []
            for i in range(n):
                stalled = False
                if eof[i]:
                    item = None
                elif slow_stream_timeout is None or last_frame[i] is None:
                    item = in_qs[i].get()
                else:
                    try:
                        item = in_qs[i].get(timeout=slow_stream_timeout)
                    except queue.Empty:
                        item, stalled = None, True
                if stalled:
                    # Slow (not ended) stream: bubble THIS batch only.
                    stats.stalls += 1
                    raws.append(last_frame[i])
                    tss.append(0.0)
                    lives.append(False)
                elif item is None:
                    eof[i] = True
                    if last_frame[i] is None:
                        raise RuntimeError(f"stream {i} produced no frames")
                    raws.append(last_frame[i])  # bubble (dropped via valid)
                    tss.append(0.0)
                    lives.append(False)
                else:
                    raw_np, ts = item
                    last_frame[i] = raw_np
                    raws.append(raw_np)
                    tss.append(ts)
                    lives.append(True)
                    stats.frames_in += 1
            if all(eof) and not any(lives):
                break
            # A pure stall tick — no live frame and nothing left to drain —
            # would dispatch a batch where every slot's state is frozen and
            # every output invalid: skip it (a slow decoder otherwise spins
            # thousands of no-op device batches through the stall timeout).
            if not any(lives) and not any(
                eof[i] and drained[i] <= delay for i in range(n)
            ):
                continue
            for i in range(n):
                if eof[i]:
                    drained[i] += 1
            if states is None:
                h, w = raws[0].shape[:2]
                spec = FrameSpec(
                    height=h, width=w,
                    channels=work_format.channels, format=work_format,
                )
                states = jax.vmap(lambda _: filt.init(spec))(jnp.arange(n))
                if batch_sharding is not None:
                    states = jax.device_put(
                        states,
                        jax.tree.map(
                            lambda x: NamedSharding(
                                mesh, P("stream", *([None] * (x.ndim - 1)))
                            ),
                            states,
                        ),
                    )
            stats.batch_time.tick()
            batch = np.stack(raws)
            dev = (
                jax.device_put(batch, batch_sharding)
                if batch_sharding is not None
                else jnp.asarray(batch)
            )
            args = (
                states, dev, jnp.asarray(tss, jnp.float32),
                jnp.asarray(lives, jnp.bool_), jnp.asarray(eof, jnp.bool_),
            )
            if stats.compile_seconds is None:
                step, stats.compile_seconds, stats.step_memory = (
                    compile_timed(step, *args)
                )
            states, out = step(*args)
            stats.batches += 1
            pending.append(out)
            drain(block_all=False)
        # Flush: run `delay` bubble batches so frames still inside delay
        # queues emit (the reference's stream() drops them at termination,
        # VideoFilter.cpp:170-200; a serving runtime must not lose frames).
        if flush and states is not None and not stop_event.is_set():
            bubble_np = np.zeros(
                (n,) + last_frame[0].shape, last_frame[0].dtype
            )
            bubble = (
                jax.device_put(bubble_np, batch_sharding)
                if batch_sharding is not None
                else jnp.asarray(bubble_np)
            )
            lives_off = jnp.zeros((n,), jnp.bool_)
            drain_all = jnp.ones((n,), jnp.bool_)
            tss0 = jnp.zeros((n,), jnp.float32)
            for _ in range(getattr(filt, "delay", 0)):
                states, out = step(states, bubble, tss0, lives_off, drain_all)
                stats.batches += 1
                pending.append(out)
        drain(block_all=True)
    finally:
        stop_event.set()
        for q_ in out_qs:
            q_.put(None)
        for w in writers:
            w.join(timeout=30)
    if writer_exc:
        raise writer_exc[0]
    return stats
