"""Multi-stream end-to-end driver: N decoders -> sharded batch step -> N
encoders (BASELINE config 5 plumbing), vs the single-stream driver as
oracle."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fixtures
from livevisionkit_tpu.config import (
    FeatureDetectorSettings,
    FrameTrackerSettings,
    PathSmootherSettings,
    StabilizationFilterSettings,
)
from livevisionkit_tpu.filters.base import CompositeFilter
from livevisionkit_tpu.filters.stabilization import StabilizationFilter
from livevisionkit_tpu.parallel.streams import make_mesh
from livevisionkit_tpu.runtime import multistream
from livevisionkit_tpu.runtime.stream import stream

pytestmark = pytest.mark.slow  # whole module: sharded/jit-compile dominated


def _filter():
    return CompositeFilter(
        filters=(
            StabilizationFilter(
                settings=StabilizationFilterSettings(
                    tracker=FrameTrackerSettings(
                        detection_size=(60, 80),
                        detector=FeatureDetectorSettings(
                            grid_shape=(6, 8), fast_threshold_init=0.06
                        ),
                        min_motion_samples=10,
                    ),
                    smoother=PathSmootherSettings(predictive_samples=2),
                )
            ),
        )
    )


def _make_clip(rng, n_frames, seed_shift):
    base = fixtures.make_texture(240, 240, rng)
    poses, _ = fixtures.shaky_path(n_frames, rng, margin=60.0)
    clips = []
    for t, p in enumerate(poses):
        g = np.asarray(fixtures.render_frame(base, p, (64, 96)))
        u8 = np.clip(
            np.stack([g, g * 0.9, np.roll(g, seed_shift, 1)], -1) * 255, 0, 255
        ).astype(np.uint8)
        clips.append((u8, t / 30.0))
    return clips


@pytest.mark.parametrize("use_mesh", [False, True])
def test_multistream_matches_single_stream(rng, use_mesh):
    n_streams, n_frames = 4, 12
    clips = [_make_clip(rng, n_frames, s) for s in range(n_streams)]

    # Oracle: each stream through the single-stream driver independently.
    want = {}
    for i, clip in enumerate(clips):
        outs = []
        stream(
            _filter(), iter(clip),
            on_output=lambda px, ts, o=outs: o.append((px.copy(), ts)),
        )
        want[i] = outs

    mesh = make_mesh(n_streams, 1) if use_mesh else None
    got = {i: [] for i in range(n_streams)}
    lock = threading.Lock()

    def on_out(i, px, ts):
        with lock:
            got[i].append((px.copy(), ts))

    stats = multistream.stream_multi(
        _filter(), [iter(c) for c in clips], on_output=on_out, mesh=mesh
    )
    assert stats.frames_in == n_streams * n_frames
    # The multistream driver FLUSHES delay queues at termination (the
    # single-stream driver matches the reference's drop-on-terminate,
    # VideoFilter.cpp:170-200), so every input frame emits: delay extra
    # outputs per stream beyond the oracle.
    assert stats.frames_out == n_streams * n_frames
    for i in range(n_streams):
        assert len(want[i]) == n_frames - 2  # delay 2
        assert len(got[i]) == n_frames
        for (ga, ta), (wa, twa) in zip(got[i], want[i]):
            assert abs(ta - twa) < 1e-6
            # The sharded program fuses the solver/smoothing reductions
            # differently from the single-stream compile; corrections that
            # differ only in the float tail can flip the corrective warp's
            # u8 re-quantization (the reference's 8-bit UMat stores) at
            # isolated pixels.  The comparison happens AFTER the YUV->BGR
            # output conversion, whose rows mix planes (B <- 1*Y + 1.772*U,
            # R <- 1*Y + 1.402*V), so 1-LSB flips — possibly coincident in
            # two planes at the same pixel — show up scaled by up to the
            # largest row abs-sum, 2.772 (r4 advisor follow-up: measured
            # maxima 1.14/255 and 2.03/255 across runs, i.e. a Y flip plus
            # chroma mixing / two coincident flips).  Bound by 2.772/255
            # with tail slack, and require the flips isolated: equality to
            # 2e-5 at >=99.9% of pixels.
            diff = np.abs(ga.astype(np.float32) - wa.astype(np.float32))
            assert diff.max() <= 2.772 / 255.0 + 2e-5, diff.max()
            assert (diff > 2e-5).mean() <= 1e-3, (diff > 2e-5).mean()
        # Flushed tail carries the last two input frames' timestamps.
        assert [round(t * 30) for (_, t) in got[i][-2:]] == [10, 11]


def test_multistream_slow_stream_does_not_stall_batch(rng):
    """A slow (not ended) decoder must not freeze the other streams: with a
    bounded wait the driver bubbles the slow slot and keeps serving (r2
    VERDICT: head-of-line blocking in the lockstep batch).  The slow
    stream's frames are NOT dropped — they ride later batches."""
    import time

    n_frames = 8
    clips = [_make_clip(rng, n_frames, 0), _make_clip(rng, n_frames, 1)]

    def slow_reader(clip, delay):
        for item in clip:
            time.sleep(delay)
            yield item

    got = {0: [], 1: []}
    lock = threading.Lock()

    def on_out(i, px, ts):
        with lock:
            got[i].append((time.perf_counter(), ts))

    stats = multistream.stream_multi(
        _filter(),
        [iter(clips[0]), slow_reader(clips[1], 0.35)],
        on_output=on_out,
        slow_stream_timeout=0.05,
        inflight=0,
        # Depth 1 so the slow decoder can't hide behind prefetch while the
        # first batch compiles.
        queue_depth=1,
    )
    # No frame lost on either stream, and bubbles were actually injected.
    assert stats.frames_in == 2 * n_frames
    assert len(got[0]) == n_frames and len(got[1]) == n_frames
    assert stats.stalls > 0
    # Per-stream output order intact.
    for i in (0, 1):
        ts = [t for (_, t) in got[i]]
        assert ts == sorted(ts)
    # The fast stream finished long before the slow one: its last output
    # must not have waited for the slow decoder's tail (strict lockstep
    # would emit both tails together).
    fast_done = got[0][-1][0]
    slow_done = got[1][-1][0]
    assert slow_done - fast_done > 0.3, (fast_done, slow_done)


def test_multistream_uneven_stream_lengths(rng):
    """A stream ending early leaves bubbles, the others run to completion."""
    clips = [
        _make_clip(rng, 6, 0),
        _make_clip(rng, 12, 1),
    ]
    got = {0: [], 1: []}
    lock = threading.Lock()

    def on_out(i, px, ts):
        with lock:
            got[i].append(ts)

    stats = multistream.stream_multi(
        _filter(), [iter(c) for c in clips], on_output=on_out
    )
    assert stats.frames_in == 18
    # Every input frame emits: the short stream's tail flushes through
    # bubbles while the long stream still runs, the long stream's tail
    # through the terminal flush.
    assert len(got[0]) == 6
    assert len(got[1]) == 12
    # Timestamps stay ordered per stream (no bubble leaked out).
    assert got[0] == sorted(got[0])
    assert got[1] == sorted(got[1])


@pytest.mark.slow
def test_multistream_soak(rng):
    """r4 VERDICT #8: production-duration churn — back-to-back serving
    sessions with rotating slow/EOF streams; the tool asserts zero lost
    frames (the r5 drain-flag fix), no deadlock, stable pacing, and
    bounded RSS."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "bench_multistream.py"),
         "--soak", "60", "--streams", "4", "--size", "96x128",
         "--frames", "15"],
        capture_output=True, text=True, timeout=900,
        env={**{k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS",)},
             "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"},
        cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "soak OK" in proc.stderr


@pytest.mark.slow
def test_multistream_loopback_driver(rng):
    """r3 VERDICT #6: the serving driver validated at speed without device
    transfers — synthetic in-memory readers, a deliberately slow stream and an
    early-EOF stream; asserts (inside the tool) that fast streams finish
    their full clips (no head-of-line blocking) and bubbles were injected."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "bench_multistream.py"),
         "--loopback", "--streams", "4", "--size", "96x128", "--frames", "24"],
        capture_output=True, text=True, timeout=900,
        env={**{k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS",)},
             "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"},
        cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loopback OK" in proc.stderr
