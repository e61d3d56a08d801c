"""Live-mode frame latency: p50/p95/p99 ingest→output through runtime.stream.

r3 VERDICT #5: the reference's 6 ms stabilizer budget (VSFilter.cpp:71,380)
is a per-frame LATENCY budget in a live pipeline; all prior chip numbers
were scan-differenced throughput.  This tool drives the real
`runtime/stream.py` pipeline with a paced synthetic 1080p60 reader and
records per-frame submit→host-resident latency quantiles
(`StreamStats.latencies`).

The harness ALSO measures an identity-filter pipeline with the same frame
sizes: the stabilizer-minus-identity difference separates the filter's
per-frame compute from the transfer and driver floor, for comparison with
the reference budget.  The stabilizer's algorithmic content delay
(predictive_samples frames of delay queue) is deterministic and reported
separately, matching the reference's stream-delay indicator
(VSSource.cpp:301-314).

Usage: python tools/bench_latency.py [--frames 120] [--fps 60]
                                     [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def paced_reader(frames, fps, n):
    """fps <= 0 disables pacing: the queue's backpressure sets the rate
    (pacing faster than the pipeline drains grows the queue, and the
    latency then measures the backlog, not the pipeline)."""
    period = 1.0 / fps if fps > 0 else 0.0
    t0 = time.perf_counter()
    for t in range(n):
        if period:
            deadline = t0 + t * period
            now = time.perf_counter()
            if deadline > now:
                time.sleep(deadline - now)
        yield frames[t % len(frames)], t * (period or 1 / 60.0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--fps", type=float, default=0.0,
                    help="paced reader fps; <= 0 = unpaced (backpressure)")
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--inflight", type=int, default=3,
                    help="pipeline in-flight window (depth = inflight + 1); "
                    "1 trades throughput for lower per-frame latency")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    import numpy as np

    from livevisionkit_tpu.utils import compile_cache

    compile_cache.enable_default()

    import livevisionkit_tpu  # noqa: F401
    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.filters.base import CompositeFilter, IdentityFilter
    from livevisionkit_tpu.runtime.stream import stream

    h, w = map(int, args.size.split("x"))
    rng = np.random.default_rng(0)
    ring = [
        (rng.uniform(0, 255, size=(h, w, 3))).astype(np.uint8)
        for _ in range(8)
    ]

    results = []

    def run(name, filt):
        log(f"{name}: warm-up + {args.frames} paced frames ...")
        # Warm-up pass compiles everything (compile cache persists).
        stream(filt, paced_reader(ring, args.fps, 12),
               on_output=lambda px, ts: None, inflight=args.inflight)
        t0 = time.perf_counter()
        stats = stream(filt, paced_reader(ring, args.fps, args.frames),
                       on_output=lambda px, ts: None, inflight=args.inflight)
        wall = time.perf_counter() - t0
        row = {
            "config": name,
            "size": args.size,
            "paced_fps": args.fps,
            "inflight": args.inflight,
            "frames": stats.frames_out,
            "achieved_fps": round(stats.frames_out / wall, 1),
            **{k: round(v, 2) for k, v in stats.latency_quantiles().items()},
        }
        results.append(row)
        print(json.dumps(row), flush=True)
        return row

    ident = run(
        "identity_pipeline_floor",
        CompositeFilter(filters=(IdentityFilter(),)),
    )
    filt = _flagship_filter()
    vs = run("vs_1080p_latency", CompositeFilter(filters=(filt,)))

    # Transport-cancelled per-frame compute latency: in the unpaced steady
    # state every pipeline slot is saturated, so p50 ~ (inflight+1) x
    # per-frame service time; the stabilizer-minus-identity difference
    # divided by the pipeline depth estimates the added compute per frame
    # with the (identical) transport floor cancelled.
    depth = args.inflight + 1  # in-flight window + the frame being drained
    # The claim this row supports (r4 VERDICT #5): the transport-cancelled
    # estimate TRACKS the scan-differenced device step at the same size.
    # Measure that step here (same full per-frame program as the live
    # pipeline: u8 HWC upload -> BGR -> YUV -> stabilize -> BGR) so the
    # comparison is self-contained per size.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax.numpy as jnp

    from livevisionkit_tpu.data.frame import Frame
    from livevisionkit_tpu.filters.base import FrameSpec
    from livevisionkit_tpu.types import PixelFormat
    from profile_stages import scan_time

    raw = jnp.asarray(ring[0])
    spec = FrameSpec(height=h, width=w, channels=3, format=PixelFormat.YUV)
    st0 = filt.init(spec)

    def body(s, t):
        x = (raw.astype(jnp.float32) + 1e-9 * t).transpose(2, 0, 1) / 255.0
        fr = Frame.create(x, timestamp=t / 60.0, fmt=PixelFormat.BGR)
        fr = fr.reformat(PixelFormat.YUV)
        s, out = filt.step(s, fr)
        out = out.reformat(PixelFormat.BGR)
        return s, jnp.sum(out.pixels[..., ::128, ::128])

    scan_step_ms = scan_time(body, st0, stat="median")
    delta = {
        "config": "vs_minus_identity",
        "size": args.size,
        "inflight": args.inflight,
        **{
            k: round(vs[k] - ident[k], 2)
            for k in ("p50_ms", "p95_ms", "p99_ms")
            if k in vs and k in ident
        },
        "per_frame_compute_ms_est": round(
            (vs["p50_ms"] - ident["p50_ms"]) / depth, 2
        ),
        "scan_step_ms": round(scan_step_ms, 2),
        "delay_queue_frames": filt.settings.smoother.predictive_samples,
        "delay_queue_ms_at_60fps": round(
            filt.settings.smoother.predictive_samples * 1000.0 / 60.0, 1
        ),
        "reference_budget_ms": 6.0,
    }
    results.append(delta)
    print(json.dumps(delta), flush=True)

    if args.json_out:
        with open(args.json_out, "a") as f:
            for row in results:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
