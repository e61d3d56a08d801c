"""Stage-level device latency profile of the stabilization step.

Same scan-delta methodology as bench.py: each stage is wrapped in its own
lax.scan over N iterations with state carried, timed at two N values, and the
per-iteration time is the slope — cancels dispatch/readback constants.

Usage: python tools/profile_stages.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def scan_time(make_body, state, n1=20, n2=80, reps=3, stat="min"):
    """Per-iteration time of `make_body` via scan-length differencing.

    stat="min" (default) keeps the historical best-of-reps slope; "median"
    is robust when the host is loaded (a slow t1 next to a fast t2 can push
    a single slope negative — the median of several slopes cannot)."""
    def scan_n(n):
        def wrapped(s):
            return jax.lax.scan(make_body, s, jnp.arange(n))

        return jax.jit(wrapped)

    run1, run2 = scan_n(n1), scan_n(n2)

    def timed(run, s):
        t0 = time.perf_counter()
        s2, out = run(s)
        # Host readback of one output forces completion; its constant
        # transfer cost cancels in the slope.
        np.asarray(jax.tree.leaves(out)[0])
        return time.perf_counter() - t0, s2

    _, s = timed(run1, state)
    _, s = timed(run2, s)
    slopes = []
    for _ in range(reps):
        t1, s = timed(run1, s)
        t2, s = timed(run2, s)
        slopes.append((t2 - t1) / (n2 - n1))
    agg = np.min if stat == "min" else np.median
    return float(agg(slopes)) * 1000.0


def main():
    import livevisionkit_tpu as lvk
    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.vision import frame_tracker, path_smoother
    from livevisionkit_tpu.models.warp_field import WarpField
    from livevisionkit_tpu.ops import resample

    filt = _flagship_filter()
    s = filt.settings
    spec = lvk.FrameSpec(height=1080, width=1920, channels=3,
                         format=lvk.PixelFormat.YUV)
    state0 = filt.init(spec)

    rng = np.random.default_rng(0)
    pix = jnp.asarray(rng.uniform(0.1, 0.9, size=(3, 1080, 1920)).astype(np.float32))
    frame = lvk.Frame.create(pix, timestamp=0.0, fmt=lvk.PixelFormat.YUV)
    luma = frame.luma()

    # --- full step ------------------------------------------------------
    def full_body(st, t):
        # pixels must vary with t or XLA hoists input-only work out of
        # the scan (loop-invariant code motion) and the number lies.
        f = frame.replace(pixels=frame.pixels + 1e-9 * t,
                          timestamp=t.astype(jnp.float32))
        st, out = filt.step(st, f)
        return st, jnp.sum(out.pixels[:, ::256, ::256])

    print(f"full step:            {scan_time(full_body, state0):7.3f} ms")

    # --- tracker only -----------------------------------------------------
    def track_body(st, t):
        st, res = frame_tracker.track(st, luma + 1e-6 * t, s.tracker)
        return st, res.stability

    print(f"tracker.track:        {scan_time(track_body, state0.tracker):7.3f} ms")

    # --- luma view + detection resize only -------------------------------
    def resize_body(c, t):
        g = resample.resize(frame.luma() + 1e-6 * t, s.tracker.detection_size)
        return c, jnp.sum(g[::64, ::64])

    print(f"luma+detect resize:   {scan_time(resize_body, jnp.float32(0)):7.3f} ms")

    # --- warp apply at 1080p ---------------------------------------------
    wf = WarpField.identity(s.tracker.motion_resolution)
    wf = wf.replace(offsets=wf.offsets + 0.01)

    def warp_body(c, t):
        out = wf.replace(offsets=wf.offsets + 1e-6 * t).apply(pix, fill=0.0)
        return c, jnp.sum(out[:, ::256, ::256])

    print(f"warp.apply 1080p:     {scan_time(warp_body, jnp.float32(0)):7.3f} ms")

    # --- smoother ---------------------------------------------------------
    sm0 = path_smoother.init(s.smoother, s.tracker.motion_resolution)
    motion = WarpField.identity(s.tracker.motion_resolution)

    def smooth_body(st, t):
        st, corr, ready = path_smoother.next_correction(
            st, motion.replace(offsets=motion.offsets + 1e-6 * t), s.smoother
        )
        return st, jnp.sum(corr.offsets)

    print(f"smoother:             {scan_time(smooth_body, sm0):7.3f} ms")

    # --- tracker sub-stages ------------------------------------------------
    try:
        from livevisionkit_tpu.vision import features as feats_mod

        det0 = frame_tracker.init(s.tracker)
        g = resample.resize(luma, s.tracker.detection_size)

        def detect_body(st, t):
            fs, thr = feats_mod.detect(g + 1e-6 * t, det0.thresholds, s.tracker.detector)
            return st, jnp.sum(fs.points) + jnp.sum(thr)

        print(f"features.detect:      {scan_time(detect_body, jnp.float32(0)):7.3f} ms")
    except Exception as e:  # signature drift: report, keep going
        print(f"features.detect:      skipped ({e})")


if __name__ == "__main__":
    main()
