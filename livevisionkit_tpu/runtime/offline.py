"""Offline (batch) clip processing: the whole loop on device via lax.scan.

Live streaming (runtime/stream.py) optimizes per-frame latency; offline
editing wants throughput.  Here the entire clip (or a chunk of it) is
processed as ONE device program — `lax.scan` over the per-frame step with
the filter state as carry — so there is zero host round-trip per frame.
This is also the measurement harness bench.py uses: scan-length differencing
isolates true per-frame device time from dispatch/readback latency.

The reference has no equivalent (its throughput mode is the same 3-thread
pipeline); this is an addition enabled by the functional step.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu.types import PixelFormat


def process_clip(
    filt: VideoFilter,
    pixels: jax.Array,  # (T, C, H, W) float planes
    fmt: PixelFormat,
    timestamps: jax.Array | None = None,
    state: Any | None = None,
) -> tuple[Any, Frame]:
    """Run `filt` over a whole clip on device.

    Returns (final_state, outputs) where outputs is a Frame pytree with a
    leading T axis (pixels (T, C, H', W'), valid (T,), timestamp (T,)).
    Invalid entries (warm-up delay) are flagged, not removed — filter the
    batch on the host with `outputs.valid`.
    """
    t_frames, c, h, w = pixels.shape
    if timestamps is None:
        timestamps = jnp.arange(t_frames, dtype=jnp.float32) / 30.0
    if state is None:
        state = filt.init(FrameSpec(height=h, width=w, channels=c, format=fmt))

    def body(carry, xs):
        px, ts = xs
        frame = Frame.create(px, timestamp=ts, fmt=fmt)
        carry, out = filt.step(carry, frame)
        return carry, out

    return jax.lax.scan(body, state, (pixels, timestamps))


def process_clip_sharded(
    filt: VideoFilter,
    pixels: jax.Array,  # (T, C, H, W)
    fmt: PixelFormat,
    mesh,  # jax.sharding.Mesh with a "time" axis
    overlap: int = 48,
    timestamps: jax.Array | None = None,
) -> Frame:
    """Temporal sharding with halo overlap (SURVEY.md §5.7): a long clip is
    split into per-device chunks that each re-run `overlap` warm-up frames
    from their left neighbour's range, so every device's temporal state
    (delay queue, trajectory window, QA servos) has converged before its
    own output region starts.  Embarrassingly parallel — zero collectives —
    so offline throughput scales linearly with devices.

    `overlap` must exceed the filter delay + smoothing window (+ some servo
    settling); outputs for the overlap region are flagged invalid.  Returns
    a Frame batch with a leading T axis; entries whose `valid` is False
    (global warm-up and per-chunk halos) must be dropped by the caller.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape["time"]
    t_frames, c, h, w = pixels.shape
    if timestamps is None:
        timestamps = jnp.arange(t_frames, dtype=jnp.float32) / 30.0
    chunk = -(-t_frames // n_dev)
    pad_t = chunk * n_dev - t_frames
    pixels_p = jnp.pad(pixels, ((0, pad_t), (0, 0), (0, 0), (0, 0)))
    ts_p = jnp.pad(timestamps, (0, pad_t))
    # Left-halo frames for each chunk (device d re-runs the last `overlap`
    # frames of chunk d-1; device 0 gets zero-padding, flagged invalid).
    starts = jnp.arange(n_dev) * chunk
    halo_idx = starts[:, None] - overlap + jnp.arange(overlap)[None, :]
    halo_valid = halo_idx >= 0
    halo_px = pixels_p[jnp.clip(halo_idx, 0, t_frames - 1)]  # (D, overlap, ...)
    halo_ts = ts_p[jnp.clip(halo_idx, 0, t_frames - 1)]

    chunks_px = pixels_p.reshape(n_dev, chunk, c, h, w)
    chunks_ts = ts_p.reshape(n_dev, chunk)
    state0 = filt.init(FrameSpec(height=h, width=w, channels=c, format=fmt))

    def run_chunk(px_halo, ts_halo, hv, px_main, ts_main):
        px_halo, ts_halo, hv = px_halo[0], ts_halo[0], hv[0]
        px_main, ts_main = px_main[0], ts_main[0]

        def body(carry, xs):
            p, t, v = xs
            frame = Frame.create(p, timestamp=t, fmt=fmt, valid=v)
            carry, out = filt.step(carry, frame)
            return carry, out

        all_px = jnp.concatenate([px_halo, px_main])
        all_ts = jnp.concatenate([ts_halo, ts_main])
        all_v = jnp.concatenate([hv, jnp.ones(chunk, bool)])
        state, outs = jax.lax.scan(body, state0, (all_px, all_ts, all_v))
        # Keep only the main region's outputs; flag the halo region invalid.
        keep = jax.tree.map(lambda x: x[overlap:], outs)
        return jax.tree.map(lambda x: x[None], keep)

    fn = shard_map(
        run_chunk,
        mesh=mesh,
        in_specs=(P("time"), P("time"), P("time"), P("time"), P("time")),
        out_specs=P("time"),
        # No collectives inside (embarrassingly parallel); the varying-axis
        # checker rejects scan carries built from replicated init state.
        check_vma=False,
    )
    outs = fn(halo_px, halo_ts, halo_valid, chunks_px, chunks_ts)
    # (D, chunk, ...) -> (T, ...), dropping the tail padding.
    flat = jax.tree.map(
        lambda x: x.reshape((n_dev * chunk,) + x.shape[2:])[:t_frames], outs
    )
    return flat
