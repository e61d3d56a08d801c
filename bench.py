"""Headline benchmark: 1080p60-class stabilization latency per frame per GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Baseline target (BASELINE.md): < 8 ms/frame/chip at 1080p.
vs_baseline = 8.0 / measured_ms  (>1 means better than target).  "device"
names the platform, device kind, device count and the card's power limit.
Exits non-zero when JAX finds no GPU.

Measurement methodology: the whole steady-state loop runs ON DEVICE as one
`lax.scan` over the per-frame step (state carried, frames cycled from a
device-resident ring), so host<->device transfers are not in the number.
Per-frame time = (T(scan of N2) - T(scan of N1)) / (N2 - N1), which also
cancels the constant dispatch + readback cost.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _build(filt, spec_cls, frame_cls, fmt):
    import livevisionkit_tpu as lvk

    spec = spec_cls(height=1080, width=1920, channels=3, format=fmt)
    state = filt.init(spec)

    rng = np.random.default_rng(0)
    n_ring = 8
    base = rng.uniform(0.1, 0.9, size=(1, 1080, 1920)).astype(np.float32)
    drift = np.cumsum(rng.uniform(-2, 2, size=(n_ring, 2)), axis=0).astype(int)
    ring = np.stack(
        [
            np.broadcast_to(
                np.roll(np.roll(base, d[0], axis=-2), d[1], axis=-1),
                (3, 1080, 1920),
            )
            for d in drift
        ]
    )
    frames = jax.device_put(jnp.asarray(ring))

    def scan_n(state, n):
        def body(carry, t):
            state = carry
            frame = frame_cls.create(
                frames[t % n_ring], timestamp=t.astype(jnp.float32) / 60.0, fmt=fmt
            )
            state, out = filt.step(state, frame)
            return state, jnp.sum(out.pixels[:, ::256, ::256])

        return jax.lax.scan(body, state, jnp.arange(n))

    return state, scan_n


def main() -> None:
    from chip_smoke import card_line, require_gpu

    devices = require_gpu()
    import livevisionkit_tpu as lvk
    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.utils import compile_cache

    compile_cache.enable_default()

    filt = _flagship_filter()
    state0, scan_n = _build(filt, lvk.FrameSpec, lvk.Frame, lvk.PixelFormat.YUV)

    n1, n2 = 20, 80
    run1 = jax.jit(lambda s: scan_n(s, n1))
    run2 = jax.jit(lambda s: scan_n(s, n2))

    def timed(run, state):
        t0 = time.perf_counter()
        s, sums = run(state)
        float(jnp.sum(sums))  # host readback forces completion
        return time.perf_counter() - t0, s

    # Warm-up compiles + queue fill.
    _, state = timed(run1, state0)
    _t, state = timed(run2, state)

    best = np.inf
    for _ in range(3):
        t1, state = timed(run1, state)
        t2, state = timed(run2, state)
        best = min(best, (t2 - t1) / (n2 - n1))

    ms = best * 1000.0
    print(
        json.dumps(
            {
                "metric": "1080p_stabilization_latency",
                "value": round(ms, 3),
                "unit": "ms/frame/gpu",
                "vs_baseline": round(8.0 / ms, 3),
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                    "name_power_limit": card_line(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
