"""RCAS: Robust Contrast-Adaptive Sharpening — dense XLA form.

Reference parity: the `rcas` OpenCL kernel (reference Functions/OpenCL/
Sources/FSR.cl:460-537): per pixel, a 4-neighbour cross (b/d/f/h around e)
drives a negative-lobe sharpening amount limited so no ringing is introduced
(lobe clamped to [-0.1875, 0] scaled by sharpness), resolved as
(b+d+f+h)*lobe + e) / (4*lobe + 1).  Border pixels copy through.

A pure 5-point stencil — four shifted views + elementwise math, which XLA
fuses into one pass over the (C, H, W) planes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rcas(img: jax.Array, sharpness: float = 0.8) -> jax.Array:
    """Sharpen (C, H, W) or (H, W) planes. `sharpness` in [0, 1]."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]

    e = img
    # Shifted views as unit-stride slices of one edge-pad: XLA fuses these
    # into the single elementwise pass (jnp.roll concat-materializes a full
    # frame per shift — ~380 MB of traffic at 4K).
    p = jnp.pad(img, ((0, 0), (1, 1), (1, 1)), mode="edge")
    b = p[:, :-2, 1:-1]  # above
    h = p[:, 2:, 1:-1]  # below
    d = p[:, 1:-1, :-2]  # left
    f = p[:, 1:-1, 2:]  # right

    mn4 = jnp.minimum(jnp.minimum(b, d), jnp.minimum(f, h))
    mx4 = jnp.maximum(jnp.maximum(b, d), jnp.maximum(f, h))

    # Per-channel limiters (FSR.cl:515-526).
    hit_min = jnp.minimum(mn4, e) / (4.0 * jnp.maximum(mx4, 1e-6))
    hit_max = (1.0 - jnp.maximum(mx4, e)) / jnp.minimum(4.0 * mn4 - 4.0, -1e-6)
    lobe_c = jnp.maximum(-hit_min, hit_max)
    # Worst case across channels, clamped to the stable range.
    lobe = jnp.clip(jnp.max(lobe_c, axis=0, keepdims=True), -0.1875, 0.0) * sharpness

    # One reciprocal on the shared (1, H, W) lobe plane instead of a
    # 3-channel broadcast division.
    out = ((b + d + f + h) * lobe + e) * (1.0 / (4.0 * lobe + 1.0))

    # Borders copy through (FSR.cl:484-491).
    _, hh, ww = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 1)
    interior = (yy > 0) & (yy < hh - 1) & (xx > 0) & (xx < ww - 1)
    out = jnp.where(interior, out, e)
    return out[0] if squeeze else out
