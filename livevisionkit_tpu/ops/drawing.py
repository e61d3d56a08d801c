"""Debug drawing: grids, points, crosses, rectangles on device frames.

Reference parity: the GPU overlay kernels ``grid``/``points``/``crosses``
(reference Functions/OpenCL/Sources/Drawing.cl:22,43,73) and the drawing
helpers + per-format colour tables (reference Functions/Drawing.hpp:22-124),
used by every filter's test mode (e.g. StabilizationFilter debug draws,
StabilizationFilter.cpp:163-188; LCFilter grid overlay, LCFilter.cpp:179-183).

Design: overlays are computed as dense masks (iota compares / scatter
one-hots) and blended in one fused pass — no per-primitive kernel launches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.types import PixelFormat

# Colour constants per format (reference Drawing.hpp YUV/BGR tables).
_COLOURS_RGB = {
    "red": (1.0, 0.1, 0.1),
    "green": (0.1, 1.0, 0.1),
    "blue": (0.15, 0.3, 1.0),
    "yellow": (1.0, 0.9, 0.1),
    "magenta": (1.0, 0.1, 1.0),
    "white": (1.0, 1.0, 1.0),
    "black": (0.0, 0.0, 0.0),
}


def colour(name: str, fmt: PixelFormat) -> jnp.ndarray:
    r, g, b = _COLOURS_RGB[name]
    if fmt in (PixelFormat.RGB, PixelFormat.UNKNOWN):
        return jnp.array([r, g, b], jnp.float32)
    if fmt is PixelFormat.BGR:
        return jnp.array([b, g, r], jnp.float32)
    if fmt is PixelFormat.GRAY:
        y = 0.299 * r + 0.587 * g + 0.114 * b
        return jnp.array([y], jnp.float32)
    # YUV (BT.601 full range, like ops/color.py)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return jnp.array(
        [y, 0.492 * (b - y) + 0.5, 0.877 * (r - y) + 0.5], jnp.float32
    )


def _blend(img: jax.Array, mask: jax.Array, col: jax.Array) -> jax.Array:
    """Blend colour into (C, H, W) image where mask (H, W) in [0, 1]."""
    return img * (1.0 - mask) + col[:, None, None] * mask


def draw_grid(
    img: jax.Array,
    grid_shape: tuple[int, int],
    col: jax.Array,
    thickness: int = 1,
) -> jax.Array:
    """Overlay a corner-aligned grid (reference Drawing.cl `grid` kernel)."""
    c, h, w = img.shape
    gy, gx = grid_shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    py = (h - 1) / (gy - 1)
    px = (w - 1) / (gx - 1)
    dy = jnp.abs(jnp.mod(yy + py / 2, py) - py / 2)
    dx = jnp.abs(jnp.mod(xx + px / 2, px) - px / 2)
    mask = ((dy < thickness) | (dx < thickness)).astype(img.dtype)
    return _blend(img, mask, col.astype(img.dtype))


def draw_points(
    img: jax.Array,
    points: jax.Array,  # (N, 2) (x, y)
    valid: jax.Array,  # (N,)
    col: jax.Array,
    radius: int = 2,
) -> jax.Array:
    """Scatter filled squares at points (reference `points` kernel)."""
    c, h, w = img.shape
    hits = jnp.zeros((h, w), img.dtype)
    xi = jnp.clip(points[:, 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(points[:, 1].astype(jnp.int32), 0, h - 1)
    vals = valid.astype(img.dtype)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            ys = jnp.clip(yi + dy, 0, h - 1)
            xs = jnp.clip(xi + dx, 0, w - 1)
            hits = hits.at[ys, xs].max(vals)
    return _blend(img, hits, col.astype(img.dtype))


def draw_crosses(
    img: jax.Array,
    points: jax.Array,
    valid: jax.Array,
    col: jax.Array,
    radius: int = 3,
) -> jax.Array:
    """Scatter + shaped crosses at points (reference `crosses` kernel)."""
    c, h, w = img.shape
    hits = jnp.zeros((h, w), img.dtype)
    xi = jnp.clip(points[:, 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(points[:, 1].astype(jnp.int32), 0, h - 1)
    vals = valid.astype(img.dtype)
    for d in range(-radius, radius + 1):
        hits = hits.at[jnp.clip(yi + d, 0, h - 1), xi].max(vals)
        hits = hits.at[yi, jnp.clip(xi + d, 0, w - 1)].max(vals)
    return _blend(img, hits, col.astype(img.dtype))


def draw_rect(
    img: jax.Array,
    top_left: tuple[float, float],  # (x, y), fractions of frame
    bottom_right: tuple[float, float],
    col: jax.Array,
    thickness: int = 2,
) -> jax.Array:
    """Rectangle outline (e.g. the stable-region crop box of the
    stabilizer's test mode)."""
    c, h, w = img.shape
    x0, y0 = top_left[0] * (w - 1), top_left[1] * (h - 1)
    x1, y1 = bottom_right[0] * (w - 1), bottom_right[1] * (h - 1)
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    inside = (yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)
    core = (
        (yy >= y0 + thickness)
        & (yy <= y1 - thickness)
        & (xx >= x0 + thickness)
        & (xx <= x1 - thickness)
    )
    mask = (inside & ~core).astype(img.dtype)
    return _blend(img, mask, col.astype(img.dtype))


def draw_motion_field(
    img: jax.Array,
    offsets: jax.Array,  # (2, Hm, Wm) normalized field
    col: jax.Array,
    scale: float = 1.0,
) -> jax.Array:
    """Visualize a WarpField: crosses at grid nodes displaced by the motion
    (the stabilizer test-mode motion mesh, StabilizationFilter.cpp:163-188)."""
    c, h, w = img.shape
    _, hm, wm = offsets.shape
    gy = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 0) * ((h - 1) / (hm - 1))
    gx = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 1) * ((w - 1) / (wm - 1))
    py = gy + offsets[0] * (h - 1) * scale
    px = gx + offsets[1] * (w - 1) * scale
    pts = jnp.stack([px.reshape(-1), py.reshape(-1)], axis=-1)
    ok = jnp.ones(pts.shape[0], bool)
    return draw_crosses(img, pts, ok, col)
