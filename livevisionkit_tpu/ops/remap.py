"""Warp-resampling (remap) ops: the hot path of the whole engine.

Reference parity: ``lvk::remap`` over an offset map and over a homography
(reference Functions/Image.hpp:26-38, Functions/Image.cpp:28-233), which
launch the fused OpenCL ``easu_remap`` / ``easu_remap_homography`` kernels
(Functions/OpenCL/Sources/FSR.cl:362-452).  Border semantics there: samples
that fall outside the source are filled with a background colour, with a
nearest-neighbour fallback ring just inside the border (FSR.cl:385-397).

This module holds the gather-based bilinear warp; the EASU-filtered warp
lives in ops/easu.py.  Both share the coordinate conventions defined here:

  * Sample maps are **absolute pixel coordinates** stacked as (2, H, W) with
    plane 0 = y, plane 1 = x (pixel centers at integer coordinates, like
    OpenCV remap).
  * A backward warp: output(u) = input(map(u)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear_sample(
    img: jax.Array,
    ys: jax.Array,
    xs: jax.Array,
    fill: jax.Array | float | None = None,
) -> jax.Array:
    """Sample (..., H, W) image planes at fractional (ys, xs).

    ys/xs: arbitrary (but equal) shapes S. Returns (..., *S).
    fill=None clamps to the border (cv BORDER_REPLICATE); otherwise
    out-of-bounds samples take `fill` (per-plane scalar or broadcastable),
    matching the reference's background-fill semantics (FSR.cl:385-397).
    """
    h, w = img.shape[-2], img.shape[-1]
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    wy = ys - y0  # fractional weights
    wx = xs - x0

    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)

    # Gather the 4 bilinear taps. Leading plane dims broadcast through.
    v00 = img[..., y0i, x0i]
    v01 = img[..., y0i, x1i]
    v10 = img[..., y1i, x0i]
    v11 = img[..., y1i, x1i]

    wy = wy.astype(img.dtype)
    wx = wx.astype(img.dtype)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy

    if fill is not None:
        inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
        fill_arr = jnp.asarray(fill, img.dtype)
        if fill_arr.ndim == 1:  # per-plane fill colour
            fill_arr = fill_arr.reshape(fill_arr.shape + (1,) * ys.ndim)
        out = jnp.where(inside, out, fill_arr)
    return out


def remap(
    img: jax.Array,
    sample_map: jax.Array,
    fill: jax.Array | float | None = 0.0,
    filter_mode: str = "bilinear",
    fmt=None,
) -> jax.Array:
    """Backward-warp (C, H, W) or (H, W) image by an absolute-coordinate map.

    sample_map: (2, H', W') with plane 0 = source y, plane 1 = source x.
    Equivalent of lvk::remap(offset_map) (Functions/Image.cpp:28-81).

    filter_mode selects the sampling filter: "easu" is the reference-parity
    default at the call sites that mirror WarpMesh::apply (the reference
    *always* remaps through the fused EASU kernel, WarpMesh.cpp:183-223 →
    FSR.cl:362-403); "bilinear" is the cheaper option.  `fmt` is the
    PixelFormat used for EASU's luma selection (default YUV).  uint8
    images are warped in float32 and re-quantized on output, as the
    reference warps u8 UMats into u8 outputs.
    """
    if filter_mode not in ("bilinear", "easu"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if filter_mode == "easu" and fmt is None:
        from livevisionkit_tpu.types import PixelFormat

        fmt = PixelFormat.YUV
    img_f = img.astype(jnp.float32) if img.dtype == jnp.uint8 else img
    if filter_mode == "easu":
        from livevisionkit_tpu.ops import easu as easu_ops

        out = easu_ops.easu_remap(img_f, sample_map, fmt=fmt, fill=fill)
        return _cast_like(out, img.dtype)
    out = bilinear_sample(img_f, sample_map[0], sample_map[1], fill=fill)
    return _cast_like(out, img.dtype)


def _cast_like(out: jax.Array, dtype) -> jax.Array:
    if dtype == jnp.uint8:
        return jnp.clip(jnp.round(out), 0.0, 255.0).astype(jnp.uint8)
    return out.astype(dtype)


def identity_map(size: tuple[int, int], dtype=jnp.float32) -> jax.Array:
    """(2, H, W) map of each pixel's own coordinates."""
    h, w = size
    yy = jax.lax.broadcasted_iota(dtype, (h, w), 0)
    xx = jax.lax.broadcasted_iota(dtype, (h, w), 1)
    return jnp.stack([yy, xx])
