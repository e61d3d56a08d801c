"""Colour-space conversions on planar (C, H, W) tensors.

Reference parity: the exhaustive conversion matrix in lvk::VideoFrame::reformatTo
(reference Data/VideoFrame.cpp:170-306), which delegates to OpenCV cvtColor.
We reproduce OpenCV's BT.601 full-range RGB<->YUV constants so numerics line up
with the reference pipeline (cvtColor RGB2YUV: Y = 0.299R+0.587G+0.114B,
U = 0.492(B-Y)+0.5, V = 0.877(R-Y)+0.5).

Everything here is a per-pixel 3x3 matrix + offset — a single fused
elementwise op under XLA, so there is no dedicated kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.types import PixelFormat

# BT.601 luma weights (OpenCV cvtColor, full range).
_LUMA_R, _LUMA_G, _LUMA_B = 0.299, 0.587, 0.114
_U_SCALE, _V_SCALE = 0.492, 0.877
_CHROMA_OFFSET = 0.5


def _matmul_chw(m: jax.Array, pixels: jax.Array, offset: jax.Array) -> jax.Array:
    """Apply y = m @ x + offset per pixel on a (3, H, W) tensor."""
    return jnp.einsum(
        "ij,jhw->ihw", m.astype(pixels.dtype), pixels, precision=lax.Precision.HIGHEST
    ) + offset[
        :, None, None
    ].astype(pixels.dtype)


def rgb_to_yuv_matrix() -> tuple[jax.Array, jax.Array]:
    r, g, b = _LUMA_R, _LUMA_G, _LUMA_B
    m = jnp.array(
        [
            [r, g, b],
            [-_U_SCALE * r, -_U_SCALE * g, _U_SCALE * (1.0 - b)],
            [_V_SCALE * (1.0 - r), -_V_SCALE * g, -_V_SCALE * b],
        ],
        jnp.float32,
    )
    off = jnp.array([0.0, _CHROMA_OFFSET, _CHROMA_OFFSET], jnp.float32)
    return m, off


def yuv_to_rgb_matrix() -> tuple[jax.Array, jax.Array]:
    m, off = rgb_to_yuv_matrix()
    inv = jnp.linalg.inv(m)
    return inv, -jnp.matmul(inv, off, precision=lax.Precision.HIGHEST)


def luma(pixels: jax.Array, fmt: PixelFormat) -> jax.Array:
    """(H, W) luminance from a (C, H, W) tensor of the given format."""
    if fmt in (PixelFormat.GRAY, PixelFormat.YUV):
        return pixels[0]
    if fmt is PixelFormat.RGB:
        w = jnp.array([_LUMA_R, _LUMA_G, _LUMA_B], pixels.dtype)
    elif fmt is PixelFormat.BGR:
        w = jnp.array([_LUMA_B, _LUMA_G, _LUMA_R], pixels.dtype)
    else:
        raise ValueError(f"cannot take luma of {fmt}")
    return jnp.einsum("c,chw->hw", w, pixels, precision=lax.Precision.HIGHEST)


def convert(pixels: jax.Array, src: PixelFormat, dst: PixelFormat) -> jax.Array:
    """Convert (C, H, W) planes between formats.

    Supports the reference's full conversion matrix (VideoFrame.cpp:170-306):
    any of {RGB, BGR, YUV, GRAY} to any other, including the GRAY->YUV
    mid-chroma merge (VideoFrame.cpp:281-295: Y=gray, U=V=128/255).
    """
    if src is dst:
        return pixels
    if PixelFormat.UNKNOWN in (src, dst):
        raise ValueError("cannot convert to/from UNKNOWN format")

    flip = jnp.array([2, 1, 0])

    if src is PixelFormat.GRAY:
        g = pixels[0]
        if dst in (PixelFormat.RGB, PixelFormat.BGR):
            return jnp.stack([g, g, g])
        if dst is PixelFormat.YUV:
            half = jnp.full_like(g, _CHROMA_OFFSET)
            return jnp.stack([g, half, half])

    if dst is PixelFormat.GRAY:
        return luma(pixels, src)[None]

    if src is PixelFormat.BGR:
        return convert(pixels[flip], PixelFormat.RGB, dst)
    if dst is PixelFormat.BGR:
        return convert(pixels, src, PixelFormat.RGB)[flip]

    if src is PixelFormat.RGB and dst is PixelFormat.YUV:
        m, off = rgb_to_yuv_matrix()
        return _matmul_chw(m, pixels, off)
    if src is PixelFormat.YUV and dst is PixelFormat.RGB:
        m, off = yuv_to_rgb_matrix()
        return _matmul_chw(m, pixels, off)

    raise ValueError(f"unsupported conversion {src} -> {dst}")
