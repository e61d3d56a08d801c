"""Resize, pyramid, blur, and gradient ops on planar (C, H, W) / (H, W) tensors.

Reference parity:
  * detection-resolution downscale: cv::resize INTER_AREA/LINEAR used by
    FrameTracker (reference Vision/FrameTracker.cpp:117).
  * pyramid build: cv::buildOpticalFlowPyramid's pyrDown (5-tap binomial blur
    + 2x decimation) used inside SparsePyrLKOpticalFlow
    (reference Vision/FrameTracker.cpp:140-146).
  * spatial gradients: OpenCV LK's Scharr 3x3 derivative.

All of these are static-shape stencil ops that XLA fuses; convolutions use
reflect padding done explicitly with
jnp.pad (mirroring OpenCV BORDER_REFLECT_101) since lax.conv only pads with
zeros.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# 5-tap binomial (Gaussian approx) used by cv::pyrDown.
_BINOMIAL5 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0

# Scharr 3x3 derivative, OpenCV normalisation (1/32).
_SCHARR_D = jnp.array([-1.0, 0.0, 1.0])
_SCHARR_S = jnp.array([3.0, 10.0, 3.0]) / 32.0


def _sep_conv2d(img: jax.Array, kh: jax.Array, kw: jax.Array) -> jax.Array:
    """Separable 2-D correlation with reflect-101 padding.

    img: (..., H, W); kh/kw: 1-D kernels applied along H / W.

    Implemented as statically UNROLLED shift-and-add (tap-weighted static
    slices of the padded image), not `lax.conv`: the unrolled form fuses
    into a few elementwise passes.  Whether a convolution is faster on the
    GPU is not measured.
    """
    import numpy as np

    kh_c = np.asarray(kh, np.float32)
    kw_c = np.asarray(kw, np.float32)
    ph, pw = len(kh_c) // 2, len(kw_c) // 2
    h, w = img.shape[-2], img.shape[-1]
    x = jnp.pad(
        img,
        [(0, 0)] * (img.ndim - 2) + [(ph, ph), (pw, pw)],
        mode="reflect",
    )
    acc = None
    for i, kv in enumerate(kh_c):  # H pass (keeps W padding)
        term = x[..., i : i + h, :] * float(kv)
        acc = term if acc is None else acc + term
    out = None
    for j, kv in enumerate(kw_c):  # W pass
        term = acc[..., :, j : j + w] * float(kv)
        out = term if out is None else out + term
    return out


def gaussian_blur5(img: jax.Array) -> jax.Array:
    """5-tap binomial blur (cv::pyrDown's smoothing kernel)."""
    return _sep_conv2d(img, _BINOMIAL5, _BINOMIAL5)


def _decimate2(img: jax.Array) -> jax.Array:
    """Take every 2nd row/column of trailing (H, W); output ceil(n/2).

    An even-size reshape + unit-index select rather than
    `img[..., ::2, ::2]` (the form chosen for the earlier accelerator's
    layouts; not measured on the GPU).  Odd extents are edge-padded by one first (the selected indices
    are identical).
    """
    h, w = img.shape[-2], img.shape[-1]
    lead = [(0, 0)] * (img.ndim - 2)
    if h % 2 or w % 2:
        img = jnp.pad(img, lead + [(0, h % 2), (0, w % 2)], mode="edge")
    oh, ow = (h + 1) // 2, (w + 1) // 2
    x = img.reshape(img.shape[:-2] + (oh, 2, ow, 2))
    return x[..., :, 0, :, 0]


def pyr_down(img: jax.Array) -> jax.Array:
    """One pyramid level: binomial blur + 2x decimation (cv::pyrDown).

    Output spatial dims are ceil(n/2), matching OpenCV.
    """
    return _decimate2(gaussian_blur5(img))


def build_pyramid(img: jax.Array, levels: int) -> list[jax.Array]:
    """Image pyramid [level0=img, level1=half, ...], `levels` entries total."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_gradients(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(dx, dy) Scharr 3x3 gradients with OpenCV's 1/32 scaling."""
    dx = _sep_conv2d(img, _SCHARR_S, _SCHARR_D)
    dy = _sep_conv2d(img, _SCHARR_D, _SCHARR_S)
    return dx, dy




def resize(img: jax.Array, size: tuple[int, int], antialias: bool = True) -> jax.Array:
    """Bilinear resize of (..., H, W) to (..., size[0], size[1]).

    Matches cv::resize INTER_LINEAR for upscaling; with antialias=True the
    downscale behaves like INTER_AREA (what the reference uses for the
    detection-resolution downscale, FrameTracker.cpp:117).
    """
    out_shape = img.shape[:-2] + tuple(size)
    return jax.image.resize(img, out_shape, method="linear", antialias=antialias)


def resize_corner_aligned(img: jax.Array, size: tuple[int, int]) -> jax.Array:
    """Bilinear resize with CORNER alignment: output corner pixels sample the
    input corner pixels exactly (align_corners=True).

    This is the correct interpolation for WarpField grids, whose control
    points are defined corner-aligned over the frame (reference VirtualGrid
    alignment, Math/VirtualGrid.cpp:85-117): output pixel i samples input
    coordinate i*(in-1)/(out-1).  Implemented via jax.image.scale_and_translate
    whose convention is in = (out + 0.5 - t)/s - 0.5, so s=(out-1)/(in-1),
    t = 0.5 - 0.5*s (verified by test_resample.py).
    """
    in_h, in_w = img.shape[-2], img.shape[-1]
    out_h, out_w = size
    if (in_h, in_w) == (out_h, out_w):
        return img
    if in_h == 1 or in_w == 1:
        raise ValueError("corner-aligned resize needs >= 2 samples per axis")
    sh = (out_h - 1) / (in_h - 1)
    sw = (out_w - 1) / (in_w - 1)
    scale = jnp.array([sh, sw], jnp.float32)
    translation = 0.5 - 0.5 * scale
    lead = img.shape[:-2]
    x = img.reshape((-1,) + img.shape[-2:])
    out = jax.image.scale_and_translate(
        x,
        (x.shape[0], out_h, out_w),
        (1, 2),
        scale,
        translation,
        method="linear",
        antialias=False,
    )
    return out.reshape(lead + (out_h, out_w))


def upsample_nearest_int(img: jax.Array, factor: int) -> jax.Array:
    """Replicate each pixel of trailing (H, W) into a factor x factor block.

    Equivalent to nested jnp.repeat, but via broadcast+reshape, which XLA
    fuses into the consumer instead of materializing the repeats.
    """
    *lead, h, w = img.shape
    x = img[..., :, None, :, None]
    x = jnp.broadcast_to(x, (*lead, h, factor, w, factor))
    return x.reshape(*lead, h * factor, w * factor)


def _upsample_linear_axis(img: jax.Array, axis: int, f: int) -> jax.Array:
    """Integer-factor linear upsample along `axis` (half-pixel convention,
    antialias=False), polyphase: per output phase r the source index and
    lerp weight are compile-time constants, so each phase is two unit
    slices + a lerp, interleaved back with stack+reshape (no conv, no
    gather; jax.image.resize would lower this to a convolution)."""
    ndim = img.ndim
    axis = axis % ndim
    n = img.shape[axis]
    pad = [(0, 0)] * ndim
    pad[axis] = (1, 1)
    xp = jnp.pad(img, pad, mode="edge")
    parts = []
    for r in range(f):
        phi = (r + 0.5) / f - 0.5
        o = -1 if phi < 0 else 0
        wgt = phi - o
        sl_a = [slice(None)] * ndim
        sl_a[axis] = slice(o + 1, o + 1 + n)
        sl_b = [slice(None)] * ndim
        sl_b[axis] = slice(o + 2, o + 2 + n)
        a, b = xp[tuple(sl_a)], xp[tuple(sl_b)]
        parts.append(a + (b - a) * jnp.float32(wgt))
    out = jnp.stack(parts, axis=axis + 1)
    shape = list(img.shape)
    shape[axis] = n * f
    return out.reshape(shape)


def upsample_linear_int(img: jax.Array, factor: tuple[int, int]) -> jax.Array:
    """Integer-factor bilinear upsample of trailing (H, W), equal to
    jax.image.resize(..., 'linear', antialias=False) with edge clamping."""
    fy, fx = factor
    out = img
    if fy > 1:
        out = _upsample_linear_axis(out, -2, fy)
    if fx > 1:
        out = _upsample_linear_axis(out, -1, fx)
    return out


@functools.lru_cache(maxsize=None)
def _median_network(n: int) -> tuple[tuple[int, int], ...]:
    """Compare-exchange network selecting the median of n (odd) values:
    Batcher's odd-even mergesort network (correct by the 0-1 principle),
    backward-pruned to the compare-exchanges that can influence output
    n//2.  For n=25 this yields ~100 CEs in place of XLA's variadic
    sort."""

    ces: list[tuple[int, int]] = []

    # Batcher's merge-exchange sorting network (Knuth vol.3 Algorithm 5.2.2M)
    # — valid for arbitrary n, correct by the 0-1 principle.
    t = 1
    while t < n:
        t *= 2
    p = t // 2
    while p >= 1:
        q, r, d = t // 2, 0, p
        while d > 0:
            for i in range(n - d):
                if (i & p) == r and i + d < n:
                    ces.append((i, i + d))
            d, q, r = q - p, q // 2, p
        p //= 2

    # Backward slice to the median output: walk the network in reverse,
    # keeping a CE iff one of its wires is still live, and marking both
    # live when kept.
    needed = {n // 2}
    kept: list[tuple[int, int]] = []
    for a, b in reversed(ces):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.add(a)
            needed.add(b)
    return tuple(reversed(kept))


def median_select(stack: jax.Array) -> jax.Array:
    """Median along axis 0 of an odd-length stack via a pruned
    compare-exchange network — exact (each CE is a min/max pair), all
    elementwise, no sort (`jnp.median` lowers to XLA's variadic sort)."""
    n = stack.shape[0]
    assert n % 2 == 1, "median_select needs an odd stack"
    vals = list(stack)
    for a, b in _median_network(n):
        lo = jnp.minimum(vals[a], vals[b])
        hi = jnp.maximum(vals[a], vals[b])
        vals[a], vals[b] = lo, hi
    return vals[n // 2]


def median_blur(img: jax.Array, ksize: int) -> jax.Array:
    """ksize x ksize median filter (cv::medianBlur), reflect-padded.

    Used by the deblocker's smoothing pass (reference
    Filters/DeblockingFilter.cpp:73-77).  The ksize^2 shifted copies feed a
    median-selection network (see median_select) — static shapes,
    elementwise only.
    """
    r = ksize // 2
    x = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(r, r), (r, r)], mode="reflect")
    h, w = img.shape[-2], img.shape[-1]
    patches = jnp.stack(
        [
            lax.dynamic_slice_in_dim(
                lax.dynamic_slice_in_dim(x, dy, h, axis=-2), dx, w, axis=-1
            )
            for dy in range(ksize)
            for dx in range(ksize)
        ],
        axis=0,
    )
    return median_select(patches)


def avg_pool(img: jax.Array, block: int) -> jax.Array:
    """Non-overlapping block mean over trailing (H, W); H, W must divide."""
    *lead, h, w = img.shape
    x = img.reshape(*lead, h // block, block, w // block, block)
    return x.mean(axis=(-3, -1))


def avg_pool_rw(img: jax.Array, block: int) -> jax.Array:
    """avg_pool via lax.reduce_window.  Numerically the same block mean,
    but layout-robust: the reshape form can force a layout copy when its
    input is a pad/slice of another array, while a windowed reduction
    consumes any layout directly."""
    window = (1,) * (img.ndim - 2) + (block, block)
    s = jax.lax.reduce_window(img, 0.0, jax.lax.add, window, window, "VALID")
    return s * (1.0 / (block * block))
