"""Pixel-format ingest codecs: host video formats -> device YUV planes.

Reference parity: the OBS plugin's FrameIngest subsystem (reference
Modules/OBS-Plugin/Interop/FrameIngest.cpp): one codec per pixel-format
family chosen by `Select` (:38-77) — planar I420/I422/I444 (`I4XXIngest`),
semi-planar NV12 (`NV12Ingest`), packed YUY2/UYVY (`P422Ingest`), and direct
Y800/BGR/RGBA (`DirectIngest`) — uploading planes in bulk, upsampling chroma
to full resolution, and merging to the packed working format
(upload_planes/split/merge, FrameIngest.cpp:145-217+).

Design: the host only reshapes/strides the encoded bytes (numpy views);
every pixel transform (normalization, chroma up/down-sampling, plane merge)
runs on device in one fused jitted program per format — the `device_put` is
the single upload the reference achieves with its chain-start detection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.ops import resample
from livevisionkit_tpu.types import PixelFormat


@functools.partial(jax.jit, static_argnames=("size",))
def _merge_yuv(y: jax.Array, u: jax.Array, v: jax.Array, size) -> jax.Array:
    """Upsample chroma planes to `size` and stack (3, H, W) float [0,1]."""
    h, w = size
    y = y.astype(jnp.float32) * (1.0 / 255.0)
    planes = [y]
    for c in (u, v):
        c = c.astype(jnp.float32) * (1.0 / 255.0)
        if c.shape != (h, w):
            c = resample.resize(c, (h, w), antialias=False)
        planes.append(c)
    return jnp.stack(planes)


def upload_i420(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    ts=0.0,
    alpha: np.ndarray | None = None,
) -> Frame:
    """Planar 4:2:0 (also covers I422/I444: pass the planes as-is; chroma
    upsampling keys off the actual plane shapes, matching I4XXIngest's
    chroma-scaling table, FrameIngest.cpp:478-493).  `alpha` is the optional
    full-resolution alpha plane of the I40A/I42A/YUVA variants
    (FrameIngest.cpp:43-48)."""
    h, w = y.shape
    return Frame.create(
        _merge_yuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), (h, w)),
        timestamp=ts,
        fmt=PixelFormat.YUV,
        alpha=None if alpha is None else _norm_u8(jnp.asarray(alpha)),
    )


# Alpha-bearing planar aliases (reference FrameIngest::Select, :43-48 —
# I40A/I42A/YUVA are I420/I422/I444 plus a full-res alpha plane).
def upload_i40a(y, u, v, a, ts=0.0) -> Frame:
    return upload_i420(y, u, v, ts=ts, alpha=a)


upload_i42a = upload_i40a
upload_yuva = upload_i40a


@jax.jit
def _norm_u8(x: jax.Array) -> jax.Array:
    return x.astype(jnp.float32) * (1.0 / 255.0)


@jax.jit
def _from_ayuv(packed: jax.Array):
    """(H, W, 4) uint8 [A Y U V] -> ((3, H, W) float YUV, (H, W) alpha).

    The reference's P444Ingest uploads the packed texture once and channel-
    mixes on device ({1,0, 2,1, 3,2}, FrameIngest.cpp:676-686, dropping
    alpha); here the single upload is the `device_put` of the packed bytes
    and the mix is a fused transpose-slice — and we keep the alpha plane.
    """
    x = _norm_u8(packed).transpose(2, 0, 1)
    return x[1:4], x[0]


def upload_ayuv(packed: np.ndarray, ts=0.0) -> Frame:
    """Packed 4:4:4 AYUV (reference P444Ingest, FrameIngest.cpp:62-63)."""
    pixels, alpha = _from_ayuv(jnp.asarray(packed))
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.YUV, alpha=alpha)


@jax.jit
def _from_packed4(hwc4: jax.Array):
    """(H, W, 4) uint8 -> ((3, H, W) float colour, (H, W) alpha-channel)."""
    x = _norm_u8(hwc4).transpose(2, 0, 1)
    return x[:3], x[3]


def upload_rgba(hwc: np.ndarray, ts=0.0) -> Frame:
    """Packed RGBA (reference DirectIngest VIDEO_FORMAT_RGBA -> RGB,
    FrameIngest.cpp:718-720; the reference drops alpha, we carry it)."""
    pixels, alpha = _from_packed4(jnp.asarray(hwc))
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.RGB, alpha=alpha)


def upload_bgra(hwc: np.ndarray, ts=0.0) -> Frame:
    """Packed BGRA -> BGR + alpha (DirectIngest, FrameIngest.cpp:721-723)."""
    pixels, alpha = _from_packed4(jnp.asarray(hwc))
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.BGR, alpha=alpha)


def upload_bgrx(hwc: np.ndarray, ts=0.0) -> Frame:
    """Packed BGRX -> BGR; the X byte carries no data and is dropped."""
    pixels, _ = _from_packed4(jnp.asarray(hwc))
    return Frame.create(pixels, timestamp=ts, fmt=PixelFormat.BGR)


def upload_nv12(y: np.ndarray, uv: np.ndarray, ts=0.0) -> Frame:
    """Semi-planar 4:2:0: uv is (H/2, W/2, 2) interleaved (or (H/2, W))."""
    from livevisionkit_tpu.runtime import native_host

    if uv.ndim == 2:
        uv = uv.reshape(uv.shape[0], uv.shape[1] // 2, 2)
    h, w = y.shape
    u, v = native_host.split_nv12(uv)
    return Frame.create(
        _merge_yuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), (h, w)),
        timestamp=ts,
        fmt=PixelFormat.YUV,
    )


def upload_yuy2(packed: np.ndarray, ts=0.0) -> Frame:
    """Packed 4:2:2 YUYV: (H, W, 2) uint8 [Y0 U Y1 V ...] or (H, 2W)."""
    from livevisionkit_tpu.runtime import native_host

    if packed.ndim == 2:
        packed = packed.reshape(packed.shape[0], packed.shape[1] // 2, 2)
    y, u, v = native_host.unpack_yuy2(packed)
    h, w = y.shape
    return Frame.create(
        _merge_yuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), (h, w)),
        timestamp=ts,
        fmt=PixelFormat.YUV,
    )


def upload_uyvy(packed: np.ndarray, ts=0.0) -> Frame:
    """Packed 4:2:2 UYVY."""
    from livevisionkit_tpu.runtime import native_host

    if packed.ndim == 2:
        packed = packed.reshape(packed.shape[0], packed.shape[1] // 2, 2)
    y, u, v = native_host.unpack_uyvy(packed)
    h, w = y.shape
    return Frame.create(
        _merge_yuv(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), (h, w)),
        timestamp=ts,
        fmt=PixelFormat.YUV,
    )


def upload_gray(y: np.ndarray, ts=0.0) -> Frame:
    return Frame.create(
        jnp.asarray(y).astype(jnp.float32)[None] * (1.0 / 255.0),
        timestamp=ts,
        fmt=PixelFormat.GRAY,
    )


def upload_bgr(hwc: np.ndarray, ts=0.0) -> Frame:
    x = jnp.asarray(hwc).astype(jnp.float32).transpose(2, 0, 1) * (1.0 / 255.0)
    return Frame.create(x, timestamp=ts, fmt=PixelFormat.BGR)


@jax.jit
def _split_420(pixels: jax.Array):
    h, w = pixels.shape[-2:]
    y = jnp.clip(pixels[0] * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    u = resample.resize(pixels[1], (h // 2, w // 2), antialias=True)
    v = resample.resize(pixels[2], (h // 2, w // 2), antialias=True)
    u = jnp.clip(u * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    v = jnp.clip(v * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    return y, u, v


def download_i420(frame: Frame) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device YUV frame -> host I420 planes (chroma subsampled on device),
    the reverse of the ingest (FrameIngest.cpp download path)."""
    assert frame.format is PixelFormat.YUV, "download_i420 needs a YUV frame"
    y, u, v = _split_420(frame.pixels)
    return np.asarray(y), np.asarray(u), np.asarray(v)


@jax.jit
def _to_u8(x: jax.Array) -> jax.Array:
    return jnp.clip(x * 255.0 + 0.5, 0, 255).astype(jnp.uint8)


def download_nv12(frame: Frame) -> tuple[np.ndarray, np.ndarray]:
    """Device YUV frame -> host NV12 (y (H,W), uv (H/2,W/2,2) interleaved):
    the download half of the reference's NV12Ingest
    (FrameIngest.cpp:145-217); chroma subsampled on device, interleave on
    host (native fast path)."""
    from livevisionkit_tpu.runtime import native_host

    y, u, v = download_i420(frame)
    return y, native_host.interleave_nv12(u, v)


@jax.jit
def _split_422(pixels: jax.Array):
    """Packed-4:2:2 egress planes: full-res luma + half-width chroma."""
    h, w = pixels.shape[-2:]
    y = jnp.clip(pixels[0] * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    u = resample.resize(pixels[1], (h, w // 2), antialias=True)
    v = resample.resize(pixels[2], (h, w // 2), antialias=True)
    u = jnp.clip(u * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    v = jnp.clip(v * 255.0 + 0.5, 0, 255).astype(jnp.uint8)
    return y, u, v


def download_yuy2(frame: Frame) -> np.ndarray:
    """Device YUV frame -> packed (H, W, 2) YUYV (reference P422Ingest
    download, FrameIngest.cpp:145-217): horizontal chroma subsample on
    device, byte interleave on host (native fast path)."""
    assert frame.format is PixelFormat.YUV, "download_yuy2 needs a YUV frame"
    from livevisionkit_tpu.runtime import native_host

    y, u, v = _split_422(frame.pixels)
    return native_host.pack_yuy2(np.asarray(y), np.asarray(u), np.asarray(v))


def download_uyvy(frame: Frame) -> np.ndarray:
    """Device YUV frame -> packed (H, W, 2) UYVY."""
    assert frame.format is PixelFormat.YUV, "download_uyvy needs a YUV frame"
    from livevisionkit_tpu.runtime import native_host

    y, u, v = _split_422(frame.pixels)
    return native_host.pack_uyvy(np.asarray(y), np.asarray(u), np.asarray(v))


def download_i40a(frame: Frame):
    """Device YUV frame -> host I40A planes (y, u, v, a).  Alpha is opaque
    (255) when the frame carries none — mirroring the reference's
    fill_plane(255) on download into alpha formats (FrameIngest.cpp:198+)."""
    y, u, v = download_i420(frame)
    if frame.alpha is not None:
        a = np.asarray(_to_u8(frame.alpha))
    else:
        a = np.full(y.shape, 255, np.uint8)
    return y, u, v, a


@jax.jit
def _pack_ayuv(pixels: jax.Array, alpha: jax.Array) -> jax.Array:
    return _to_u8(jnp.concatenate([alpha[None], pixels]).transpose(1, 2, 0))


def download_ayuv(frame: Frame) -> np.ndarray:
    """Device YUV frame -> packed (H, W, 4) AYUV.  Carried alpha is written
    back; otherwise opaque, matching P444Ingest::to_obs which mixes the
    3-channel frame behind a constant-255 alpha (FrameIngest.cpp:690-703)."""
    assert frame.format is PixelFormat.YUV, "download_ayuv needs a YUV frame"
    alpha = frame.alpha
    if alpha is None:
        alpha = jnp.ones(frame.pixels.shape[-2:], jnp.float32)
    return np.asarray(_pack_ayuv(frame.pixels, alpha))


@jax.jit
def _pack4(pixels: jax.Array, alpha: jax.Array) -> jax.Array:
    return _to_u8(jnp.concatenate([pixels, alpha[None]]).transpose(1, 2, 0))


def download_rgba(frame: Frame) -> np.ndarray:
    """Device RGB/BGR frame -> packed (H, W, 4) RGBA/BGRA uint8 (alpha last
    for every Direct format, FrameIngest.cpp:747-753)."""
    assert frame.format in (PixelFormat.RGB, PixelFormat.BGR)
    alpha = frame.alpha
    if alpha is None:
        alpha = jnp.ones(frame.pixels.shape[-2:], jnp.float32)
    return np.asarray(_pack4(frame.pixels, alpha))


download_bgra = download_rgba
