"""Frame: the device-resident video frame value type.

Reference parity: ``lvk::VideoFrame`` (reference Data/VideoFrame.hpp:25-82) — a
GPU-resident image + nanosecond timestamp + pixel-format tag, with
metadata-preserving ops and an exhaustive colour-conversion matrix
(Data/VideoFrame.cpp:170-306) plus a zero-copy ``viewAsFormat``
(Data/VideoFrame.cpp:310-317).

Design decisions (not a port):

* **Planar channel-first layout** ``(C, H, W)`` float32 in [0, 1].  The
  minor (W) dimension is a full image row, so every elementwise op runs over
  long contiguous rows instead of strided 3-channel pixels.  The reference's
  packed-UMat formats exist because OpenCV/OBS interop demanded them; here
  the host I/O layer (runtime/) converts once at the boundary.
* **Pytree value type**: a `Frame` is an immutable pytree
  (`utils.pytree.PyTreeNode`) so it
  flows through `jit`/`scan`/`shard_map` carries without special casing.
* **Validity flag instead of "empty frame"**: the reference signals
  end-of-chain / warm-up delay with empty cv::Mats (Filters/CompositeFilter
  .cpp:60-88).  Dynamic emptiness is impossible under XLA's static shapes, so
  a Frame carries an on-device boolean `valid`; the streaming runtime reads it
  on the host to decide whether to emit.
* **Timestamps** are float64-free (JAX x64 off): we carry seconds as float32,
  enough for >1 h streams at 60 fps matching precision.
* **Alpha as a separate plane**: the reference's alpha-bearing formats
  (VideoFrame.hpp:27-31 RGBA/BGRA; FrameIngest.cpp:38-77 I40A/I42A/YUVA/AYUV)
  never process alpha — LVK uploads only the colour planes and leaves the
  alpha plane of the OBS frame untouched.  Here a Frame optionally carries a
  full-resolution ``alpha`` plane (H, W) so standalone pipelines can preserve
  it end to end; colour conversion never touches it, shape-changing filters
  resample it, and the stabilizer warps it together with the colour planes
  (one shared gather) — strictly more correct than the reference's
  leave-in-place for compositing use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.ops import color as color_ops
from livevisionkit_tpu.types import PixelFormat
from livevisionkit_tpu.utils import pytree


class Frame(pytree.PyTreeNode):
    """An immutable device-resident video frame.

    Attributes:
      pixels: ``(C, H, W)`` float32 planes in [0, 1].
      timestamp: scalar float32 seconds since stream start.
      valid: scalar bool — False during filter warm-up delay (the reference's
        "empty output breaks the chain" protocol, CompositeFilter.cpp:75-80).
      alpha: optional ``(H, W)`` float32 alpha plane in [0, 1] (None for the
        common opaque streams; presence is static pytree structure).
      format: static PixelFormat tag (not traced).
    """

    pixels: jax.Array
    timestamp: jax.Array
    valid: jax.Array
    alpha: jax.Array | None = None
    format: PixelFormat = pytree.field(static=True, default=PixelFormat.UNKNOWN)

    # ---- metadata ----------------------------------------------------------

    @property
    def height(self) -> int:
        return self.pixels.shape[-2]

    @property
    def width(self) -> int:
        return self.pixels.shape[-1]

    @property
    def channels(self) -> int:
        return self.pixels.shape[-3]

    @property
    def size(self) -> tuple[int, int]:
        """(height, width)."""
        return (self.height, self.width)

    # ---- constructors ------------------------------------------------------

    @classmethod
    def create(
        cls,
        pixels: jax.Array,
        timestamp: float | jax.Array = 0.0,
        fmt: PixelFormat = PixelFormat.RGB,
        valid: bool | jax.Array = True,
        alpha: jax.Array | None = None,
    ) -> "Frame":
        if pixels.ndim == 2:  # allow (H, W) shorthand for grayscale
            pixels = pixels[None]
            fmt = PixelFormat.GRAY
        return cls(
            pixels=pixels.astype(jnp.float32),
            timestamp=jnp.asarray(timestamp, jnp.float32),
            valid=jnp.asarray(valid, jnp.bool_),
            alpha=None if alpha is None else alpha.astype(jnp.float32),
            format=fmt,
        )

    def with_pixels(self, pixels: jax.Array, fmt: PixelFormat | None = None) -> "Frame":
        """Metadata-preserving pixel replacement (reference VideoFrame
        clone/copyTo semantics, Data/VideoFrame.cpp:78-120).  A carried alpha
        plane follows resolution changes via bilinear resample, so
        shape-changing filters (ScalingFilter) preserve it without
        special-casing."""
        alpha = self.alpha
        if alpha is not None and pixels.shape[-2:] != alpha.shape:
            from livevisionkit_tpu.ops import resample

            alpha = resample.resize(alpha, pixels.shape[-2:], antialias=False)
        return self.replace(
            pixels=pixels, alpha=alpha, format=self.format if fmt is None else fmt
        )

    # ---- colour conversion -------------------------------------------------

    def reformat(self, target: PixelFormat) -> "Frame":
        """Full colour conversion (reference ``reformatTo``,
        Data/VideoFrame.cpp:170-306).  All conversions are 3x3 matrix ops +
        offsets on the planar tensor (BT.601 full-range, matching OpenCV's
        cvtColor constants used by the reference)."""
        if target is self.format:
            return self
        return self.replace(
            pixels=color_ops.convert(self.pixels, self.format, target), format=target
        )

    def luma(self) -> jax.Array:
        """(H, W) luminance plane — the tracking input.  The reference views
        YUV frames as GRAY zero-copy (``viewAsFormat``, VideoFrame.cpp:310-317)
        for FrameTracker; here GRAY/YUV take plane 0 directly and RGB/BGR pay
        one fused dot."""
        if self.format in (PixelFormat.GRAY, PixelFormat.YUV):
            return self.pixels[0]
        return color_ops.luma(self.pixels, self.format)
