"""DeblockingFilter: adaptive macroblock de-blocking.

Reference parity: ``lvk::DeblockingFilter`` (reference Filters/
DeblockingFilter.cpp:48-112): operate on the whole-macroblock region only
(:64-71); smooth frame = upscale(medianBlur(downscale(frame, 1/scaling), k))
(:73-77); blockiness measure = per-block mean abs-deviation of luma from the
block mean (:79-84, via the NEAREST-upsampled "maximal blocking artifact"
reference frame); multi-level threshold -> float keep map (:86-95, keep =
min(floor(measure_8bit), levels)/levels so flat blocks smooth fully);
cv::blendLinear original vs smoothed (:100-107).

Every stage is a static-shape XLA op — integer-factor INTER_AREA resizes
are exact block means (avg_pool), the median is a selection network over
k^2 shifted stacks, and the whole filter fuses into a few elementwise
passes.  The partial-block border passes through untouched, like the
reference's crop-not-pad choice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax.numpy as jnp

from livevisionkit_tpu.config import DeblockingFilterSettings
from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import VideoFilter
from livevisionkit_tpu.ops import color as color_ops
from livevisionkit_tpu.ops import resample


@dataclass(frozen=True)
class DeblockingFilter(VideoFilter):
    settings: DeblockingFilterSettings = field(
        default_factory=DeblockingFilterSettings
    )

    def step(self, state: Any, frame: Frame, *, drain: bool = False) -> tuple[Any, Frame]:
        s = self.settings
        block = s.block_size
        c, h, w = frame.pixels.shape
        fh, fw = (h // block) * block, (w // block) * block  # whole blocks
        # Pad UP to whole macroblocks instead of cropping down: partial
        # border blocks still pass through untouched (keep forced to 1
        # below — the reference's crop-not-pad semantics, :64-71), but the
        # whole pipeline stays one fused full-frame elementwise pass (a
        # crop + `.at[:, :fh, :fw].set` splice would force full-frame
        # materialization between every stage).
        ph, pw = -(-h // block) * block, -(-w // block) * block
        px = jnp.pad(
            frame.pixels, ((0, 0), (0, ph - h), (0, pw - w)), mode="edge"
        )

        # Smooth frame (:73-77). The padded region is divisible by the
        # scaling (block 16 % scaling 4 == 0), so INTER_AREA == avg_pool.
        # Pooling flavour by producer (see DeblockingFilterSettings.
        # pool_form): the reshape form is only fast when XLA fuses the
        # pools into a cheap producer — standalone unpadded frames; behind a
        # pad (1080p) or a real upstream filter output (any chain) it can
        # force layout copies.  reduce_window consumes any layout directly.
        form = s.pool_form
        if form == "auto":
            form = "reshape" if (ph == h and pw == w) else "reduce_window"
        pool = (
            resample.avg_pool if form == "reshape" else resample.avg_pool_rw
        )
        small = pool(px, s.filter_scaling)
        small = resample.median_blur(small, s.filter_size)
        smooth = resample.upsample_linear_int(
            small, (s.filter_scaling, s.filter_scaling)
        )

        # Blockiness measure (:79-84): per-block mean |luma - block mean|.
        gray = color_ops.luma(px, frame.format)
        block_mean = pool(gray, block)
        reference = resample.upsample_nearest_int(block_mean, block)
        measure = pool(jnp.abs(gray - reference), block)

        # Multi-level threshold -> keep map (:86-95). The reference
        # thresholds the 8-bit measure at integer levels l=0..L-1 and
        # overwrites with (l+1)/L, i.e. keep = min(floor(m_8bit), L)/L.
        levels = s.detection_levels
        keep_blocks = jnp.minimum(jnp.floor(measure * 255.0), levels) / levels
        keep = resample.upsample_linear_int(keep_blocks, (block, block))
        keep = keep[:h, :w]
        smooth = smooth[:, :h, :w]
        # Partial border blocks pass through untouched (:64-71).
        if fh < h or fw < w:
            yy = jnp.arange(h).reshape(-1, 1)
            xx = jnp.arange(w).reshape(1, -1)
            keep = jnp.where((yy >= fh) | (xx >= fw), 1.0, keep)

        # Adaptive blend (:100-107).
        out = frame.pixels * keep[None] + smooth * (1.0 - keep[None])
        return state, frame.with_pixels(out)

    def influence_map(self, frame: Frame) -> jnp.ndarray:
        """(H, W) smoothing weight in [0,1] for debug overlays (reference
        draw_influence, DeblockingFilter.cpp:114-131).  0 outside the
        filterable region."""
        s = self.settings
        block = s.block_size
        _, h, w = frame.pixels.shape
        fh, fw = (h // block) * block, (w // block) * block
        gray = color_ops.luma(frame.pixels[:, :fh, :fw], frame.format)
        block_mean = resample.avg_pool_rw(gray, block)
        reference = resample.upsample_nearest_int(block_mean, block)
        measure = resample.avg_pool_rw(jnp.abs(gray - reference), block)
        keep_blocks = (
            jnp.minimum(jnp.floor(measure * 255.0), s.detection_levels)
            / s.detection_levels
        )
        keep = resample.upsample_linear_int(keep_blocks, (block, block))
        return jnp.zeros((h, w), keep.dtype).at[:fh, :fw].set(1.0 - keep)
