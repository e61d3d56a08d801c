"""StabilizationFilter: the end-to-end video stabilizer.

Reference parity: ``lvk::StabilizationFilter`` (reference
Filters/StabilizationFilter.cpp): GRAY view -> FrameTracker::track (:98),
QA policy — scene-quality EMA and a trust factor stepped toward 0/1 with
motion scaled by trust (`motion *= m_TrustFactor`, :101-115, rates :29-30,
instant drop on a tracking discontinuity), frame pushed into the delay
buffer (:118), PathSmoother correction applied to the delayed frame via the
warp (:117-134), optional stable-region crop, and a bypass path that only
maintains delay/crop when disabled (:77-95); `stable_region()` (:199-205).

Design: ONE pure step `(state, frame) -> (state, frame)` holding
tracker pyramid/features, the trajectory window, the frame delay queue and
the QA scalars in a single carry pytree — jit once, then drive it from the
streaming runtime (live mode) or `lax.scan` (offline mode).  Invalid input
frames (upstream warm-up) pass through the delay queue but freeze the
tracking state, so a chain of delay filters composes correctly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp

from livevisionkit_tpu.config import StabilizationFilterSettings
from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.data.stream_buffer import StreamBuffer
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter, where_state
from livevisionkit_tpu.models.homography import Homography
from livevisionkit_tpu.models.warp_field import WarpField
from livevisionkit_tpu.utils import pytree
from livevisionkit_tpu.vision import frame_tracker, path_smoother


def _quantize_u8(frame: Frame) -> Frame:
    """Frame payload -> u8 for delay-queue storage (round, not truncate)."""
    q = lambda x: jnp.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)  # noqa: E731
    return frame.replace(
        pixels=q(frame.pixels),
        alpha=None if frame.alpha is None else q(frame.alpha),
    )


def _dequantize_u8(frame: Frame) -> Frame:
    d = lambda x: x.astype(jnp.float32) * (1.0 / 255.0)  # noqa: E731
    return frame.replace(
        pixels=d(frame.pixels),
        alpha=None if frame.alpha is None else d(frame.alpha),
    )


class StabilizerState(pytree.PyTreeNode):
    tracker: frame_tracker.TrackerState
    smoother: path_smoother.SmootherState
    frames: StreamBuffer  # delay queue of Frames (capacity N+1)
    scene_quality: jax.Array  # EMA of tracking stability (observability + QA)
    trust: jax.Array  # motion trust factor in [0, 1]
    # Last-frame diagnostics (observability: the reference exposes these via
    # tracking_stability()/test-mode HUD, VSFilter.cpp:368-383).
    stability: jax.Array
    uniformity: jax.Array
    correction: WarpField  # warp applied to the last output (evaluation/HUD)


@dataclass(frozen=True)
class StabilizationFilter(VideoFilter):
    settings: StabilizationFilterSettings = field(
        default_factory=StabilizationFilterSettings
    )
    enabled: bool = True  # bypass path: maintain delay/crop only (:77-95)
    # Test mode: draw tracked points, the motion field, and the stable
    # region on outputs (reference test-mode draws, StabilizationFilter
    # .cpp:163-188, VSFilter.cpp:368-383).
    debug: bool = False

    # ------------------------------------------------------------------

    def init(self, spec: FrameSpec) -> StabilizerState:
        s = self.settings
        # Delay-queue payload dtype: uint8 by default — the reference keeps
        # frames as 8-bit UMats (Data/VideoFrame.cpp), and the f32 queue's
        # HBM traffic dominates the step at high batched stream counts.
        template = Frame.create(
            jnp.zeros((spec.channels, spec.height, spec.width), jnp.float32),
            fmt=spec.format,
            valid=False,
            alpha=jnp.zeros((spec.height, spec.width), jnp.float32)
            if spec.has_alpha
            else None,
        )
        if s.queue_dtype == "uint8":
            template = template.replace(
                pixels=template.pixels.astype(jnp.uint8),
                alpha=None if template.alpha is None
                else template.alpha.astype(jnp.uint8),
            )
        return StabilizerState(
            tracker=frame_tracker.init(s.tracker),
            smoother=path_smoother.init(s.smoother, s.tracker.motion_resolution),
            frames=StreamBuffer.create(template, s.smoother.predictive_samples + 1),
            # Optimistic seed: a fresh/restarted stream assumes a trackable
            # scene (reference restart(), StabilizationFilter.cpp:139-144).
            scene_quality=jnp.asarray(1.0, jnp.float32),
            trust=jnp.asarray(0.0, jnp.float32),
            stability=jnp.asarray(0.0, jnp.float32),
            uniformity=jnp.asarray(0.0, jnp.float32),
            correction=WarpField.identity(s.tracker.motion_resolution),
        )

    @property
    def delay(self) -> int:
        return self.settings.smoother.predictive_samples

    def stable_region_margin(self) -> float:
        """Fraction of the frame on each side that may be consumed by
        corrections (reference stable_region, StabilizationFilter.cpp:199-205)."""
        return path_smoother.scene_margins(self.settings.smoother)

    # ------------------------------------------------------------------

    def _crop_field(self, field_shape: tuple[int, int], size) -> WarpField:
        """Zoom-into-stable-region warp (output(u) = corrected(z(u)))."""
        m = self.stable_region_margin()
        s = 1.0 - 2.0 * m
        h, w = size
        z = Homography.from_similarity(
            jnp.float32(s),
            jnp.float32(0.0),
            jnp.float32(m * (w - 1)),
            jnp.float32(m * (h - 1)),
        )
        # from_homography builds o = H^-1(u) - u; we need o = z(u) - u.
        return WarpField.from_homography(z.inverse(), field_shape, size)

    def step(
        self, state: StabilizerState, frame: Frame, *, drain: bool = False
    ) -> tuple[Any, Frame]:
        s = self.settings
        # Temporal machinery (delay queue + trajectory window) advances on
        # valid frames — and on drain bubbles too, with identity motion (see
        # VideoFilter.step; `drain` may be a traced per-stream bool, so an
        # EOF'd slot in a serving batch drains its residue while live slots
        # continue).  A non-drain invalid frame (stall tick / upstream
        # warm-up) freezes both IN LOCKSTEP: the smoother's anchor index and
        # the delay queue must stay paired, or real frames pop while `ready`
        # lags and are dropped (r5 soak bug).
        advance = jnp.logical_or(frame.valid, jnp.asarray(drain, jnp.bool_))

        if self.enabled:
            # ---- track (on valid frames only) -----------------------------
            tracker_state, result = frame_tracker.track(
                state.tracker, frame.luma(), s.tracker
            )
            tracker_state = where_state(frame.valid, tracker_state, state.tracker)
            ok = result.ok & frame.valid

            # ---- QA: scene-quality EMA + trust servo ----------------------
            # (StabilizationFilter.cpp:101-115: tracking quality below the
            # discontinuity threshold -> trust 0 instantly; a persistently
            # low scene-quality EMA ramps trust toward 0 — the gate at :109
            # that suppresses stabilization on untrackable scenes; otherwise
            # trust steps toward 1.  Motion is scaled by trust.)
            scene_quality = state.scene_quality + s.scene_quality_rate * (
                result.stability - state.scene_quality
            )
            scene_quality = jnp.where(frame.valid, scene_quality, state.scene_quality)
            # A tracker abort (ok=False: too few features/matches/uniformity)
            # or sub-threshold quality is a discontinuity on a REAL frame;
            # invalid upstream frames (warm-up bubbles) freeze trust instead.
            discontinuity = (~result.ok) | (
                result.stability < s.min_tracking_quality
            )
            trust = jnp.where(
                scene_quality < s.min_scene_quality,
                jnp.maximum(state.trust - s.trust_step, 0.0),
                jnp.minimum(state.trust + s.trust_step, 1.0),
            )
            trust = jnp.where(discontinuity, 0.0, trust)
            trust = jnp.where(frame.valid, trust, state.trust)
            motion = result.motion * trust
        else:
            tracker_state = state.tracker
            scene_quality = state.scene_quality
            trust = jnp.asarray(0.0, jnp.float32)
            motion = WarpField.identity(s.tracker.motion_resolution)

        # ---- path smoothing ----------------------------------------------
        # Invalid frames carry identity motion (the tracker result on a
        # bubble is garbage): on a drain bubble the window advances flat; on
        # a frozen tick the smoother state is reverted below anyway.
        motion = where_state(
            frame.valid, motion,
            WarpField.identity(s.tracker.motion_resolution),
        )
        smoother_state, correction, ready = path_smoother.next_correction(
            state.smoother, motion, s.smoother
        )
        smoother_state = where_state(advance, smoother_state, state.smoother)

        # ---- delay queue --------------------------------------------------
        # u8 storage quantizes on push / dequantizes on pop (exactly the
        # reference's 8-bit frame storage); the cast must be explicit — a
        # raw float->u8 astype would truncate [0,1] floats to zero.
        # The push is `advance`-gated: stall bubbles land in the dead slot
        # (already-emitted / free) without moving the window, so oldest()
        # returns the bubble itself (-> invalid output tick) and no queued
        # real frame is lost.
        if s.queue_dtype == "uint8":
            frames = state.frames.push(_quantize_u8(frame), advance=advance)
            delayed_q: Frame | None = frames.oldest()  # raw u8 payload
            delayed: Frame = _dequantize_u8(delayed_q)
        else:
            frames = state.frames.push(frame, advance=advance)
            delayed_q = None
            delayed = frames.oldest()
        queue_full = frames.is_full()

        # ---- corrective warp ---------------------------------------------
        warp = correction
        if s.crop_output:
            warp = correction.compose(
                self._crop_field(warp.field_shape, delayed.size)
            )
        out_alpha = delayed.alpha
        if self.enabled or s.crop_output:
            # warp_filter="easu" is reference parity: every corrective warp
            # there goes through the fused EASU kernel (WarpMesh.cpp:183-223
            # → FSR.cl:362-403).  fmt drives EASU's luma selection.
            #
            # With the u8 delay queue the warp consumes the RAW u8 planes and
            # produces u8 (dequantized after) — exactly the reference, which
            # warps 8-bit UMats into 8-bit outputs, and 4x less HBM traffic
            # through the warp's pad + block DMAs (the S=8 serving shape's
            # dominant cost, r4).
            if delayed_q is not None:
                wsrc = delayed_q.pixels
                walpha = delayed_q.alpha
                undo = _dequantize_u8
            else:
                wsrc = delayed.pixels
                walpha = delayed.alpha
                undo = lambda f: f  # noqa: E731
            if out_alpha is None:
                warped = warp.apply(
                    wsrc, fill=0.0,
                    filter_mode=s.warp_filter, fmt=delayed.format,
                )
                out_pixels = undo(delayed.replace(pixels=warped)).pixels
            else:
                # Warp alpha together with the colour planes: one shared
                # gather (the reference leaves alpha untouched in the OBS
                # frame, FrameIngest DirectIngest notes; warping it is the
                # correct behaviour for standalone compositing output).
                warped = warp.apply(
                    jnp.concatenate([wsrc, walpha[None]]),
                    fill=0.0, filter_mode=s.warp_filter, fmt=delayed.format,
                )
                wf = undo(
                    delayed.replace(pixels=warped[:-1], alpha=warped[-1])
                )
                out_pixels, out_alpha = wf.pixels, wf.alpha
        else:
            out_pixels = delayed.pixels

        if self.debug and self.enabled:
            out_pixels = self._draw_debug(out_pixels, delayed.format, result, warp)
        out = delayed.replace(
            pixels=out_pixels,
            alpha=out_alpha,
            valid=delayed.valid & queue_full & ready,
        )
        new_state = StabilizerState(
            tracker=tracker_state,
            smoother=smoother_state,
            frames=frames,
            scene_quality=scene_quality,
            trust=trust,
            stability=result.stability if self.enabled else state.stability,
            uniformity=result.uniformity if self.enabled else state.uniformity,
            correction=correction,
        )
        return new_state, out

    def _draw_debug(self, pixels, fmt, result, warp):
        """Test-mode overlays (reference StabilizationFilter.cpp:163-188)."""
        from livevisionkit_tpu.ops import drawing

        s = self.settings
        _, h, w = pixels.shape
        dh, dw = s.tracker.detection_size
        pts = result.points * jnp.array([(w - 1) / (dw - 1), (h - 1) / (dh - 1)])
        pixels = drawing.draw_crosses(
            pixels, pts, result.points_valid, drawing.colour("green", fmt)
        )
        pixels = drawing.draw_motion_field(
            pixels, result.motion.offsets, drawing.colour("magenta", fmt)
        )
        m = self.stable_region_margin()
        pixels = drawing.draw_rect(
            pixels, (m, m), (1 - m, 1 - m), drawing.colour("yellow", fmt)
        )
        return pixels
