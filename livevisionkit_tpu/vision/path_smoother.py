"""PathSmoother: sliding-window camera-trajectory smoothing.

Reference parity: ``lvk::PathSmoother`` (reference Vision/PathSmoother.cpp):
a 2N+1 window of motions integrated into path positions (:55-73), convolved
with an **adaptive Gaussian** whose strength is servo-controlled by a
hysteresis + EMA of the drift error against the corrective limits (:94-132),
corrections clamped into the corrective margins (:121-125), and a
predictive_samples output delay (:149-152).

Design: positions are WarpFields (tensor algebra), the window is
a StreamBuffer whose Gaussian convolution is a single rolled-weight
tensordot, and the sigma servo is three scalar carries — the whole smoother
is O(window * field) tensor math inside the jitted step.  During warm-up
(t < 2N) the window is asymmetric around the anchor and the Gaussian is
renormalized over the valid entries, so corrections start flowing as soon
as the output delay (N frames) is met instead of waiting for a full window.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.config import PathSmootherSettings
from livevisionkit_tpu.data.stream_buffer import StreamBuffer
from livevisionkit_tpu.models.warp_field import WarpField
from livevisionkit_tpu.utils import pytree


class SmootherState(pytree.PyTreeNode):
    positions: StreamBuffer  # window of integrated path positions (WarpField)
    position: WarpField  # running integrated camera position
    smoothing: jax.Array  # sigma servo factor in [0, 1] (1 = max smoothing)
    drift_ema: jax.Array  # EMA of |correction| / corrective_limit


def init(
    settings: PathSmootherSettings, field_shape: tuple[int, int]
) -> SmootherState:
    template = WarpField.identity(field_shape)
    return SmootherState(
        positions=StreamBuffer.create(template, settings.window),
        position=template,
        smoothing=jnp.asarray(1.0, jnp.float32),
        drift_ema=jnp.asarray(0.0, jnp.float32),
    )


def next_correction(
    state: SmootherState, motion: WarpField, settings: PathSmootherSettings
) -> tuple[SmootherState, WarpField, jax.Array]:
    """Advance the path by `motion`; return (state, correction, ready).

    The correction is the warp taking the frame at the window ANCHOR
    (predictive_samples frames ago) onto the smoothed trajectory — apply it
    to the delayed frame.  `ready` goes true once the anchor frame exists.
    """
    n = settings.predictive_samples
    position = state.position + motion
    buf = state.positions.push(position)

    count = buf.count
    anchor = count - 1 - n  # logical index of the frame being output
    ready = anchor >= 0
    anchor_c = jnp.maximum(anchor, 0)

    # Adaptive Gaussian over logical window positions, masked to valid
    # entries (PathSmoother.cpp:94-108).
    sigma = settings.min_sigma + state.smoothing * (
        settings.max_sigma - settings.min_sigma
    )
    idx = jnp.arange(settings.window, dtype=jnp.float32)
    w = jnp.exp(-0.5 * ((idx - anchor_c.astype(jnp.float32)) / sigma) ** 2)
    w = w * buf.window_valid_mask()
    w = w / jnp.maximum(jnp.sum(w), 1e-6)

    smoothed: WarpField = buf.convolve(w)
    at_anchor: WarpField = buf.get(anchor_c)
    raw = smoothed - at_anchor

    # Drift servo: EMA of the worst-axis correction magnitude relative to the
    # corrective limits drives the smoothing strength through a hysteresis
    # band (PathSmoother.cpp:111-132).
    limit = settings.corrective_limit
    drift = jnp.max(jnp.abs(raw.offsets)) / limit
    ema = state.drift_ema + settings.response_rate * (drift - state.drift_ema)
    target = jnp.where(
        ema > settings.drift_high,
        0.0,
        jnp.where(ema < settings.drift_low, 1.0, state.smoothing),
    )
    smoothing = state.smoothing + settings.response_rate * (target - state.smoothing)

    correction = raw.clamp(limit, limit)

    new_state = SmootherState(
        positions=buf,
        position=position,
        smoothing=smoothing,
        drift_ema=ema,
    )
    return new_state, correction, ready


def scene_margins(settings: PathSmootherSettings) -> float:
    """Stable-region margin (fraction of frame) guaranteed never to expose
    missing content: equal to the corrective limit (reference
    StabilizationFilter::stable_region, StabilizationFilter.cpp:199-205)."""
    return settings.corrective_limit
