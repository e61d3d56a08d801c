"""FrameTracker: per-frame global motion estimation, fully on-device.

Reference parity: ``lvk::FrameTracker`` (reference Vision/FrameTracker.cpp):
downscale to detection resolution (:117), grid FAST detection, sparse
pyramidal LK matching (:140-146), robust global model fit
(estimate_global_motion :325-375; homography only when the feature spread is
uniform enough :37,171), inlier ratio exposed as tracking stability
(:179,461-464), and `nullopt` on low features/uniformity/matches
(:128-132,150-154).

Design: the tracker is a pure function over a carried
``TrackerState`` pytree — previous pyramid + previous feature grid + detector
servo thresholds + PRNG key.  "No motion" is not an optional: the result
carries an `ok` flag and an identity motion, so the whole step stays
fixed-shape inside jit/scan.  The mesh (local motion) path of the reference
(estimate_local_motions, FrameTracker.cpp:200-321) lands in
vision/mesh_motion.py and plugs in behind the same TrackResult type.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.config import FrameTrackerSettings
from livevisionkit_tpu.models.warp_field import WarpField
from livevisionkit_tpu.ops import resample
from livevisionkit_tpu.utils import pytree
from livevisionkit_tpu.vision import features as features_mod
from livevisionkit_tpu.vision import mesh_motion, optical_flow, ransac
from livevisionkit_tpu.vision.features import FeatureGrid
from livevisionkit_tpu.vision.optical_flow import Pyramid


class TrackResult(pytree.PyTreeNode):
    motion: WarpField  # motion field at settings.motion_resolution
    stability: jax.Array  # inlier ratio in [0, 1] (tracking_stability)
    uniformity: jax.Array  # spatial spread quality of tracked points
    ok: jax.Array  # bool: trustworthy estimate this frame
    points: jax.Array  # (G, 2) tracked point positions (detection coords)
    points_valid: jax.Array  # (G,) tracked mask (debug/test-mode overlays)


class TrackerState(pytree.PyTreeNode):
    pyramid: Pyramid
    features: FeatureGrid
    thresholds: jax.Array
    has_prev: jax.Array
    key: jax.Array
    # Previous frame's LOCAL mesh residual (solved mesh minus its global
    # fit; zeros before the first successful solve): CG warm start +
    # temporal-coherence pull target (reference FrameTracker.cpp:274-276;
    # see mesh_motion.estimate for why only the local part carries over).
    prev_mesh: jax.Array  # (2, hm, wm) normalized offsets
    has_prev_mesh: jax.Array  # bool


def init(settings: FrameTrackerSettings) -> TrackerState:
    h, w = settings.detection_size
    zero = jnp.zeros((h, w), jnp.float32)
    g = settings.detector.max_features
    hm, wm = settings.motion_resolution
    return TrackerState(
        pyramid=Pyramid.build(zero, settings.flow.pyramid_levels),
        features=FeatureGrid(
            points=jnp.zeros((g, 2), jnp.float32),
            scores=jnp.zeros((g,), jnp.float32),
            valid=jnp.zeros((g,), jnp.bool_),
        ),
        thresholds=features_mod.initial_thresholds(settings.detector),
        has_prev=jnp.asarray(False),
        key=jax.random.key(0),
        prev_mesh=jnp.zeros((2, hm, wm), jnp.float32),
        has_prev_mesh=jnp.asarray(False),
    )


def track(
    state: TrackerState, gray: jax.Array, settings: FrameTrackerSettings
) -> tuple[TrackerState, TrackResult]:
    """Estimate the motion prev_frame -> `gray` and update tracking state.

    gray: (H, W) full-resolution luma in [0, 1].
    """
    det_size = settings.detection_size
    det = resample.resize(gray, det_size, antialias=True)
    pyr = Pyramid.build(det, settings.flow.pyramid_levels)

    # Match previous features into this frame (FrameTracker.cpp:140-149).
    new_pts, tracked = optical_flow.track(
        state.pyramid,
        pyr,
        state.features.points,
        state.features.valid & state.has_prev,
        settings.flow,
    )

    uniformity = features_mod.distribution_quality(new_pts, tracked, det_size)
    use_h = uniformity > settings.motion.min_homography_uniformity

    key, sub = jax.random.split(state.key)
    est = ransac.estimate(
        state.features.points,
        new_pts,
        tracked,
        sub,
        settings.motion,
        use_homography=use_h,
        min_samples=settings.min_motion_samples,
    )

    ok = (
        est.ok
        & state.has_prev
        & (uniformity >= settings.min_uniformity)
        & (jnp.sum(tracked.astype(jnp.int32)) >= settings.min_motion_samples)
    )
    if tuple(settings.motion_resolution) == (2, 2):
        # Global (homography) mode: the reference's 2x2-mesh path.
        motion = WarpField.from_homography(
            est.homography, settings.motion_resolution, det_size
        )
    else:
        # Mesh mode (estimate_local_motions, FrameTracker.cpp:200-321):
        # the global fit anchors the solve; the CG warm-starts from — and is
        # temporally smoothed toward — the previous frame's mesh
        # (FrameTracker.cpp:274-276), zero-weighted until one exists.
        glob = WarpField.from_homography(
            est.homography, settings.motion_resolution, det_size
        )
        motion, _, _ = mesh_motion.estimate(
            state.features.points,
            new_pts,
            tracked.astype(jnp.float32),
            glob,
            det_size,
            settings.mesh,
            prev_local=WarpField(offsets=state.prev_mesh),
            prev_weight_scale=state.has_prev_mesh.astype(jnp.float32),
        )
        local_residual = motion.offsets - glob.offsets
    identity = WarpField.identity(settings.motion_resolution)
    if tuple(settings.motion_resolution) == (2, 2):
        local_residual = jnp.zeros_like(identity.offsets)
    motion = WarpField(
        offsets=jnp.where(ok, motion.offsets, identity.offsets)
    )
    result = TrackResult(
        motion=motion,
        stability=jnp.where(ok, est.stability, 0.0),
        uniformity=uniformity,
        ok=ok,
        points=new_pts,
        points_valid=tracked,
    )

    # Detection on the current frame for the next call (FrameTracker.cpp
    # detect-after-track ordering), with tracked inliers re-seeded into
    # their new cells with priority (inlier propagation,
    # FrameTracker.cpp:183-193, FeatureDetector.cpp:182-205).
    propagated = features_mod.rebin(
        new_pts,
        state.features.scores,
        tracked & est.inliers & ok,
        settings.detector,
        det_size,
    )
    feats, thresholds = features_mod.detect(
        det, state.thresholds, settings.detector, prev_features=propagated
    )
    new_state = TrackerState(
        pyramid=pyr,
        features=feats,
        thresholds=thresholds,
        has_prev=jnp.asarray(True),
        key=key,
        # Gated on ok (zero local residual on failure): after a tracking
        # discontinuity the next solve re-anchors on its global fit,
        # mirroring the reference's restart semantics.
        prev_mesh=jnp.where(ok, local_residual, jnp.zeros_like(local_residual)),
        has_prev_mesh=ok,
    )
    return new_state, result
