"""Grid-based adaptive FAST corner detection — fully dense, fixed-shape.

Reference parity: ``lvk::FeatureDetector`` (reference Vision/FeatureDetector
.cpp): FAST corners per detection region with a servo-controlled threshold
(:159-163, step/clamp :28-30), pushed through a grid suppression map keeping
one maximal corner per cell (:138-157), plus a spatial distribution-quality
measure (:174, SpatialMap.tpp:589-625).

Design (the reference's CPU keypoint loop inverted):
  * FAST-9/16 is evaluated **densely at every pixel** as 16 shifted
    compares; the contiguous-arc test uses log-composed rolls (4 AND-rolls
    instead of 16x9 tests).  No keypoint lists exist at any point.
  * The suppression grid IS the output: a (grid_h*grid_w)-slot feature set
    produced by a per-cell argmax (reshape + reduce).  Empty cells are
    invalid slots — downstream consumers carry the mask, never a count.
  * The per-region threshold servo is a tiny carried tensor, updated from
    per-region valid counts with a one-hot contraction.

The FAST corner *score* here is the summed ring excess beyond the threshold
(bright and dark arcs), not OpenCV's exact max-threshold score; it only
ranks corners within a cell, and this variant is branch-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.config import FeatureDetectorSettings
from livevisionkit_tpu.utils import pytree

# Bresenham radius-3 circle, circular order, as (dy, dx).
_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class FeatureGrid(pytree.PyTreeNode):
    """Fixed-capacity feature set: one slot per suppression-grid cell."""

    points: jax.Array  # (G, 2) float32 (x, y) at detection resolution
    scores: jax.Array  # (G,) float32, 0 for empty slots
    valid: jax.Array  # (G,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))


def _ring_stack(padded: jax.Array, h: int, w: int) -> jax.Array:
    """(16, H, W) ring-pixel views of an image padded by 3."""
    return jnp.stack(
        [padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in _RING]
    )


def _contiguous_arc(b: jax.Array, arc_length: int) -> jax.Array:
    """Any contiguous circular run of >= arc_length Trues along axis 0 (=16).

    Log-composition: arc2 = b & roll(b,-1); arc4 = arc2 & roll(arc2,-2); ...
    """
    assert arc_length == 9, "log-roll composition below is specialized to 9"
    a2 = b & jnp.roll(b, -1, axis=0)
    a4 = a2 & jnp.roll(a2, -2, axis=0)
    a8 = a4 & jnp.roll(a4, -4, axis=0)
    a9 = a8 & jnp.roll(b, -8, axis=0)
    return jnp.any(a9, axis=0)


def fast_score_map(
    gray: jax.Array, threshold_map: jax.Array, arc_length: int = 9
) -> jax.Array:
    """Dense FAST-9/16 corner score at every pixel; 0 = not a corner.

    threshold_map: per-pixel intensity threshold (broadcastable to gray).
    """
    h, w = gray.shape
    padded = jnp.pad(gray, 3, mode="edge")
    ring = _ring_stack(padded, h, w)  # (16, H, W)
    t = threshold_map
    bright = ring > gray + t
    dark = ring < gray - t
    is_corner = _contiguous_arc(bright, arc_length) | _contiguous_arc(dark, arc_length)
    excess_b = jnp.sum(jnp.maximum(ring - gray - t, 0.0), axis=0)
    excess_d = jnp.sum(jnp.maximum(gray - ring - t, 0.0), axis=0)
    score = jnp.maximum(excess_b, excess_d)
    # A 3-pixel border can never host a full ring: suppress it.
    border = jnp.zeros_like(gray, jnp.bool_).at[3:-3, 3:-3].set(True)
    return jnp.where(is_corner & border, score, 0.0)


def _region_threshold_map(
    thresholds: jax.Array, size: tuple[int, int]
) -> jax.Array:
    """Upsample the (R_r, R_c) per-region thresholds to a per-pixel map."""
    rr, rc = thresholds.shape
    h, w = size
    return jnp.repeat(
        jnp.repeat(thresholds, -(-h // rr), axis=0)[:h],
        -(-w // rc),
        axis=1,
    )[:, :w]


def _region_index_of_cells(settings: FeatureDetectorSettings) -> jax.Array:
    """(G,) servo-region index of each suppression-grid cell."""
    gr, gc = settings.grid_shape
    rr, rc = settings.region_shape
    cell_r = jax.lax.broadcasted_iota(jnp.int32, (gr, gc), 0)
    cell_c = jax.lax.broadcasted_iota(jnp.int32, (gr, gc), 1)
    reg = (cell_r * rr // gr) * rc + (cell_c * rc // gc)
    return reg.reshape(-1)


def detect(
    gray: jax.Array,
    thresholds: jax.Array,
    settings: FeatureDetectorSettings,
    prev_features: FeatureGrid | None = None,
) -> tuple[FeatureGrid, jax.Array]:
    """Detect up to one corner per grid cell; servo the region thresholds.

    gray: (H, W) detection-resolution luma in [0, 1]; H, W must be divisible
    by the grid shape.
    thresholds: (R_r, R_c) current per-region FAST thresholds (carried state).
    prev_features: propagated features from the previous frame — still-valid
    slots keep their (tracked) position instead of the fresh detection,
    mirroring the reference's re-seeding of tracked features with priority
    (FeatureDetector.cpp:182-205).

    Returns (features, updated_thresholds).
    """
    h, w = gray.shape
    gr, gc = settings.grid_shape
    assert h % gr == 0 and w % gc == 0, (
        f"detection size {(h, w)} must divide the suppression grid {(gr, gc)}"
    )
    ch, cw = h // gr, w // gc

    tmap = _region_threshold_map(thresholds, (h, w))
    score = fast_score_map(gray, tmap, settings.fast_arc_length)

    # Per-cell argmax == grid suppression (FeatureDetector.cpp:138-157).
    cells = score.reshape(gr, ch, gc, cw).transpose(0, 2, 1, 3).reshape(gr, gc, -1)
    best = jnp.argmax(cells, axis=-1)
    best_score = jnp.max(cells, axis=-1)
    cell_y = jax.lax.broadcasted_iota(jnp.int32, (gr, gc), 0) * ch + best // cw
    cell_x = jax.lax.broadcasted_iota(jnp.int32, (gr, gc), 1) * cw + best % cw
    points = jnp.stack([cell_x, cell_y], axis=-1).reshape(-1, 2).astype(jnp.float32)
    scores = best_score.reshape(-1)
    valid = scores > 0.0

    features = FeatureGrid(points=points, scores=scores, valid=valid)

    if prev_features is not None:
        # Propagated features win their cell (age/stability priority).
        keep = prev_features.valid
        features = FeatureGrid(
            points=jnp.where(keep[:, None], prev_features.points, points),
            scores=jnp.where(keep, jnp.maximum(prev_features.scores, scores), scores),
            valid=keep | valid,
        )

    # Threshold servo: per-region valid count vs target cell load
    # (FeatureDetector.cpp:159-163).
    reg_of_cell = _region_index_of_cells(settings)
    n_regions = settings.region_shape[0] * settings.region_shape[1]
    counts = jax.ops.segment_sum(
        valid.astype(jnp.float32), reg_of_cell, num_segments=n_regions
    )
    cells_per_region = (gr * gc) / n_regions
    target = settings.target_cell_load * cells_per_region
    step = jnp.sign(counts - target) * settings.fast_threshold_step
    new_thresholds = jnp.clip(
        thresholds + step.reshape(settings.region_shape),
        settings.fast_threshold_min,
        settings.fast_threshold_max,
    )
    return features, new_thresholds


def initial_thresholds(settings: FeatureDetectorSettings) -> jax.Array:
    return jnp.full(settings.region_shape, settings.fast_threshold_init, jnp.float32)


def rebin(
    points: jax.Array,  # (G, 2) tracked positions (x, y)
    scores: jax.Array,  # (G,) scores carried from their detection
    valid: jax.Array,  # (G,) propagate mask (tracked inliers)
    settings: FeatureDetectorSettings,
    size: tuple[int, int],
) -> FeatureGrid:
    """Re-bin tracked features into their NEW suppression-grid cells.

    The reference re-seeds tracked inliers into the detector with priority
    over fresh detections (FeatureDetector::propagate, FeatureDetector
    .cpp:182-205).  Tracked points move between cells, so the fixed-slot
    grid must be rebuilt: each cell keeps its strongest propagated feature
    (segment-max + winner scatter, fixed shapes throughout).
    """
    h, w = size
    gr, gc = settings.grid_shape
    ch, cw = h // gr, w // gc
    g = gr * gc
    cx = jnp.clip((points[:, 0] // cw).astype(jnp.int32), 0, gc - 1)
    cy = jnp.clip((points[:, 1] // ch).astype(jnp.int32), 0, gr - 1)
    cell = cy * gc + cx
    # Strongest score per cell wins; ties broken by slot index.
    keyed = jnp.where(valid, scores, -jnp.inf)
    best = jax.ops.segment_max(keyed, cell, num_segments=g)
    slot_ids = jnp.arange(points.shape[0])
    is_best = valid & (keyed == best[cell])
    # Deduplicate exact ties: lowest slot id among winners per cell.
    winner_slot = jax.ops.segment_min(
        jnp.where(is_best, slot_ids, jnp.iinfo(jnp.int32).max),
        cell,
        num_segments=g,
    )
    win = is_best & (slot_ids == winner_slot[cell])
    safe_cell = jnp.where(win, cell, g)  # losers scatter out of range (drop)
    out_points = jnp.zeros((g, 2), jnp.float32).at[safe_cell].set(
        points, mode="drop"
    )
    out_scores = jnp.zeros((g,), jnp.float32).at[safe_cell].set(
        scores, mode="drop"
    )
    out_valid = jnp.zeros((g,), jnp.bool_).at[safe_cell].set(True, mode="drop")
    return FeatureGrid(points=out_points, scores=out_scores, valid=out_valid)


def distribution_quality(
    points: jax.Array, valid: jax.Array, size: tuple[int, int], sectors: int = 4
) -> jax.Array:
    """Spatial uniformity in [0, 1]: 1 = perfectly even spread.

    Reference: SpatialMap::distribution_quality's sector-excess measure
    (SpatialMap.tpp:589-625) — points are binned into sectors x sectors
    boxes; mass beyond the uniform share counts as excess.
    """
    h, w = size
    sx = jnp.clip((points[:, 0] * (sectors / w)).astype(jnp.int32), 0, sectors - 1)
    sy = jnp.clip((points[:, 1] * (sectors / h)).astype(jnp.int32), 0, sectors - 1)
    idx = sy * sectors + sx
    counts = jax.ops.segment_sum(
        valid.astype(jnp.float32), idx, num_segments=sectors * sectors
    )
    n = jnp.maximum(jnp.sum(counts), 1.0)
    excess = jnp.sum(jnp.maximum(counts - n / (sectors * sectors), 0.0))
    return 1.0 - excess / n
