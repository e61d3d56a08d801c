"""Sparse pyramidal Lucas-Kanade optical flow, batched over a feature grid.

Reference parity: cv::SparsePyrLKOpticalFlow as used by FrameTracker
(reference Vision/FrameTracker.cpp:33-35,140-146): 11x11 window, 3 pyramid
levels, 5 iterations, with per-feature tracked/lost status.

Design: the reference reads keypoints back to host vectors and
lets OpenCV iterate per feature on the GPU.  Here the whole solver is one
fixed-shape tensor program batched over the feature axis:

  * pyramids are built once per frame with stencil convs (ops/resample);
    no full-image gradients are kept — Scharr gradients are computed
    per-feature INSIDE the sampled template patch (the 3x3 stencil is local
    and commutes with the uniform bilinear sub-pixel shift, so this is
    numerically identical away from image borders, like OpenCV's own
    patch-local derivative buffer) — this keeps the carried tracking state
    to the pyramid alone and makes the template fetch a single-plane
    extraction;
  * per level, each feature bilinearly samples one (W+3)x(W+3) template
    block, and — in a statically unrolled loop of `iterations` — the warped
    search window from the next frame;
  * the 2x2 normal-equation solve is closed-form (no linalg calls);
  * lost features are masked, never removed: the output has the same (N,)
    shape as the input, so the whole thing jits into the per-frame step.

Window sampling is gather-free: selecting `taps` consecutive rows/columns
per feature is a dense one-hot einsum (see _one_hot_selectors), pinned at
HIGHEST precision so the selection reproduces pixel values exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.config import OpticalFlowSettings
from livevisionkit_tpu.ops import resample
from livevisionkit_tpu.utils import pytree


class Pyramid(pytree.PyTreeNode):
    """Per-frame image pyramid (the tracking state carried between frames)."""

    levels: tuple[jax.Array, ...]  # (H/2^l, W/2^l) luma, level 0 first

    @classmethod
    def build(cls, gray: jax.Array, num_levels: int) -> "Pyramid":
        return cls(levels=tuple(resample.build_pyramid(gray, num_levels)))


def _one_hot_selectors(base: jax.Array, taps: int, extent: int) -> jax.Array:
    """(N,) integer starts -> (N, taps, extent) one-hot selection tensors.

    The gather-free form of window extraction: selecting `taps`
    consecutive rows/columns per feature becomes a dense one-hot matmul.
    (It was chosen where gathers were slow; whether a plain gather is
    faster on the GPU is not measured.)
    """
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, extent), 2)
    want = base[:, None, None] + jax.lax.broadcasted_iota(
        jnp.int32, (1, taps, 1), 1
    )
    # Clamp the selected index, not the base: out-of-range taps re-select the
    # edge row/column (replicate padding), so fractional weights stay true
    # bilinear weights even for windows straddling the border — critical at
    # coarse pyramid levels where windows cover half the image.
    want = jnp.clip(want, 0, extent - 1)
    return (pos == want).astype(jnp.float32)


_COL_BLOCK = 32  # coarse column-block width for the two-stage column select


def _extract_blocks(
    imgs: jax.Array,  # (C, H, W) planes sharing the same windows
    base_xy: jax.Array,  # (N, 2) int32 top-left corners (x, y)
    taps: int,
) -> jax.Array:
    """(C, taps, taps, N) integer-aligned blocks, gather-free — N LAST.

    Layout note: all downstream window math (bilinear shift, Scharr,
    residual/gradient reductions) is elementwise over windows whose spatial
    extent is ~12, so the feature axis N goes last (the minor, contiguous
    dimension) and the window tensors vectorize over features.

    Rows: one one-hot einsum (N*taps, H) @ (H, W).  Columns in two
    stages — a coarse one-hot-masked reduction picks the 2 adjacent
    `_COL_BLOCK`-wide column blocks containing the window, then a fine
    one-hot einsum selects within the 2-block patch.  The two-stage form
    replaces the W-wide one-hot materialization and the N-batched
    (taps, W) @ (W, taps) matmul with W-independent equivalents.
    Selection indices clamp to [0, w-1]
    per tap (replicate padding), identically to the single-stage path.
    """
    c, h, w = imgs.shape
    n = base_xy.shape[0]
    blk = _COL_BLOCK
    assert taps + blk <= 2 * blk, "window must fit 2 coarse blocks"
    nb = -(-w // blk)
    rows = _one_hot_selectors(base_xy[:, 1], taps, h)  # (N, t, H)
    strips = jnp.einsum(
        "nih,chw->nciw", rows, imgs, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )  # (N, C, t, W)
    if nb * blk != w:
        strips = jnp.pad(strips, ((0, 0), (0, 0), (0, 0), (0, nb * blk - w)))

    # Coarse: blocks b0, b0+1 cover clip(bx + j, 0, w-1) for all taps.
    bx = base_xy[:, 0]
    b0 = jnp.clip(
        jnp.floor_divide(jnp.clip(bx, 0, w - 1), blk), 0, jnp.maximum(nb - 2, 0)
    )  # (N,)
    sr = strips.reshape(n, c, taps, nb, blk)
    bi = jax.lax.broadcasted_iota(jnp.int32, (n, 1, 1, nb, 1), 3)
    b0e = b0[:, None, None, None, None]
    patch = jnp.concatenate(
        [
            jnp.sum(sr * (bi == b0e), axis=3),
            jnp.sum(sr * (bi == b0e + 1), axis=3),
        ],
        axis=-1,
    )  # (N, C, t, 2*blk)

    # Fine: per-tap global index, clamped to the image (replicate), made
    # patch-local.  b0+1 may not exist when nb == 1; the clamp keeps the
    # wanted index inside the (zero) second half then, matching w <= blk.
    j = jax.lax.broadcasted_iota(jnp.int32, (1, taps, 1), 1)
    want = jnp.clip(bx[:, None, None] + j, 0, w - 1) - (b0 * blk)[:, None, None]
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 2 * blk), 2)
    sel = (pos == want).astype(jnp.float32)  # (N, t, 2*blk)
    return jnp.einsum(
        "nciw,njw->cijn", patch, sel, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )


def _bilinear_windows(
    blocks: jax.Array,  # (C, win+1, win+1, N) integer blocks, N last
    frac_xy: jax.Array,  # (N, 2) fractional offsets
) -> jax.Array:
    """(C, win, win, N) bilinearly shifted windows from integer blocks."""
    fx = frac_xy[:, 0][None, None, None, :]
    fy = frac_xy[:, 1][None, None, None, :]
    b00 = blocks[:, :-1, :-1, :]
    b01 = blocks[:, :-1, 1:, :]
    b10 = blocks[:, 1:, :-1, :]
    b11 = blocks[:, 1:, 1:, :]
    top = b00 + (b01 - b00) * fx
    bot = b10 + (b11 - b10) * fx
    return top + (bot - top) * fy


def _patch_scharr(bwin: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(dx, dy) Scharr gradients of the interior of (win+2, win+2, N)
    patches (N last).

    Numerically identical to sampling full-image Scharr gradients (away from
    image borders): the 3x3 stencil commutes with the uniform bilinear shift
    already applied to the patch.
    """
    sv = (3.0 * bwin[:-2, :, :] + 10.0 * bwin[1:-1, :, :] + 3.0 * bwin[2:, :, :]) / 32.0
    gx = sv[:, 2:, :] - sv[:, :-2, :]
    dv = bwin[2:, :, :] - bwin[:-2, :, :]
    gy = (3.0 * dv[:, :-2, :] + 10.0 * dv[:, 1:-1, :] + 3.0 * dv[:, 2:, :]) / 32.0
    return gx, gy


def _track_level(
    prev_img: jax.Array,
    next_img: jax.Array,
    pts: jax.Array,  # (N, 2) positions at THIS level's scale
    guess: jax.Array,  # (N, 2) incoming flow at this level's scale
    settings: OpticalFlowSettings,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One pyramid level of LK for all features.

    Returns (flow, good, min_eig): flow (N, 2) refined at this scale.

    All N features are processed as ONE tensor program: window sampling is
    one batched extraction for all features instead of per-feature
    gathers under vmap, which XLA can lower to a serialized loop.
    """
    win = settings.window_size
    area = win * win
    r = win // 2
    h, w = prev_img.shape
    taps = win + 1  # +1 for the bilinear shift

    def split(p):
        base = jnp.floor(p).astype(jnp.int32) - r
        frac = p - jnp.floor(p)
        return base, frac

    # Template block with a 1-px gradient halo: single-plane extraction.
    # All window tensors below are (win-ish, win-ish, N): N rides the lane
    # axis (see _extract_blocks layout note).
    base_t, frac_t = split(pts)
    tmpl_blocks = _extract_blocks(
        prev_img[None], base_t - 1, taps + 2
    )  # (1, win+3, win+3, N)
    bwin = _bilinear_windows(tmpl_blocks, frac_t)[0]  # (win+2, win+2, N)
    tmpl = bwin[1:-1, 1:-1, :]
    gx, gy = _patch_scharr(bwin)

    # Spatial gradient matrix (frozen across iterations, like OpenCV).
    gxx = jnp.sum(gx * gx, axis=(0, 1))  # (N,)
    gxy = jnp.sum(gx * gy, axis=(0, 1))
    gyy = jnp.sum(gy * gy, axis=(0, 1))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = (tr - jnp.sqrt(jnp.maximum(tr * tr - 4.0 * det, 0.0))) / 2.0
    good_g = (min_eig / area) >= settings.min_eigen_threshold
    inv_det = jnp.where(det > 1e-12, 1.0 / det, 0.0)

    # Statically unrolled Gauss-Newton iterations (unrolling lets XLA fuse
    # the solve arithmetic across iterations instead of looping a while-op).
    # ---- iteration windows from ONE cached block per feature -------------
    # Re-running the image-wide extraction (one-hot row einsum over H +
    # two-stage column select) at every iterate's sub-pixel position would
    # be 5 of the 6 extraction passes per level.  Instead, ONE extraction fetches a (taps+2m)-wide
    # block around the warm-start iterate, and the iterations re-select
    # their window INSIDE the cached block with small batched one-hot
    # matmuls (~4 MMAC/iter vs the image-wide N*taps*H*W).  Deviation from
    # the image-wide form: an iterate drifting >m px from the warm start
    # WITHIN one level samples an edge-clamped window, so its flow
    # converges to the block edge instead of following further (OpenCV
    # would follow).  m=4 px/level (x2 per pyramid step) covers the
    # tracking regime with slack — such features sit far off the
    # inter-frame motion prior, fail the forward-target/eigen gates or
    # land as RANSAC outliers, and the reference's own tracker discards
    # them the same way.
    m_it = 4
    ext = taps + 2 * m_it
    base0 = jnp.floor(pts + guess).astype(jnp.int32) - r - m_it  # (N,2) x,y
    block = _extract_blocks(next_img[None], base0, ext)[0]  # (ext, ext, N)
    base0_f = base0.astype(jnp.float32)

    g = guess
    for _ in range(settings.iterations):
        rel = (pts + g) - r - base0_f  # float window top-left, in-block
        rel = jnp.clip(rel, 0.0, float(2 * m_it))
        qi = jnp.floor(rel).astype(jnp.int32)
        frac_j = rel - qi
        # Shift-select, not one-hot matmuls: the in-block offsets take only
        # 2m+1 values, so the window is an unrolled masked sum of STATIC
        # slices (N broadcasts over the minor axis).  The einsum form would
        # be N tiny batched (t,ext)@(ext,ext) matmuls.
        rowsel = jnp.zeros((taps, ext, qi.shape[0]), jnp.float32)
        for sft in range(2 * m_it + 1):
            mk = (qi[:, 1] == sft).astype(jnp.float32)
            rowsel = rowsel + mk * block[sft : sft + taps, :, :]
        blocks = jnp.zeros((taps, taps, qi.shape[0]), jnp.float32)
        for sft in range(2 * m_it + 1):
            mk = (qi[:, 0] == sft).astype(jnp.float32)
            blocks = blocks + mk * rowsel[:, sft : sft + taps, :]
        warped = _bilinear_windows(blocks[None], frac_j)[0]
        rr = tmpl - warped
        bx = jnp.sum(rr * gx, axis=(0, 1))
        by = jnp.sum(rr * gy, axis=(0, 1))
        du = (gyy * bx - gxy * by) * inv_det
        dv = (gxx * by - gxy * bx) * inv_det
        g = g + jnp.stack([du, dv], axis=-1)

    target = pts + g
    inside = (
        (target[:, 0] >= 0.0)
        & (target[:, 0] <= w - 1.0)
        & (target[:, 1] >= 0.0)
        & (target[:, 1] <= h - 1.0)
    )
    return g, good_g & inside, min_eig


def track(
    prev: Pyramid,
    nxt: Pyramid,
    pts: jax.Array,  # (N, 2) (x, y) positions in the previous frame, level-0 scale
    valid: jax.Array,  # (N,) input validity mask
    settings: OpticalFlowSettings,
    init_flow: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Track features from `prev` into `nxt`.

    Returns (new_pts, tracked): new (N, 2) level-0 positions and the combined
    status mask (input-valid & gradient-conditioned & in-bounds at every
    level) — the fixed-shape equivalent of the reference's
    `fast_filter(unmatched)` compaction (FrameTracker.cpp:149).
    """
    n_levels = len(prev.levels)
    top = n_levels - 1
    scale_top = 2.0**top
    flow = (
        jnp.zeros_like(pts)
        if init_flow is None
        else init_flow.astype(pts.dtype) / scale_top
    )
    tracked = valid
    for lvl in range(top, -1, -1):
        s = 2.0**lvl
        flow, good, _ = _track_level(
            prev.levels[lvl], nxt.levels[lvl], pts / s, flow, settings
        )
        tracked = tracked & good
        if lvl > 0:
            flow = flow * 2.0
    return pts + flow, tracked
