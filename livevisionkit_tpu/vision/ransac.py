"""Robust global motion estimation: batched-hypothesis RANSAC + IRLS polish.

Reference parity: ``FrameTracker::estimate_global_motion`` (reference
Vision/FrameTracker.cpp:325-375): USAC/MAGSAC homography or partial-affine
fit over the matched feature pairs, threshold ~3 px, with the homography
model only chosen when the feature distribution is sufficiently uniform
(FrameTracker.cpp:37,171), and the inlier ratio exposed as the tracking
stability (:179,461-464).

Design: OpenCV's sequential USAC loop becomes an
embarrassingly-parallel batch — K minimal solvers (4-point DLT for the
homography, 2-point similarity) run as ONE batched unrolled Gauss-Jordan
elimination, all K x N residuals evaluate as one matmul-shaped broadcast,
MAGSAC-style truncated-quadratic scores reduce per hypothesis, and `argmax`
picks the winner.  Degenerate minimal sets produce non-finite models and
score -inf.  The winning model is polished by IRLS (Hartley-normalized
weighted DLT via a 9x9 eigendecomposition) — replacing USAC's
local-optimization stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.config import MotionEstimationSettings
from livevisionkit_tpu.models.homography import Homography, dlt4
from livevisionkit_tpu.utils import pytree


class GlobalMotion(pytree.PyTreeNode):
    homography: Homography
    inliers: jax.Array  # (N,) bool
    stability: jax.Array  # scalar inlier ratio in [0, 1]
    ok: jax.Array  # scalar bool: model finite & minimally supported


# ---------------------------------------------------------------------------
# residuals & scoring
# ---------------------------------------------------------------------------


def _transfer_errors_sq(h: jax.Array, src: jax.Array, dst: jax.Array) -> jax.Array:
    """Squared forward-transfer error |H(src) - dst|^2. h: (..., 3, 3)."""
    ones = jnp.ones(src.shape[:-1] + (1,), src.dtype)
    ph = jnp.concatenate([src, ones], axis=-1)  # (N, 3)
    out = jnp.einsum("...ij,nj->...ni", h, ph, precision=lax.Precision.HIGHEST)
    denom = out[..., 2]
    safe = jnp.where(jnp.abs(denom) > 1e-8, denom, 1e-8)
    proj = out[..., :2] / safe[..., None]
    return jnp.sum((proj - dst) ** 2, axis=-1)


def _magsac_score(err_sq: jax.Array, valid: jax.Array, tau: float) -> jax.Array:
    """Truncated-quadratic hypothesis score (MAGSAC-flavoured, not the full
    sigma-marginalization): sum over valid points of max(0, 1 - e^2/tau^2)."""
    w = jnp.maximum(0.0, 1.0 - err_sq / (tau * tau))
    return jnp.sum(w * valid, axis=-1)


# ---------------------------------------------------------------------------
# minimal solvers
# ---------------------------------------------------------------------------


def _similarity_from_2pts(p: jax.Array, q: jax.Array) -> jax.Array:
    """Exact 4-DoF similarity from 2 correspondences, as a 3x3 matrix.

    Complex-number form: a + ib = (q2 - q1) / (p2 - p1); t = q1 - M p1.
    """
    dp = p[1] - p[0]
    dq = q[1] - q[0]
    denom = jnp.sum(dp * dp)
    inv = jnp.where(denom > 1e-12, 1.0 / denom, jnp.nan)
    a = (dq[0] * dp[0] + dq[1] * dp[1]) * inv
    b = (dq[1] * dp[0] - dq[0] * dp[1]) * inv
    tx = q[0, 0] - (a * p[0, 0] - b * p[0, 1])
    ty = q[0, 1] - (b * p[0, 0] + a * p[0, 1])
    zero = jnp.zeros_like(a)
    one = jnp.ones_like(a)
    return jnp.stack(
        [
            jnp.stack([a, -b, tx]),
            jnp.stack([b, a, ty]),
            jnp.stack([zero, zero, one]),
        ]
    )


# ---------------------------------------------------------------------------
# refinement (IRLS weighted DLT)
# ---------------------------------------------------------------------------


def _normalization(pts: jax.Array, w: jax.Array) -> jax.Array:
    """Hartley normalization transform (3, 3) for weighted points."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mean = jnp.sum(pts * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1))
    mean_d = jnp.sum(d * w) / wsum
    s = jnp.where(mean_d > 1e-6, jnp.sqrt(2.0) / mean_d, 1.0)
    zero = jnp.zeros_like(s)
    one = jnp.ones_like(s)
    return jnp.stack(
        [
            jnp.stack([s, zero, -s * mean[0]]),
            jnp.stack([zero, s, -s * mean[1]]),
            jnp.stack([zero, zero, one]),
        ]
    )


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """f32 matrix product at full precision: the normal equations lose the
    fit in TF32's 10-bit mantissa."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def _inv3(m: jax.Array) -> jax.Array:
    """Closed-form 3x3 inverse (adjugate/det) — avoids linalg.inv's
    sequential LU for a single tiny matrix."""
    adj = jnp.stack([
        jnp.stack([m[1,1]*m[2,2]-m[1,2]*m[2,1], m[0,2]*m[2,1]-m[0,1]*m[2,2], m[0,1]*m[1,2]-m[0,2]*m[1,1]]),
        jnp.stack([m[1,2]*m[2,0]-m[1,0]*m[2,2], m[0,0]*m[2,2]-m[0,2]*m[2,0], m[0,2]*m[1,0]-m[0,0]*m[1,2]]),
        jnp.stack([m[1,0]*m[2,1]-m[1,1]*m[2,0], m[0,1]*m[2,0]-m[0,0]*m[2,1], m[0,0]*m[1,1]-m[0,1]*m[1,0]]),
    ])
    det = m[0,0]*adj[0,0] + m[0,1]*adj[1,0] + m[0,2]*adj[2,0]
    return adj / jnp.where(jnp.abs(det) > 1e-20, det, jnp.nan)


def _weighted_dlt(src: jax.Array, dst: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted DLT homography via the smallest eigenvector of A^T W A."""
    t_src = _normalization(src, w)
    t_dst = _normalization(dst, w)
    ones = jnp.ones((src.shape[0], 1), src.dtype)
    sn = _mm(jnp.concatenate([src, ones], axis=-1), t_src.T)
    dn = _mm(jnp.concatenate([dst, ones], axis=-1), t_dst.T)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=-1)
    r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], axis=-1)
    a = jnp.concatenate([r1, r2], axis=0)  # (2N, 9)
    ww = jnp.concatenate([w, w], axis=0)
    m = _mm((a * ww[:, None]).T, a)  # (9, 9) PSD normal matrix
    # h33=1 gauge: Cholesky-solve the 8x8 normal block instead of taking
    # the smallest eigenvector (eigh is an iterative solver); numerically
    # equivalent for the near-identity homographies the stabilizer fits
    # (Hartley normalization keeps the normalized h33 well away from 0).
    # A singular system yields NaNs and irls_step keeps the previous model.
    f = jax.scipy.linalg.cho_factor(m[:8, :8])
    h8 = jax.scipy.linalg.cho_solve(f, -m[:8, 8])
    h = jnp.concatenate([h8, jnp.ones((1,), h8.dtype)]).reshape(3, 3)
    h_full = _mm(_mm(_inv3(t_dst), h), t_src)
    return h_full / h_full[2, 2]


def _weighted_similarity(src: jax.Array, dst: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted least-squares similarity (a, b, tx, ty) in closed form."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    ms = jnp.sum(src * w[:, None], axis=0) / wsum
    md = jnp.sum(dst * w[:, None], axis=0) / wsum
    s = src - ms
    d = dst - md
    denom = jnp.sum(w * jnp.sum(s * s, axis=-1))
    inv = jnp.where(denom > 1e-9, 1.0 / denom, 0.0)
    a = jnp.sum(w * (d[:, 0] * s[:, 0] + d[:, 1] * s[:, 1])) * inv
    b = jnp.sum(w * (d[:, 1] * s[:, 0] - d[:, 0] * s[:, 1])) * inv
    tx = md[0] - (a * ms[0] - b * ms[1])
    ty = md[1] - (b * ms[0] + a * ms[1])
    return jnp.stack(
        [
            jnp.stack([a, -b, tx]),
            jnp.stack([b, a, ty]),
            jnp.stack([jnp.zeros_like(a), jnp.zeros_like(a), jnp.ones_like(a)]),
        ]
    )


# ---------------------------------------------------------------------------
# main estimator
# ---------------------------------------------------------------------------


def estimate(
    src: jax.Array,  # (N, 2) previous-frame points (x, y)
    dst: jax.Array,  # (N, 2) tracked positions
    valid: jax.Array,  # (N,) bool match mask
    key: jax.Array,
    settings: MotionEstimationSettings,
    use_homography: jax.Array | bool = True,
    min_samples: int = 8,
) -> GlobalMotion:
    """Fit a robust global motion model to the masked correspondences.

    `use_homography` selects the 8-DoF model; otherwise a 4-DoF similarity
    (the reference's partial-affine fallback for poorly-spread features,
    FrameTracker.cpp:37,171).  Both are estimated batch-parallel; the flag
    only selects which result is returned, so it can be a traced value.
    """
    n = src.shape[0]
    k = settings.hypotheses
    tau = settings.inlier_threshold_px
    vf = valid.astype(jnp.float32)

    # --- sample K minimal sets of 4 distinct-ish valid indices ------------
    logits = jnp.where(valid, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits, shape=(k, 4))  # (K, 4)
    p4 = src[idx]  # (K, 4, 2)
    q4 = dst[idx]

    # --- homography hypotheses -------------------------------------------
    h_hyp = dlt4(p4, q4)  # batched unrolled Gauss-Jordan (see homography.py)
    finite_h = jnp.all(jnp.isfinite(h_hyp), axis=(-2, -1))
    err_h = _transfer_errors_sq(h_hyp, src, dst)  # (K, N)
    score_h = jnp.where(finite_h, _magsac_score(err_h, vf, tau), -jnp.inf)

    # --- similarity hypotheses (first 2 points of each set) ---------------
    s_hyp = jax.vmap(_similarity_from_2pts)(p4[:, :2], q4[:, :2])
    finite_s = jnp.all(jnp.isfinite(s_hyp), axis=(-2, -1))
    err_s = _transfer_errors_sq(s_hyp, src, dst)
    score_s = jnp.where(finite_s, _magsac_score(err_s, vf, tau), -jnp.inf)

    use_h = jnp.asarray(use_homography, jnp.bool_)
    best_h = h_hyp[jnp.argmax(score_h)]
    best_s = s_hyp[jnp.argmax(score_s)]
    model = jnp.where(use_h, best_h, best_s)

    # --- IRLS polish ------------------------------------------------------
    def irls_step(_, m):
        e = _transfer_errors_sq(m, src, dst)
        w = vf * jnp.maximum(0.0, 1.0 - e / (tau * tau))
        mh = _weighted_dlt(src, dst, w)
        ms = _weighted_similarity(src, dst, w)
        refined = jnp.where(use_h, mh, ms)
        # Keep the previous model if refinement exploded.
        good = jnp.all(jnp.isfinite(refined))
        return jnp.where(good, refined, m)

    model = jax.lax.fori_loop(0, settings.refine_iterations, irls_step, model)

    err = _transfer_errors_sq(model, src, dst)
    inliers = (err < tau * tau) & valid
    n_valid = jnp.maximum(jnp.sum(vf), 1.0)
    stability = jnp.sum(inliers.astype(jnp.float32)) / n_valid
    ok = (
        jnp.all(jnp.isfinite(model))
        & (jnp.sum(vf) >= min_samples)
        & (jnp.sum(inliers.astype(jnp.int32)) >= min_samples)
    )
    safe_model = jnp.where(ok, model, jnp.eye(3, dtype=model.dtype))
    return GlobalMotion(
        homography=Homography(m=safe_model),
        inliers=inliers,
        stability=stability,
        ok=ok,
    )
