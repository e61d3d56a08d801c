"""Local (mesh) motion estimation: the WarpField least-squares solve.

Reference parity: ``FrameTracker::estimate_local_motions`` (reference
Vision/FrameTracker.cpp:200-321): a sparse least-squares fit of a 16x16
WarpMesh to the matched features — barycentric (bilinear) feature
constraints, temporal-smoothing constraints toward the previous mesh, and
checkerboard local-rigidity constraints (`generate_mesh_constraints`,
:380-457) — solved with Eigen::LeastSquaresConjugateGradient warm-started
from the previous mesh (:274-276), followed by an inlier check (:278-320).

Design: the sparse system is never materialized.  Conjugate
gradient runs on the normal equations with a **matrix-free operator**:

  * feature term: bilinear *sampling* of the mesh at the tracked points
    (gather) and its adjoint, a 4-tap scatter-add (segment_sum);
  * rigidity term: first-difference stencils along both mesh axes and their
    transposed stencils;
  * temporal term: identity.

Each CG iteration is a handful of (2, 17, 17)-sized tensor ops + one
(N, 4) gather/scatter, and the whole solve jits
into the per-frame step (the reference pays a CPU round-trip here, SURVEY
§3.2).  Robustness to outlier matches comes from IRLS reweighting with the
same truncated-quadratic kernel as the RANSAC stage.

On the rigidity term: the reference thins its local-smoothness constraints
to frame edges + a checkerboard + sparse 3-wide quads
(generate_mesh_constraints, FrameTracker.cpp:406-418) because every
constraint row costs its CPU solver assembly time and triplets.  A dense
first-difference stencil is the degenerate-free superset of that pattern
(every edge constrained, same null space) and costs the SAME two tensor
ops per CG iteration here regardless of density — thinning would save
nothing and only weaken the regularization, so the sparsity
pattern is deliberately not reproduced.

Convention: the mesh is solved in NODE space (Hm+1? no — (Hm, Wm) nodes
corner-aligned over the detection frame, matching WarpField), with offsets
in detection-frame pixels during the solve, normalized on output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.config import MeshMotionSettings
from livevisionkit_tpu.models.warp_field import WarpField


def _bilinear_weights(pts: jax.Array, mesh_shape: tuple[int, int], size):
    """Mesh-cell bilinear interpolation data for (N, 2) (x, y) points.

    Returns (idx (N, 4) flat node ids, w (N, 4) weights)."""
    hm, wm = mesh_shape
    h, w = size
    gx = pts[:, 0] * ((wm - 1) / (w - 1))
    gy = pts[:, 1] * ((hm - 1) / (h - 1))
    gx = jnp.clip(gx, 0.0, wm - 1.0001)
    gy = jnp.clip(gy, 0.0, hm - 1.0001)
    x0 = jnp.floor(gx).astype(jnp.int32)
    y0 = jnp.floor(gy).astype(jnp.int32)
    fx = gx - x0
    fy = gy - y0
    idx = jnp.stack(
        [
            y0 * wm + x0,
            y0 * wm + x0 + 1,
            (y0 + 1) * wm + x0,
            (y0 + 1) * wm + x0 + 1,
        ],
        axis=-1,
    )
    w4 = jnp.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], axis=-1
    )
    return idx, w4


def _sample(mesh: jax.Array, idx: jax.Array, w4: jax.Array) -> jax.Array:
    """A x: sample (2, Hm*Wm) mesh at features -> (N, 2) (dy, dx)."""
    flat = mesh.reshape(2, -1)
    vals = flat[:, idx]  # (2, N, 4)
    return jnp.einsum("cnk,nk->nc", vals, w4, precision=lax.Precision.HIGHEST)


def _scatter(res: jax.Array, idx: jax.Array, w4: jax.Array, nodes: int) -> jax.Array:
    """A^T r: scatter (N, 2) residuals back to (2, nodes)."""
    contrib = res[:, :, None] * w4[:, None, :]  # (N, 2, 4)
    flat_idx = idx.reshape(-1)
    out = jax.vmap(
        lambda c: jax.ops.segment_sum(c.reshape(-1), flat_idx, num_segments=nodes)
    )(contrib.transpose(1, 0, 2))
    return out


def _diff_h(m):  # (2, Hm, Wm) -> (2, Hm, Wm-1)
    return m[:, :, 1:] - m[:, :, :-1]


def _diff_v(m):
    return m[:, 1:, :] - m[:, :-1, :]


def _diff_h_t(d):  # adjoint of _diff_h: (D^T y)[j] = y[j-1] - y[j]
    return jnp.pad(d, ((0, 0), (0, 0), (1, 0))) - jnp.pad(d, ((0, 0), (0, 0), (0, 1)))


def _diff_v_t(d):
    return jnp.pad(d, ((0, 0), (1, 0), (0, 0))) - jnp.pad(d, ((0, 0), (0, 1), (0, 0)))


def estimate(
    src: jax.Array,  # (N, 2) previous-frame points, detection px
    dst: jax.Array,  # (N, 2) tracked points
    weights: jax.Array,  # (N,) confidence in [0, 1] (0 = unmatched)
    global_fit: WarpField,  # global-motion (homography) field
    size: tuple[int, int],  # detection frame size (h, w)
    settings: MeshMotionSettings,
    prev_local: WarpField | None = None,  # previous mesh MINUS its global fit
    prev_weight_scale: jax.Array | float = 1.0,  # 0 disables (first frame)
) -> tuple[WarpField, jax.Array, jax.Array]:
    """Fit the mesh. Returns (field, inliers, mean_residual_px).

    The solved offsets live at the tracked (current-frame) positions and
    point back toward the previous frame: o(dst) = src - dst — the same
    backward convention as WarpField.from_homography.

    Two separate regularization pulls (reference FrameTracker.cpp:274-276 +
    generate_mesh_constraints :380-457: the CG warm-starts from and smooths
    toward the PREVIOUS mesh, while the global fit anchors the solution):

      * ``settings.temporal_weight`` toward ``global_fit + prev_local``
        (frame-to-frame coherence of the LOCAL deformation — bounds flicker
        on weakly-constrained regions).  The reference pulls toward the raw
        previous mesh; pulling only the local residual is this design's
        refinement: per-frame camera shake is white noise that the global
        fit already tracks, while the local (parallax/structure) part is
        what persists between frames — so the pull damps solve noise
        without lagging real camera motion.  `prev_weight_scale` zeroes the
        term on the first frame under jit.
      * ``settings.global_weight`` toward `global_fit` (keeps untextured
        nodes on the dominant camera motion).

    The CG warm-starts from the temporal target when it carries weight,
    else from the global fit.
    """
    hm, wm = global_fit.field_shape
    h, w = size
    nodes = hm * wm
    scale = jnp.array([h - 1, w - 1], jnp.float32).reshape(2, 1, 1)

    idx, w4 = _bilinear_weights(dst, (hm, wm), size)
    # Observed backward displacement (dy, dx) in px.
    d_obs = jnp.stack([src[:, 1] - dst[:, 1], src[:, 0] - dst[:, 0]], axis=-1)

    x_glob = global_fit.offsets * scale  # solve in px units
    lam_g = settings.global_weight
    lam_r = settings.rigidity_weight
    if prev_local is None:
        lam_t = jnp.float32(0.0)
        x_tgt = x_glob
        x0 = x_glob
    else:
        lam_t = settings.temporal_weight * jnp.asarray(
            prev_weight_scale, jnp.float32
        )
        x_tgt = x_glob + prev_local.offsets * scale
        # Warm start from the temporal target when it carries weight, else
        # from the global fit.
        x0 = jnp.where(lam_t > 0, x_tgt, x_glob)

    def temporal_diag(wf):
        """Per-node temporal weight lam_t / (1 + (s / s0)^2), where s is the
        node's feature support (the diagonal of the feature normal matrix,
        sum_i wf_i w4_ik^2).  The reference applies a CONSTANT temporal
        weight (FrameTracker.cpp:398-401) and relies on its dense feature
        grid to dominate it; with fixed-capacity feature grids the adaptive
        form gives the same two regimes explicitly: well-tracked nodes
        follow the data (no motion lag), unsupported nodes are held by the
        previous mesh (no flicker)."""
        s0 = settings.temporal_support_scale
        s = jax.ops.segment_sum(
            (wf[:, None] * w4 * w4).reshape(-1),
            idx.reshape(-1),
            num_segments=nodes,
        ).reshape(1, hm, wm)
        return lam_t / (1.0 + (s / s0) ** 2)

    def normal_op(x, wf, lam_tn):
        """A^T W A x for the stacked system
        (feature + rigidity + temporal + global)."""
        feat = _scatter(_sample(x, idx, w4) * wf[:, None], idx, w4, nodes).reshape(
            2, hm, wm
        )
        rig = lam_r * (_diff_h_t(_diff_h(x)) + _diff_v_t(_diff_v(x)))
        return feat + rig + lam_tn * x + lam_g * x

    def rhs(wf, lam_tn):
        feat = _scatter(d_obs * wf[:, None], idx, w4, nodes).reshape(2, hm, wm)
        return feat + lam_tn * x_tgt + lam_g * x_glob

    def cg_solve(b, wf, lam_tn, x_init):
        def mv(v):
            return normal_op(v, wf, lam_tn)

        x = x_init
        r = b - mv(x)
        p = r
        rs = jnp.vdot(r, r)

        def body(_, carry):
            x, r, p, rs = carry
            ap = mv(p)
            denom = jnp.vdot(p, ap)
            alpha = rs / jnp.maximum(denom, 1e-12)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.vdot(r, r)
            beta = rs_new / jnp.maximum(rs, 1e-12)
            p = r + beta * p
            return (x, r, p, rs_new)

        x, _, _, _ = jax.lax.fori_loop(
            0, settings.cg_iterations, body, (x, r, p, rs)
        )
        return x

    tau = settings.inlier_threshold_px
    x = x0
    wf = weights
    for _ in range(settings.irls_rounds):
        lam_tn = temporal_diag(wf)
        x = cg_solve(rhs(wf, lam_tn), wf, lam_tn, x)
        res = _sample(x, idx, w4) - d_obs  # (N, 2)
        err2 = jnp.sum(res * res, axis=-1)
        wf = weights * jnp.maximum(0.0, 1.0 - err2 / (tau * tau))

    res = _sample(x, idx, w4) - d_obs
    err2 = jnp.sum(res * res, axis=-1)
    inliers = (err2 < tau * tau) & (weights > 0)
    denom = jnp.maximum(jnp.sum(weights > 0), 1)
    mean_res = jnp.sum(jnp.sqrt(err2) * (weights > 0)) / denom
    return WarpField(offsets=x / scale), inliers, mean_res
