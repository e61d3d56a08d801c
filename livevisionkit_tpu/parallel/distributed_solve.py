"""Distributed WarpField solve: feature-sharded CG over collectives.

The reference's mesh solve is a single-threaded Eigen CG on the host
(reference Vision/FrameTracker.cpp:274-276); this is its multi-device
redesign (SURVEY.md §2.4/§7, BASELINE.md north star): the
feature constraints are sharded across a mesh axis, each device reduces its
own A_i^T W_i A_i x contribution (a bilinear-sample gather + 4-tap
scatter-add over ITS features), and one `psum` per matvec assembles the full
normal operator — the Schur-complement structure of the problem: the mesh
unknowns (2*17*17 floats) are tiny and replicated, the data term is what
scales, so the collective moves only the reduced (2, Hm, Wm) tensor
between devices, never the features.

The CG iterations themselves run replicated (identical on every device), so
the ONLY communication is one all-reduce of the mesh-sized tensor per
matvec + one for the RHS: at 17x17x2 floats that's ~2 KB/iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from livevisionkit_tpu.config import MeshMotionSettings
from livevisionkit_tpu.models.warp_field import WarpField
from livevisionkit_tpu.vision import mesh_motion


def estimate_sharded(
    src: jax.Array,  # (N, 2) previous-frame points, N divisible by axis size
    dst: jax.Array,  # (N, 2)
    weights: jax.Array,  # (N,)
    global_fit: WarpField,
    size: tuple[int, int],
    settings: MeshMotionSettings,
    mesh: Mesh,
    axis: str = "tile",
    prev_local: WarpField | None = None,
    prev_weight_scale: jax.Array | float = 1.0,
) -> tuple[WarpField, jax.Array, jax.Array]:
    """Drop-in distributed version of vision.mesh_motion.estimate
    (including its local-residual temporal + global-fit regularization
    split).

    Feature arrays shard over `axis`; the regularization targets and result
    are replicated.  Numerically identical to the single-device solve (the
    matvec is a sum over features; psum just changes the reduction order).
    """
    hm, wm = global_fit.field_shape
    h, w = size
    nodes = hm * wm
    scale = jnp.array([h - 1, w - 1], jnp.float32).reshape(2, 1, 1)
    lam_g = settings.global_weight
    lam_r = settings.rigidity_weight
    tau = settings.inlier_threshold_px
    if prev_local is None:
        lam_t = jnp.float32(0.0)
        prev_off = jnp.zeros_like(global_fit.offsets)
    else:
        lam_t = settings.temporal_weight * jnp.asarray(
            prev_weight_scale, jnp.float32
        )
        prev_off = prev_local.offsets

    def solve_local(src_l, dst_l, w_l, glob_off, prev_off, lam_t):
        """Runs per device on its feature shard; targets replicated."""
        idx, w4 = mesh_motion._bilinear_weights(dst_l, (hm, wm), size)
        d_obs = jnp.stack(
            [src_l[:, 1] - dst_l[:, 1], src_l[:, 0] - dst_l[:, 0]], axis=-1
        )
        x_glob = glob_off * scale
        x_tgt = x_glob + prev_off * scale
        x0 = jnp.where(lam_t > 0, x_tgt, x_glob)

        def temporal_diag(wf):
            """Adaptive per-node temporal weight; the feature-support
            diagonal is itself a feature-sharded sum -> one more psum."""
            s0 = settings.temporal_support_scale
            s_local = jax.ops.segment_sum(
                (wf[:, None] * w4 * w4).reshape(-1),
                idx.reshape(-1),
                num_segments=nodes,
            ).reshape(1, hm, wm)
            s = jax.lax.psum(s_local, axis)
            return lam_t / (1.0 + (s / s0) ** 2)

        def normal_op(x, wf, lam_tn):
            feat_local = mesh_motion._scatter(
                mesh_motion._sample(x, idx, w4) * wf[:, None], idx, w4, nodes
            ).reshape(2, hm, wm)
            feat = jax.lax.psum(feat_local, axis)  # <- the only communication
            rig = lam_r * (
                mesh_motion._diff_h_t(mesh_motion._diff_h(x))
                + mesh_motion._diff_v_t(mesh_motion._diff_v(x))
            )
            return feat + rig + lam_tn * x + lam_g * x

        def rhs(wf, lam_tn):
            feat_local = mesh_motion._scatter(
                d_obs * wf[:, None], idx, w4, nodes
            ).reshape(2, hm, wm)
            return (
                jax.lax.psum(feat_local, axis)
                + lam_tn * x_tgt
                + lam_g * x_glob
            )

        def cg_solve(b, wf, lam_tn, x_init):
            x = x_init
            r = b - normal_op(x, wf, lam_tn)
            p = r
            rs = jnp.vdot(r, r)

            def body(_, carry):
                x, r, p, rs = carry
                ap = normal_op(p, wf, lam_tn)
                alpha = rs / jnp.maximum(jnp.vdot(p, ap), 1e-12)
                x = x + alpha * p
                r = r - alpha * ap
                rs_new = jnp.vdot(r, r)
                beta = rs_new / jnp.maximum(rs, 1e-12)
                return (x, r, r + beta * p, rs_new)

            x, _, _, _ = jax.lax.fori_loop(
                0, settings.cg_iterations, body, (x, r, p, rs)
            )
            return x

        x = x0
        wf = w_l
        for _ in range(settings.irls_rounds):
            lam_tn = temporal_diag(wf)
            x = cg_solve(rhs(wf, lam_tn), wf, lam_tn, x)
            res = mesh_motion._sample(x, idx, w4) - d_obs
            err2 = jnp.sum(res * res, axis=-1)
            wf = w_l * jnp.maximum(0.0, 1.0 - err2 / (tau * tau))

        res = mesh_motion._sample(x, idx, w4) - d_obs
        err2 = jnp.sum(res * res, axis=-1)
        inliers = (err2 < tau * tau) & (w_l > 0)
        n_local = jnp.sum((w_l > 0).astype(jnp.float32))
        res_local = jnp.sum(jnp.sqrt(err2) * (w_l > 0))
        denom = jnp.maximum(jax.lax.psum(n_local, axis), 1.0)
        mean_res = jax.lax.psum(res_local, axis) / denom
        return x / scale, inliers, mean_res

    shard = P(axis)
    repl = P()
    fn = shard_map(
        solve_local,
        mesh=mesh,
        in_specs=(shard, shard, shard, repl, repl, repl),
        out_specs=(repl, shard, repl),
    )
    off, inliers, mean_res = fn(
        src, dst, weights, global_fit.offsets, prev_off, lam_t
    )
    return WarpField(offsets=off), inliers, mean_res
