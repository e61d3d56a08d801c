"""Synthetic video with an analytically known camera trajectory.

The reference ships no test suite (SURVEY.md §4), so correctness oracles are
built from a feature-rich random texture, a parametric camera path, and
frame renderers where the ground-truth inter-frame motion is closed-form:

    frame_t(u) = base(P_t(u))          (P_t: frame -> texture coords)
    motion M_t = P_t^-1 ∘ P_{t-1}      (maps frame_{t-1} pts to frame_t pts)

The tests and `chip_smoke.py` share it; `shaky_clip_bgr_u8` renders a clip
on the device in the camera's uint8 BGR layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from livevisionkit_tpu.models.homography import Homography


def make_texture(h: int, w: int, rng, blur: int = 2) -> jnp.ndarray:
    """Feature-rich gray texture in [0,1]: blurred noise + bright squares
    (FAST-friendly L-corners)."""
    img = rng.uniform(0.2, 0.5, size=(h, w)).astype(np.float32)
    # box blur to create smooth gradients for LK
    for _ in range(blur):
        img = (
            img
            + np.roll(img, 1, 0)
            + np.roll(img, -1, 0)
            + np.roll(img, 1, 1)
            + np.roll(img, -1, 1)
        ) / 5.0
    # scatter bright/dark squares for strong corners
    n_sq = max(8, (h * w) // 2500)
    for _ in range(n_sq):
        y = rng.integers(0, h - 12)
        x = rng.integers(0, w - 12)
        s = int(rng.integers(5, 12))
        val = float(rng.uniform(0.75, 1.0)) if rng.uniform() > 0.5 else float(
            rng.uniform(0.0, 0.1)
        )
        img[y : y + s, x : x + s] = val
    return jnp.asarray(img)


def camera_pose(
    tx: float, ty: float, angle: float = 0.0, scale: float = 1.0
) -> Homography:
    """P: frame coords -> texture coords."""
    return Homography.from_similarity(
        jnp.float32(scale), jnp.float32(angle), jnp.float32(tx), jnp.float32(ty)
    )


def render_frame(base: jnp.ndarray, pose: Homography, size: tuple[int, int]):
    """frame(u) = base(P(u)) for u in [0,h)x[0,w)."""
    from livevisionkit_tpu.ops import remap as remap_ops

    smap = pose.sample_map(size, inverse=False)
    return remap_ops.remap(base, smap, fill=0.5)


def shaky_path(
    n: int, rng, margin: float = 40.0, drift_px: float = 1.0, shake_px: float = 3.0
):
    """List of camera poses: slow drift + per-frame jitter, starting at a
    margin offset into the texture.  Returns (poses, (tx, ty, angle) arrays)."""
    tx = np.full(n, margin)
    ty = np.full(n, margin)
    ang = np.zeros(n)
    for t in range(1, n):
        tx[t] = tx[t - 1] + drift_px
        ty[t] = ty[t - 1] + 0.5 * drift_px
    tx = tx + rng.uniform(-shake_px, shake_px, size=n)
    ty = ty + rng.uniform(-shake_px, shake_px, size=n)
    ang = ang + rng.uniform(-0.004, 0.004, size=n)
    poses = [camera_pose(float(tx[t]), float(ty[t]), float(ang[t])) for t in range(n)]
    return poses, (tx, ty, ang)


def render_deformed(
    base: jnp.ndarray, pose: Homography, defo_yx: jnp.ndarray, size
):
    """frame(u) = base(P(u) + d(u)) — a NON-projective scene deformation on
    top of the camera pose (parallax / rolling-shutter-like), for mesh-mode
    fixtures.  defo_yx: (2, H, W) texture-px displacement."""
    from livevisionkit_tpu.ops import remap as remap_ops

    smap = pose.sample_map(size, inverse=False) + defo_yx
    return remap_ops.remap(base, smap, fill=0.5)


def gt_motion(prev_pose: Homography, cur_pose: Homography) -> Homography:
    """Ground-truth frame_{t-1} -> frame_t point mapping."""
    return cur_pose.inverse() @ prev_pose


def shaky_clip_bgr_u8(
    n: int, size: tuple[int, int], seed: int = 0, drift_px: float = 1.0,
    shake_px: float = 3.0,
):
    """`n` frames of (H, W, 3) uint8 BGR shaky-camera video and their poses.

    The texture covers the whole drifting path, so no frame samples the
    fill colour.  The three channels are distinct affine tints of the
    texture, so colour conversion sees real chroma.
    """
    rng = np.random.default_rng(seed)
    h, w = size
    margin = 4.0 * shake_px + 0.01 * max(h, w)
    base = make_texture(
        int(h + 2 * margin + 0.5 * drift_px * n), int(w + 2 * margin + drift_px * n),
        rng,
    )
    poses, _ = shaky_path(n, rng, margin=margin, drift_px=drift_px,
                          shake_px=shake_px)
    tint = jnp.asarray([[1.0, 0.0], [0.85, 0.1], [0.7, 0.2]], jnp.float32)

    @jax.jit
    def render_bgr(m):
        g = render_frame(base, Homography(m=m), size)
        px = g[None] * tint[:, :1, None] + tint[:, 1:, None]
        return jnp.clip(px * 255.0 + 0.5, 0, 255).astype(jnp.uint8).transpose(1, 2, 0)

    return [np.asarray(render_bgr(p.m)) for p in poses], poses
