"""Homography: 3x3 projective transform as a JAX pytree value type.

Reference parity: ``lvk::Homography`` (reference Math/Homography.hpp:26-112,
Math/Homography.cpp) — point/vector transforms, warping, inversion, algebra,
and construction from affine/similarity parameters.

Design notes: a Homography is a tiny (3, 3) float32 tensor; everything
here is closed-form math that vmaps cleanly, so RANSAC can evaluate hundreds
of hypotheses in one batched op (see vision/ransac.py).  Point convention:
points are (..., 2) arrays ordered (x, y); sample maps for remap are (2, H, W)
ordered (y, x) — conversion happens only in `sample_map`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.ops import remap as remap_ops
from livevisionkit_tpu.utils import pytree


def dlt4(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Batched exact 4-point DLT: (..., 4, 2) x2 -> (..., 3, 3).

    Batched solver: instead of a LAPACK-style `linalg.solve` (a sequential
    pivoted LU per tiny system), the 8x8
    system is eliminated by an UNROLLED partially-pivoted Gauss-Jordan — 8
    static steps of elementwise/broadcast math (pivot selection is a masked
    argmax + row permutation) that vectorize over any batch.  Points are
    pre-scaled to O(1) for conditioning; degenerate quads produce non-finite
    matrices exactly like the LU path (callers mask them; RANSAC scores
    them -inf).
    """
    batch = src.shape[:-2]
    c = 1.0 / 256.0  # fixed conditioning scale (detection-res coords)
    ps = src * c
    qs = dst * c
    x, y = ps[..., 0], ps[..., 1]  # (..., 4)
    u, v = qs[..., 0], qs[..., 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    ru = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, u], axis=-1)
    rv = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, v], axis=-1)
    aug = jnp.concatenate([ru, rv], axis=-2)  # (..., 8, 9) augmented [A | b]
    idx8 = jnp.arange(8)
    for k in range(8):
        # Partial pivot: pick the largest |column k| entry among rows >= k
        # and swap it up (batched row permutation).
        col = jnp.abs(aug[..., :, k])
        col = jnp.where(idx8 >= k, col, -jnp.inf)
        r = jnp.argmax(col, axis=-1)[..., None]  # (..., 1)
        perm = jnp.where(idx8 == k, r, jnp.where(idx8 == r, k, idx8))
        aug = jnp.take_along_axis(aug, perm[..., None], axis=-2)
        piv = aug[..., k, k][..., None]  # (..., 1)
        inv = jnp.where(jnp.abs(piv) > 1e-12, 1.0 / piv, jnp.nan)
        row = aug[..., k, :] * inv  # (..., 9) normalized pivot row
        fac = aug[..., :, k][..., None]  # (..., 8, 1)
        aug = aug - fac * row[..., None, :]
        aug = aug.at[..., k, :].set(row)
    h8 = aug[..., 8]  # (..., 8)
    m = jnp.concatenate([h8, jnp.ones(batch + (1,), h8.dtype)], axis=-1)
    m = m.reshape(batch + (3, 3))
    # Undo the conditioning scale: H = S^-1 Hn S, S = diag(c, c, 1).
    scale_t = jnp.asarray([[1.0, 1.0, 1.0 / c], [1.0, 1.0, 1.0 / c], [c, c, 1.0]],
                          m.dtype)
    return m * scale_t


class Homography(pytree.PyTreeNode):
    m: jax.Array  # (3, 3) float32

    # ---- constructors ------------------------------------------------------

    @classmethod
    def identity(cls) -> "Homography":
        return cls(m=jnp.eye(3, dtype=jnp.float32))

    @classmethod
    def from_matrix(cls, m: jax.Array) -> "Homography":
        return cls(m=jnp.asarray(m, jnp.float32))

    @classmethod
    def from_affine(cls, a: jax.Array) -> "Homography":
        """From a 2x3 affine matrix (reference Homography::FromAffineMatrix,
        Math/Homography.cpp)."""
        bottom = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
        return cls(m=jnp.concatenate([jnp.asarray(a, jnp.float32), bottom], axis=0))

    @classmethod
    def from_similarity(
        cls, scale: jax.Array, angle: jax.Array, tx: jax.Array, ty: jax.Array
    ) -> "Homography":
        """Similarity transform: scale * R(angle) + translation."""
        c = scale * jnp.cos(angle)
        s = scale * jnp.sin(angle)
        a = jnp.stack(
            [
                jnp.stack([c, -s, tx]),
                jnp.stack([s, c, ty]),
            ]
        )
        return cls.from_affine(a)

    @classmethod
    def from_quad(cls, src: jax.Array, dst: jax.Array) -> "Homography":
        """Exact homography mapping 4 src points to 4 dst points, both (4, 2)
        (x, y).  Solved as the standard 8x8 DLT linear system with h33 = 1
        (equivalent of cv::getPerspectiveTransform; used for the reference's
        exact 2x2-mesh warp fast path, Math/WarpMesh.cpp:196-218, and as the
        RANSAC minimal solver).  Degenerate configurations yield a non-finite
        matrix which callers must mask out (RANSAC scores them to -inf).
        """
        return cls(m=dlt4(src, dst))

    # ---- algebra -----------------------------------------------------------

    def __matmul__(self, other: "Homography") -> "Homography":
        """Composition: (self @ other)(p) == self(other(p))."""
        return Homography(m=jnp.matmul(self.m, other.m, precision=lax.Precision.HIGHEST))

    def inverse(self) -> "Homography":
        """Closed-form adjugate inverse: for a homography only the matrix up
        to scale matters, so adj(m) (= inv(m)*det(m)) is an exact inverse in
        projective terms and avoids jnp.linalg.inv's generic LU path."""
        m = self.m
        adj = jnp.stack([
            jnp.stack([m[1,1]*m[2,2]-m[1,2]*m[2,1], m[0,2]*m[2,1]-m[0,1]*m[2,2], m[0,1]*m[1,2]-m[0,2]*m[1,1]]),
            jnp.stack([m[1,2]*m[2,0]-m[1,0]*m[2,2], m[0,0]*m[2,2]-m[0,2]*m[2,0], m[0,2]*m[1,0]-m[0,0]*m[1,2]]),
            jnp.stack([m[1,0]*m[2,1]-m[1,1]*m[2,0], m[0,1]*m[2,0]-m[0,0]*m[2,1], m[0,0]*m[1,1]-m[0,1]*m[1,0]]),
        ])
        # Normalize so [2,2] ~ 1 when possible (keeps transform() numerics
        # comparable to a true inverse).
        s = adj[2, 2]
        scale = jnp.where(jnp.abs(s) > 1e-12, 1.0 / s, 1.0)
        return Homography(m=adj * scale)

    def normalized(self) -> "Homography":
        """Scale so m[2,2] == 1 (projective scale ambiguity)."""
        return Homography(m=self.m / self.m[2, 2])

    # ---- application -------------------------------------------------------

    def transform(self, pts: jax.Array) -> jax.Array:
        """Transform (..., 2) (x, y) points (reference Homography::transform,
        Math/Homography.cpp:116-158)."""
        ones = jnp.ones(pts.shape[:-1] + (1,), pts.dtype)
        ph = jnp.concatenate([pts, ones], axis=-1)
        out = jnp.matmul(ph, self.m.astype(pts.dtype).T, precision=lax.Precision.HIGHEST)
        return out[..., :2] / out[..., 2:3]

    def sample_map(self, size: tuple[int, int], inverse: bool = True) -> jax.Array:
        """(2, H, W) backward sample map such that remap(img, map) warps img
        by this homography — i.e. output(u) = input(H^-1 u), matching
        cv::warpPerspective (reference Homography::warp, Math/Homography
        .cpp:186-192).  With inverse=False the map samples at H(u) directly
        (output(u) = input(H u)), useful for rendering 'the scene as seen
        from pose H'."""
        h, w = size
        m = (self.inverse() if inverse else self).m.astype(jnp.float32)
        # Fused scalar-broadcast arithmetic: one elementwise pass over the
        # output, no homogeneous point tensor and no tiny-contraction matmul.
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        den = m[2, 0] * xx + m[2, 1] * yy + m[2, 2]
        sx = (m[0, 0] * xx + m[0, 1] * yy + m[0, 2]) / den
        sy = (m[1, 0] * xx + m[1, 1] * yy + m[1, 2]) / den
        return jnp.stack([sy, sx])

    def warp(
        self,
        img: jax.Array,
        fill: jax.Array | float | None = 0.0,
        filter_mode: str = "easu",
        fmt=None,
    ) -> jax.Array:
        """Warp (C, H, W) or (H, W) image by this homography.

        filter_mode defaults to "easu": the reference's homography warp path
        is the fused easu_remap_homography kernel (Functions/Image.cpp:84-138
        → FSR.cl:407-452), i.e. EASU-filtered like WarpMesh::apply."""
        return remap_ops.remap(
            img, self.sample_map(img.shape[-2:]), fill=fill,
            filter_mode=filter_mode, fmt=fmt,
        )
