"""Quad: homography-transformed bounding quad with enclosure tests.

Reference parity: ``lvk::BoundingQuad`` (reference Math/BoundingQuad.hpp:
27-43, Math/BoundingQuad.cpp): a frame rectangle pushed through a
Homography, with `encloses(point/rect/quad)` half-plane tests in
counter-clockwise order (BoundingQuad.cpp:71-83) — the crop-validity
primitive (does the warped frame still cover a crop region?).

Design: vertices are one (4, 2) xy tensor; the sign tests are a batched
cross-product reduce, so `encloses_points` handles any number of query
points in one fused pass and the whole test stays on device (jit/vmap-safe,
returns traced booleans).  For non-homography (mesh) warps the equivalent
validity test lives on WarpField.covers — a capability the reference lacks
(its quad only models projective warps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.models.homography import Homography
from livevisionkit_tpu.utils import pytree


class Quad(pytree.PyTreeNode):
    """Counter-clockwise quad vertices, (4, 2) as (x, y) rows (the
    reference's vertex order, BoundingQuad.cpp:29-34: tl, tr, br, bl of the
    source rect — counter-clockwise in image coordinates where y points
    down)."""

    vertices: jax.Array

    @classmethod
    def from_rect(
        cls, size: tuple[float, float], h: Homography | None = None
    ) -> "Quad":
        """Quad of the (0,0)..(w,h) rectangle, optionally homography-warped
        (reference ctor, BoundingQuad.cpp:27-37)."""
        height, width = size
        v = jnp.array(
            [[0.0, 0.0], [width, 0.0], [width, height], [0.0, height]],
            jnp.float32,
        )
        q = cls(vertices=v)
        return q if h is None else q.transform(h)

    def transform(self, h: Homography) -> "Quad":
        return Quad(vertices=h.transform(self.vertices))

    def encloses_points(self, pts_xy: jax.Array) -> jax.Array:
        """(N,) bool: point left-of-or-on every edge in CCW order
        (reference sign_2d test, BoundingQuad.cpp:73-83)."""
        a = self.vertices  # (4, 2)
        b = jnp.roll(a, -1, axis=0)  # next vertex
        e = b - a  # (4, 2) edge vectors
        # sign_2d(p, a, b) = cross(p - a, b - a); enclosed iff <= 0 for all.
        d = pts_xy[:, None, :] - a[None, :, :]  # (N, 4, 2)
        cross = d[..., 0] * e[None, :, 1] - d[..., 1] * e[None, :, 0]
        return jnp.all(cross <= 0.0, axis=-1)

    def encloses_rect(
        self, tl: tuple[float, float], br: tuple[float, float]
    ) -> jax.Array:
        """Scalar bool: all 4 rect corners enclosed (BoundingQuad.cpp:49-61).
        tl/br as (x, y)."""
        pts = jnp.array(
            [
                [tl[0], tl[1]],
                [br[0], tl[1]],
                [br[0], br[1]],
                [tl[0], br[1]],
            ],
            jnp.float32,
        )
        return jnp.all(self.encloses_points(pts))

    def encloses_quad(self, other: "Quad") -> jax.Array:
        return jnp.all(self.encloses_points(other.vertices))
