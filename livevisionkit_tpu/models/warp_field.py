"""WarpField: the core mesh-warp motion model.

Reference parity: ``lvk::WarpMesh`` (reference Math/WarpMesh.hpp:31-161,
Math/WarpMesh.cpp) — an HxW grid of normalized backward offsets
(warped -> identity, WarpMesh.hpp:156-158) with full algebra
(+, -, scalar, blend, combine, clamp, crop_in, set_to(homography),
WarpMesh.cpp:318-560) and an ``apply`` that upsamples the mesh to frame
resolution and remaps (WarpMesh.cpp:183-223; 2x2 meshes short-circuit to an
exact homography warp :196-218).

Design:
  * Offsets are a single (2, Hm, Wm) float32 tensor, plane 0 = dy, plane 1 =
    dx, in **normalized units** (1.0 = frame height/width - 1) so fields are
    resolution-independent, exactly like the reference's normalized meshes.
  * Field control points are CORNER-ALIGNED over the frame: grid point (i, j)
    sits at frame pixel (i*(H-1)/(Hm-1), j*(W-1)/(Wm-1)).
  * All algebra is elementwise tensor math — it vmaps/scans trivially, which
    is what lets the PathSmoother window convolution become one tensor
    contraction instead of a loop of Mat ops.
  * The reference's thread_local identity-mesh caches (WarpMesh.cpp:453-471)
    are unnecessary: XLA constant-folds the identity grids.

Semantics of a field f: warping image I by f produces
O(u) = I(u_px + f(u) * (size-1)) — backward offsets, like the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from livevisionkit_tpu.models.homography import Homography
from livevisionkit_tpu.ops import remap as remap_ops
from livevisionkit_tpu.ops import resample
from livevisionkit_tpu.utils import pytree


def _norm_scale(size: tuple[int, int], dtype=jnp.float32) -> jax.Array:
    """(2, 1, 1) pixel-per-normalized-unit scale for a frame size."""
    h, w = size
    return jnp.array([h - 1, w - 1], dtype).reshape(2, 1, 1)


def _grid_points_px(field_shape: tuple[int, int], size: tuple[int, int]) -> jax.Array:
    """(2, Hm, Wm) pixel positions of corner-aligned field control points."""
    hm, wm = field_shape
    h, w = size
    yy = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 0) * ((h - 1) / (hm - 1))
    xx = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 1) * ((w - 1) / (wm - 1))
    return jnp.stack([yy, xx])


class WarpField(pytree.PyTreeNode):
    offsets: jax.Array  # (2, Hm, Wm) normalized backward offsets (dy, dx)

    # ---- metadata ----------------------------------------------------------

    @property
    def field_shape(self) -> tuple[int, int]:
        return self.offsets.shape[-2:]

    # ---- constructors ------------------------------------------------------

    @classmethod
    def identity(cls, field_shape: tuple[int, int]) -> "WarpField":
        """Zero-offset field (reference WarpMesh identity, WarpMesh.cpp:60-75)."""
        return cls(offsets=jnp.zeros((2,) + tuple(field_shape), jnp.float32))

    @classmethod
    def from_homography(
        cls,
        h: Homography,
        field_shape: tuple[int, int],
        size: tuple[int, int],
    ) -> "WarpField":
        """Field whose warp reproduces `h.warp` at the control points
        (reference WarpMesh::set_to(Homography), WarpMesh.cpp:530-560).

        Backward convention: offsets point from output pixels to their source,
        i.e. o(u) = H^-1(u) - u, normalized.
        """
        pts_px = _grid_points_px(tuple(field_shape), size)  # (2, Hm, Wm) (y, x)
        xy = jnp.stack([pts_px[1], pts_px[0]], axis=-1)  # (Hm, Wm, 2) (x, y)
        src_xy = h.inverse().transform(xy.reshape(-1, 2)).reshape(xy.shape)
        off_px = jnp.stack(
            [src_xy[..., 1] - pts_px[0], src_xy[..., 0] - pts_px[1]]
        )  # (2, Hm, Wm) (dy, dx)
        return cls(offsets=off_px / _norm_scale(size))

    def to_homography(self, size: tuple[int, int]) -> Homography:
        """Exact homography through the 4 corner offsets — the reference's
        2x2-mesh fast path (WarpMesh.cpp:196-218).  Only meaningful for 2x2
        fields (larger fields are sampled at their corners)."""
        pts_px = _grid_points_px(self.field_shape, size)
        off_px = self.offsets * _norm_scale(size)
        src = pts_px + off_px  # where each corner samples from
        corners = [(0, 0), (0, -1), (-1, 0), (-1, -1)]
        dst_q = jnp.stack(
            [jnp.stack([pts_px[1, i, j], pts_px[0, i, j]]) for i, j in corners]
        )
        src_q = jnp.stack(
            [jnp.stack([src[1, i, j], src[0, i, j]]) for i, j in corners]
        )
        # The field samples input at src for output position dst, i.e.
        # out(dst) = in(src) = in(H^-1(dst)) — so H maps src -> dst, which is
        # exactly from_quad(src, dst).
        return Homography.from_quad(src_q, dst_q)

    # ---- algebra (reference WarpMesh.cpp:318-560) --------------------------

    def __add__(self, other: "WarpField") -> "WarpField":
        return WarpField(offsets=self.offsets + other.offsets)

    def __sub__(self, other: "WarpField") -> "WarpField":
        return WarpField(offsets=self.offsets - other.offsets)

    def __mul__(self, s) -> "WarpField":
        return WarpField(offsets=self.offsets * s)

    __rmul__ = __mul__

    def __neg__(self) -> "WarpField":
        return WarpField(offsets=-self.offsets)

    def lerp(self, other: "WarpField", t) -> "WarpField":
        """Blend toward `other` (reference WarpMesh::blend)."""
        return WarpField(offsets=self.offsets + (other.offsets - self.offsets) * t)

    def clamp(self, limits_y, limits_x) -> "WarpField":
        """Clamp normalized offsets into +/- limits (reference
        WarpMesh::clamp used for corrective limits, PathSmoother.cpp:121-125)."""
        dy = jnp.clip(self.offsets[0], -limits_y, limits_y)
        dx = jnp.clip(self.offsets[1], -limits_x, limits_x)
        return WarpField(offsets=jnp.stack([dy, dx]))

    def scale(self, factors: tuple[float, float] | jax.Array) -> "WarpField":
        """Append a zoom about the origin (reference WarpMesh::scale,
        WarpMesh.cpp:370-377): backward sampling at u/s adds
        u_n * (1/s - 1) to the normalized offsets.  `factors` = (sy, sx)."""
        hm, wm = self.field_shape
        sy, sx = factors[0], factors[1]
        yy = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 0) / (hm - 1)
        xx = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 1) / (wm - 1)
        return WarpField(
            offsets=self.offsets
            + jnp.stack([yy * (1.0 / sy - 1.0), xx * (1.0 / sx - 1.0)])
        )

    def crop_in(
        self,
        tl: tuple[float, float] | jax.Array,
        region_size: tuple[float, float] | jax.Array,
    ) -> "WarpField":
        """Append a crop: the output span maps onto the normalized region
        [tl, tl + region_size) (reference WarpMesh::crop_in,
        WarpMesh.cpp:381-392: offset += coord * (region.size - 1)/(size - 1)
        + region.tl, all in normalized units).  tl/region_size as (y, x)."""
        hm, wm = self.field_shape
        yy = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 0) / (hm - 1)
        xx = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 1) / (wm - 1)
        return WarpField(
            offsets=self.offsets
            + jnp.stack(
                [yy * (region_size[0] - 1.0) + tl[0],
                 xx * (region_size[1] - 1.0) + tl[1]]
            )
        )

    def rotate(self, degrees) -> "WarpField":
        """Append a rotation of the sampling grid about the field centre in
        normalized coordinates (reference WarpMesh::rotate,
        WarpMesh.cpp:396-410: arm = (coord - centre)/size, offset +=
        R(arm) - arm — note the /size (not size-1) normalization, which we
        reproduce exactly)."""
        hm, wm = self.field_shape
        rad = jnp.deg2rad(jnp.asarray(degrees, jnp.float32))
        c, s = jnp.cos(rad), jnp.sin(rad)
        yy = (jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 0) - (hm - 1) / 2) / hm
        xx = (jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 1) - (wm - 1) / 2) / wm
        # Reference math is in (x, y): x' = x cos - y sin, y' = x sin + y cos.
        dx = (xx * c - yy * s) - xx
        dy = (xx * s + yy * c) - yy
        return WarpField(offsets=self.offsets + jnp.stack([dy, dx]))

    def covers(
        self,
        region_tl: tuple[float, float],
        region_br: tuple[float, float],
        size: tuple[int, int],
    ) -> jax.Array:
        """Scalar bool: does warping a `size` frame by this field produce
        valid (in-frame) content over the whole normalized region
        [region_tl, region_br]?  The crop-validity test (the reference's
        BoundingQuad::encloses covers only homography warps,
        BoundingQuad.hpp:27-43; this is the general mesh-warp form).

        Exact for piecewise-bilinear fields: the backward map u + o(u) is
        bilinear within each mesh cell, so over any axis-aligned rectangle
        its extremes sit at the rectangle's corner evaluations.  Evaluating
        the map on the grid of control-point rows/cols CLIPPED to the region
        (plus the region edges themselves) therefore covers every extreme
        point of every cell∩region rectangle — all inside <=> covered.
        """
        hm, wm = self.field_shape
        h, w = size
        y0, x0 = region_tl
        y1, x1 = region_br
        # Grid coordinates (normalized): control lines clipped + both edges.
        ys = jnp.concatenate(
            [jnp.clip(jnp.arange(hm, dtype=jnp.float32) / (hm - 1), y0, y1),
             jnp.asarray([y0, y1], jnp.float32)]
        )
        xs = jnp.concatenate(
            [jnp.clip(jnp.arange(wm, dtype=jnp.float32) / (wm - 1), x0, x1),
             jnp.asarray([x0, x1], jnp.float32)]
        )
        gy = ys[:, None] * jnp.ones((1, xs.shape[0]))
        gx = jnp.ones((ys.shape[0], 1)) * xs[None, :]
        # Sample offsets at (gy, gx) in field-grid index units.
        off = remap_ops.bilinear_sample(
            self.offsets, gy * (hm - 1), gx * (wm - 1), fill=None
        )
        sy = (gy + off[0]) * (h - 1)
        sx = (gx + off[1]) * (w - 1)
        ok = (sy >= 0.0) & (sy <= h - 1) & (sx >= 0.0) & (sx <= w - 1)
        return jnp.all(ok)

    def magnitude(self) -> jax.Array:
        """Per-point L2 offset magnitude (normalized units)."""
        return jnp.sqrt(jnp.sum(self.offsets**2, axis=0))

    def resize(self, field_shape: tuple[int, int]) -> "WarpField":
        """Resample control grid (corner-aligned)."""
        if tuple(field_shape) == self.field_shape:
            return self
        return WarpField(
            offsets=resample.resize_corner_aligned(self.offsets, tuple(field_shape))
        )

    def compose(self, outer: "WarpField") -> "WarpField":
        """Composition: first warp by `outer`, then by self — the combined
        backward field is c(u) = outer.o(u) + self.o(u + outer.o(u))
        (reference WarpMesh::combine).  self is resampled at the displaced
        control points (cheap: field resolution, not frame resolution)."""
        hm, wm = self.field_shape
        o = outer.resize((hm, wm)).offsets
        # Normalized coordinates of control points in [0, 1].
        yy = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 0) / (hm - 1)
        xx = jax.lax.broadcasted_iota(jnp.float32, (hm, wm), 1) / (wm - 1)
        # Sample positions in *field grid index* units.
        sy = (yy + o[0]) * (hm - 1)
        sx = (xx + o[1]) * (wm - 1)
        inner_at = remap_ops.bilinear_sample(self.offsets, sy, sx, fill=None)
        return WarpField(offsets=o + inner_at)

    # ---- application -------------------------------------------------------

    def sample_map(self, size: tuple[int, int]) -> jax.Array:
        """(2, H, W) absolute-pixel backward sample map at frame resolution."""
        off = resample.resize_corner_aligned(self.offsets, tuple(size))
        return remap_ops.identity_map(tuple(size)) + off * _norm_scale(size)

    def apply(
        self,
        img: jax.Array,
        fill: jax.Array | float | None = 0.0,
        exact_2x2: bool = True,
        filter_mode: str = "easu",
        fmt=None,
    ) -> jax.Array:
        """Warp (C, H, W) / (H, W) image by this field (reference
        WarpMesh::apply, WarpMesh.cpp:183-223).  2x2 fields take the exact
        homography path like the reference (:196-218).

        filter_mode defaults to "easu" because the reference's apply
        *always* remaps through the fused EASU kernel (WarpMesh.cpp:183-223
        → Functions/Image.cpp:28-81 → FSR.cl:362-403); "bilinear" is the
        cheaper non-parity option."""
        size = img.shape[-2:]
        if exact_2x2 and self.field_shape == (2, 2):
            return self.to_homography(size).warp(
                img, fill=fill, filter_mode=filter_mode, fmt=fmt
            )
        return remap_ops.remap(
            img, self.sample_map(size), fill=fill, filter_mode=filter_mode,
            fmt=fmt,
        )
