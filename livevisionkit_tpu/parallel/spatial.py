"""Spatial (tile) sharding with explicit halo exchange.

Frame tensors shard their W axis across the "tile" mesh axis; warping needs
source pixels up to the displacement bound beyond each shard's edges, so
neighbouring shards exchange halo stripes with `lax.ppermute` (neighbour
traffic only — no all-gather), then each device remaps its own
output stripe locally.  This is the SURVEY.md §7 M5 design: the reference
has no spatial parallelism at all (single GPU); this is how 4K+ frames
split across devices.

The local sampler is the XLA gather path (`ops.remap.bilinear_sample` /
`ops.easu.easu_remap`) run per device on the halo-padded stripe inside
`shard_map`.

`filter_mode="easu"` gives the reference-parity filtered warp
(WarpMesh.cpp:183-223 -> FSR.cl:362-403) on the sharded axis.

The halo width must cover the warp's maximum displacement (the stabilizer's
corrective limit by construction).  Larger displacements clamp to the halo
edge, mirroring the replicate-border behaviour at frame edges.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from livevisionkit_tpu.ops import remap as remap_ops


def remap_sharded(
    img: jax.Array,  # (C, H, W), W divisible by the axis size
    sample_map: jax.Array,  # (2, H, W) absolute coords
    mesh: Mesh,
    fill: float | None = 0.0,
    axis: str = "tile",
    halo: int = 192,
    filter_mode: str = "bilinear",
    fmt=None,
) -> jax.Array:
    """Backward-warp with W sharded over `axis` and ppermute halo exchange.

    filter_mode: "bilinear" or "easu" (the reference-parity default at
    WarpMesh-mirroring call sites; `fmt` drives EASU's luma selection).
    """
    if filter_mode not in ("bilinear", "easu"):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if filter_mode == "easu" and fmt is None:
        from livevisionkit_tpu.types import PixelFormat

        fmt = PixelFormat.YUV
    c, h, w = img.shape
    n = mesh.shape[axis]
    assert w % n == 0, f"W={w} must divide the {axis} axis ({n})"
    local_w = w // n
    halo = min(halo, local_w)

    def local_fn(img_l, map_l):
        idx = lax.axis_index(axis)

        # Exchange edge stripes with both neighbours (ring traffic).
        right_edge = img_l[:, :, local_w - halo :]
        left_edge = img_l[:, :, :halo]
        from_left = lax.ppermute(  # my left neighbour's right edge
            right_edge, axis, [(i, (i + 1) % n) for i in range(n)]
        )
        from_right = lax.ppermute(  # my right neighbour's left edge
            left_edge, axis, [(i, (i - 1) % n) for i in range(n)]
        )
        # The ring wraps at the frame edges: the outermost stripes override
        # their wrapped halo with edge replication so border-adjacent taps
        # (EASU reads x0-1..x0+2) see BORDER_REPLICATE content, matching the
        # solo path's tap clamping.  In-range sample CENTERS never reach the
        # halo of an outer stripe (coords are clipped to the frame first).
        from_left = jnp.where(
            idx == 0, jnp.broadcast_to(img_l[:, :, :1], from_left.shape),
            from_left,
        )
        from_right = jnp.where(
            idx == n - 1,
            jnp.broadcast_to(img_l[:, :, local_w - 1 :], from_right.shape),
            from_right,
        )
        padded = jnp.concatenate([from_left, img_l, from_right], axis=2)

        # Local sampling coordinates into the halo-padded stripe.  Clamp to
        # the reachable range: beyond-halo samples degrade to halo-edge
        # replicate (they are out-of-spec displacements).
        x0 = idx * local_w - halo
        ys = jnp.clip(map_l[0], 0.0, float(h - 1))
        xg = jnp.clip(map_l[1], 0.0, float(w - 1))
        xs = jnp.clip(xg - x0.astype(jnp.float32), 0.0,
                      float(local_w + 2 * halo - 1))
        if filter_mode == "easu":
            from livevisionkit_tpu.ops import easu as easu_ops

            # EASU's tap set jumps where the coordinate crosses an integer,
            # so it takes the GLOBAL coordinate and shifts only its integer
            # part: `xg - x0` rounds in f32 where it grows (x0 < 0 on the
            # first stripe) and can cross an integer the global warp does
            # not.
            out = easu_ops.easu_remap(
                padded, jnp.stack([ys, xg]), fmt=fmt, fill=None,
                origin=(0, x0),
            )
            # easu_remap applied its nearest-neighbour border ring
            # (FSR.cl:385-397) against the STRIPE bounds; re-apply it
            # against the GLOBAL frame bounds so outer-stripe borders match
            # the unsharded oracle exactly (the stripe ring minus the global
            # ring is reachable only by beyond-halo displacements).
            yf = jnp.floor(ys)
            xf = jnp.floor(xg)
            ring = ~(
                (xf >= 1) & (yf >= 1) & (xf < w - 4) & (yf < h - 4)
            )
            y0i = jnp.clip(yf.astype(jnp.int32), 0, h - 1)
            x0i = jnp.clip(
                xf.astype(jnp.int32) - x0, 0, local_w + 2 * halo - 1
            )
            nearest = padded[:, y0i, x0i]
            return jnp.where(ring, nearest, out)
        return remap_ops.bilinear_sample(padded, ys, xs, fill=None)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, None, axis), P(None, None, axis)),
        out_specs=P(None, None, axis),
        check_vma=False,
    )
    out = fn(img, sample_map)
    if fill is not None:
        ys, xs = sample_map[0], sample_map[1]
        if filter_mode == "easu":
            # EASU border semantics (FSR.cl:385-397): integer-coordinate
            # inside test (nearest-ring handled by the local sampler).
            yf, xf = jnp.floor(ys), jnp.floor(xs)
            inside = (yf >= 0) & (yf <= h - 1) & (xf >= 0) & (xf <= w - 1)
        else:
            inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
        out = jnp.where(inside, out, jnp.asarray(fill, out.dtype))
    return out
