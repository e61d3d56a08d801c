"""EASU: FidelityFX-SR 1.0 Edge-Adaptive Spatial Upsampling — dense XLA form.

Reference parity: the fused OpenCL kernels in reference Functions/OpenCL/
Sources/FSR.cl — the 12-tap edge-adaptive filter core `easu` (:93-322), the
offset-map warp `easu_remap` (:362-403) with background fill + a
nearest-neighbour ring just inside the border (:385-397), the inline
projective variant `easu_remap_homography` (:407-452), and `easu_scale`
(:324-358).  The reference evaluates one output pixel per work-item; here the
whole surface evaluates as one fixed-shape tensor program (12 gathers plus
elementwise math) that XLA fuses.

Math notes vs the reference: the bit-trick approximate rcp/rsqrt
(APrxLoRcp/APrxLoRsq) are replaced by `lax.rsqrt`/division, which are
slightly *more* accurate than the reference's approximations; tolerance
tests bound the difference.

Tap layout around the sample point (x right, y down), f = floor(sample):
        b c
      e f g h
      i j k l
        n o
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.types import PixelFormat

# (dx, dy) of the 12 taps relative to f, in reference tap order.
_TAPS = {
    "b": (0, -1), "c": (1, -1),
    "e": (-1, 0), "f": (0, 0), "g": (1, 0), "h": (2, 0),
    "i": (-1, 1), "j": (0, 1), "k": (1, 1), "l": (2, 1),
    "n": (0, 2), "o": (1, 2),
}


def _luma(px: dict[str, jax.Array], fmt: PixelFormat) -> dict[str, jax.Array]:
    """2x-luma per tap (FSR.cl:286-297): plane 0 for YUV/GRAY, else
    0.5*ch0 + ch1 + 0.5*ch2."""
    if fmt in (PixelFormat.YUV, PixelFormat.GRAY):
        return {k: v[0] for k, v in px.items()}
    return {k: 0.5 * v[0] + v[1] + 0.5 * v[2] for k, v in px.items()}


def _dir_terms(la, lb, lc, ld, le):
    """Per-pixel direction/length terms from the 4-neighbour luma cross
    (the un-weighted body of easu_accumulate, FSR.cl:132-176). a=above,
    b=left, c=center, d=right, e=below.  Returns (dir_x, dir_y,
    len_x + len_y) — these depend only on INPUT pixels, so the polyphase
    scale path evaluates them once per input pixel instead of once per
    output corner (4x fewer evaluations at 2x upscale)."""
    dc = ld - lc
    cb = lc - lb
    len_x = 1.0 / jnp.maximum(jnp.maximum(jnp.abs(dc), jnp.abs(cb)), 1e-20)
    dir_x = ld - lb
    len_x = jnp.clip(jnp.abs(dir_x) * len_x, 0.0, 1.0) ** 2
    ec = le - lc
    ca = lc - la
    len_y = 1.0 / jnp.maximum(jnp.maximum(jnp.abs(ec), jnp.abs(ca)), 1e-20)
    dir_y = le - la
    len_y = jnp.clip(jnp.abs(dir_y) * len_y, 0.0, 1.0) ** 2
    return dir_x, dir_y, len_x + len_y


def _accumulate(dirx, diry, length, wx, wy, la, lb, lc, ld, le):
    """Direction/length accumulation for one bilinear corner
    (easu_accumulate, FSR.cl:132-176); (wx, wy) the corner's bilinear
    weight factors."""
    w = wx * wy
    dir_x, dir_y, lenv = _dir_terms(la, lb, lc, ld, le)
    return (
        dirx + dir_x * w,
        diry + dir_y * w,
        length + lenv * w,
    )


def _easu_core(
    px: dict[str, jax.Array], ppx: jax.Array, ppy: jax.Array, fmt: PixelFormat
) -> jax.Array:
    """The 12-tap EASU filter given gathered taps and sub-pixel position.

    px: tap letter -> (C, ...) values; ppx/ppy: (...) fractional offsets.
    Returns (C, ...) filtered pixels.
    """
    lum = _luma(px, fmt)
    zero = jnp.zeros_like(ppx)
    dirx, diry, length = zero, zero, zero
    # Four bilinear corners f, g, j, k (FSR.cl:300-304).
    dirx, diry, length = _accumulate(
        dirx, diry, length, 1 - ppx, 1 - ppy,
        lum["b"], lum["e"], lum["f"], lum["g"], lum["j"])
    dirx, diry, length = _accumulate(
        dirx, diry, length, ppx, 1 - ppy,
        lum["c"], lum["f"], lum["g"], lum["h"], lum["k"])
    dirx, diry, length = _accumulate(
        dirx, diry, length, 1 - ppx, ppy,
        lum["f"], lum["i"], lum["j"], lum["k"], lum["n"])
    dirx, diry, length = _accumulate(
        dirx, diry, length, ppx, ppy,
        lum["g"], lum["j"], lum["k"], lum["l"], lum["o"])
    return _easu_filter(px, dirx, diry, length, ppx, ppy)


def _shape_kernel(dirx: jax.Array, diry: jax.Array, length: jax.Array):
    """Direction normalization + kernel shaping (FSR.cl:306-330) for
    `_easu_filter`.

    Returns (dxx, dyx, dxy, dyy, clp, cw1, cw2, cw3, cw4): the rotated-
    distance planes hoisting direction*length products and the Horner
    coefficients of the quartic tap weight (see the note in
    `_easu_filter`); per-tap weight = 1 + d2*(cw1 + d2*(cw2 + d2*(cw3 +
    d2*cw4))) with d2 = min(vx^2 + vy^2, clp)."""
    # Normalize direction; degenerate -> horizontal (FSR.cl:306-312).
    dir_r = dirx * dirx + diry * diry
    zro = dir_r < (1.0 / 32768.0)
    inv_r = lax.rsqrt(jnp.maximum(dir_r, 1e-30))
    inv_r = jnp.where(zro, 1.0, inv_r)
    dirx = jnp.where(zro, 1.0, dirx) * inv_r
    diry = jnp.where(zro, 0.0, diry) * inv_r

    # Shape the kernel (FSR.cl:314-330).
    length = (length * 0.5) ** 2
    stretch = (dirx * dirx + diry * diry) / jnp.maximum(
        jnp.maximum(jnp.abs(dirx), jnp.abs(diry)), 1e-20
    )
    len2x = 1.0 + (stretch - 1.0) * length
    len2y = 1.0 - 0.5 * length
    lob = 0.5 + ((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = 1.0 / lob
    lob2 = lob * lob
    cw1 = -1.25 - 2.0 * lob
    cw2 = 0.25 + 2.5 * lob + lob2
    cw3 = -0.5 * lob - 1.25 * lob2
    cw4 = 0.25 * lob2
    dxx = dirx * len2x
    dyx = diry * len2x
    dxy = -diry * len2y
    dyy = dirx * len2y
    return dxx, dyx, dxy, dyy, clp, cw1, cw2, cw3, cw4


def _easu_filter(
    px: dict[str, jax.Array],
    dirx: jax.Array,
    diry: jax.Array,
    length: jax.Array,
    ppx,
    ppy,
) -> jax.Array:
    """The shared EASU tail: kernel shaping + 12 weighted taps + de-ring
    (FSR.cl:306-322,100-127), given already-accumulated direction terms."""
    dxx, dyx, dxy, dyy, clp, cw1, cw2, cw3, cw4 = _shape_kernel(
        dirx, diry, length
    )

    # De-ringing window: min/max of the 4 nearest (f, g, j, k).
    mi4 = jnp.minimum(jnp.minimum(px["f"], px["g"]), jnp.minimum(px["j"], px["k"]))
    ma4 = jnp.maximum(jnp.maximum(px["f"], px["g"]), jnp.maximum(px["j"], px["k"]))

    # 12 weighted taps (easu_tap, FSR.cl:100-127).  A restructuring of the
    # reference's per-tap weight math — algebraically identical, with fewer
    # elementwise ops per tap:
    #   * wb = 25/16*(2/5*d2-1)^2 - 9/16 expands EXACTLY to
    #     0.25*d2^2 - 1.25*d2 + 1, so w = wa*wb is a quartic in d2 whose
    #     coefficients depend only on lob — Horner with 4 per-pixel
    #     coefficient planes hoisted out of the tap loop (4 FMA/tap vs 9
    #     ops/tap) — see `_shape_kernel`.
    #   * the rotated distances hoist the direction*length products:
    #     vx = offx*(dirx*len2x) + offy*(diry*len2x) (4 shared planes, 3
    #     ops/tap per axis vs 4).
    ac = jnp.zeros_like(px["f"])
    aw = jnp.zeros_like(ppx)
    for letter, (dx, dy) in _TAPS.items():
        offx = dx - ppx
        offy = dy - ppy
        vx = offx * dxx + offy * dyx
        vy = offx * dxy + offy * dyy
        d2 = jnp.minimum(vx * vx + vy * vy, clp)
        w = 1.0 + d2 * (cw1 + d2 * (cw2 + d2 * (cw3 + d2 * cw4)))
        ac = ac + px[letter] * w
        aw = aw + w

    # Single-plane reciprocal shared across channels (aw is one plane, ac
    # is C planes).
    out = ac * (1.0 / jnp.where(jnp.abs(aw) > 1e-20, aw, 1e-20))
    return jnp.clip(out, mi4, ma4)


def easu_remap(
    img: jax.Array,
    sample_map: jax.Array,
    fmt: PixelFormat = PixelFormat.YUV,
    fill: jax.Array | float = 0.0,
    origin: tuple = (0, 0),
) -> jax.Array:
    """Backward-warp (C, H, W) image through (2, H', W') absolute (y, x)
    coordinates with EASU filtering (reference easu_remap, FSR.cl:362-403).

    Border semantics match the reference (:385-397): sample centers whose
    4x4 support would leave the image fall back to nearest-neighbour; fully
    outside samples take the background `fill`.

    `origin` (integers, may be traced) is where `img` starts in the map's
    coordinates: a halo-padded stripe of a larger frame samples at
    floor(map) - origin with the map's own sub-pixel offsets, exactly as
    the whole frame would.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    c, h, w = img.shape
    ys, xs = sample_map[0], sample_map[1]
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    ppy = ys - y0
    ppx = xs - x0
    y0i = y0.astype(jnp.int32) - origin[0]
    x0i = x0.astype(jnp.int32) - origin[1]

    px = {}
    for letter, (dx, dy) in _TAPS.items():
        yc = jnp.clip(y0i + dy, 0, h - 1)
        xc = jnp.clip(x0i + dx, 0, w - 1)
        px[letter] = img[:, yc, xc]

    easu_val = _easu_core(px, ppx, ppy, fmt)

    # Border handling (FSR.cl:385-397).
    easu_ok = (x0i >= 1) & (y0i >= 1) & (x0i < w - 4) & (y0i < h - 4)
    inside = (x0i >= 0) & (y0i >= 0) & (x0i < w) & (y0i < h)
    nearest = px["f"]
    if fill is None:  # BORDER_REPLICATE: nearest everywhere outside
        out = jnp.where(easu_ok, easu_val, nearest)
        return out[0] if squeeze else out
    fill_arr = jnp.asarray(fill, img.dtype)
    if fill_arr.ndim == 1:
        fill_arr = fill_arr.reshape((c,) + (1,) * ys.ndim)
    out = jnp.where(easu_ok, easu_val, jnp.where(inside, nearest, fill_arr))
    return out[0] if squeeze else out


def _easu_scale_rational(
    img: jax.Array, out_size: tuple[int, int], fmt: PixelFormat,
    py: int, qy: int, px_: int, qx: int,
) -> jax.Array:
    """Polyphase easu_scale for rational scale factors oh/ih = py/qy,
    ow/iw = px_/qx (all FSR presets: 2, 3/2, 4/3, ...).

    With output pixel u = 2p*k + r, the source tap index (2q*u + q - p) //
    (2p) + dt splits into 2q*k + psi(r, dt): for each of the 2p x 2p output
    PHASES every tap plane is a unit slice + even-reshape select of the
    source (no gathers, no strided slices, no repeat: the 12 gathered 4K
    tap planes of the naive path would be ~1.2 GB), and the sub-pixel
    offsets ppx/ppy are per-phase COMPILE-TIME CONSTANTS (classic polyphase filtering).  The
    EASU core then runs once per phase on (oh/2p, ow/2p) tiles and the
    phases interleave back with one stack+reshape per axis.

    Numerically identical to the gather path away from the 1-px border,
    where easu_ok is false and the `nearest` fallback (tap f, reproduced
    exactly) applies (FSR.cl:385-397 semantics as in easu_remap)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    c, ih, iw = img.shape
    oh, ow = out_size
    phy, sty = 2 * py, 2 * qy  # phases / source stride per axis
    phx, stx = 2 * px_, 2 * qx
    ky, kx = -(-oh // phy), -(-ow // phx)

    def psi(r, dt, p, q):
        return (2 * q * r + q - p) // (2 * p) + dt + 2  # +2: pad re-base

    # Total padded length must cover the largest phase slice
    # [psi, psi + stride*count): psi is relative to the 2-left-padded array.
    need_y = psi(phy - 1, 2, py, qy) + sty * ky
    need_x = psi(phx - 1, 2, px_, qx) + stx * kx
    a = jnp.pad(
        img,
        ((0, 0), (2, max(2, need_y - ih - 2)), (2, max(2, need_x - iw - 2))),
        mode="edge",
    )

    def rsel(x, axis, start, stride, count):
        """x[..., start + stride*k, ...] for k in [0, count) — slice +
        even-reshape select, which fuses into the consumer."""
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(start, start + stride * count)
        xr = x[tuple(sl)]
        shape = list(xr.shape)
        shape[axis] = count
        shape.insert(axis + 1, stride)
        sel = [slice(None)] * (x.ndim + 1)
        sel[axis + 1] = 0
        return xr.reshape(shape)[tuple(sel)]

    # Per-INPUT-pixel direction/length terms, computed once (see _dir_terms):
    # the gather path re-derives them per output corner — 4 evaluations per
    # output pixel; here each input pixel is a corner of ~ (p/q)^2 outputs,
    # so hoisting them cuts ~25% of the EASU op count at 2x.  Values are
    # identical: same formulas on the same edge-padded input.
    if fmt in (PixelFormat.YUV, PixelFormat.GRAY):
        lum = a[0]
    else:
        lum = 0.5 * a[0] + a[1] + 0.5 * a[2]
    h2, w2 = lum.shape
    lp = jnp.pad(lum, ((1, 1), (1, 1)), mode="edge")
    dpx, dpy, dpl = _dir_terms(
        lp[0:h2, 1 : w2 + 1],      # above
        lp[1 : h2 + 1, 0:w2],      # left
        lum,                        # center
        lp[1 : h2 + 1, 2 : w2 + 2],  # right
        lp[2 : h2 + 2, 1 : w2 + 1],  # below
    )

    row_groups = []
    for ry in range(phy):
        num_y = 2 * qy * ry + qy - py
        # Plain Python float: jnp.float32(...) materializes a traced scalar
        # under jit in current JAX, so float()-ing it later would break
        # tracing — and a Python constant folds better anyway.
        ppy = (num_y % phy) / phy
        y0 = num_y // phy + jax.lax.broadcasted_iota(
            jnp.int32, (ky, 1), 0
        ) * sty  # y0 of row k in this phase
        ok_y = (y0 >= 1) & (y0 < ih - 4)
        col_groups = []
        for rx in range(phx):
            # Both axes as nested fused views of the padded source — no
            # materialized row strips (those cost ~3 ms of extra traffic at
            # 4K; XLA folds slice/reshape chains into the phase kernel).
            px = {
                letter: rsel(
                    rsel(a, 1, psi(ry, dy, py, qy), sty, ky),
                    2, psi(rx, dx, px_, qx), stx, kx,
                )
                for letter, (dx, dy) in _TAPS.items()
            }  # each (c, ky, kx)
            num_x = 2 * qx * rx + qx - px_
            ppx = (num_x % phx) / phx
            x0 = num_x // phx + jax.lax.broadcasted_iota(
                jnp.int32, (1, kx), 1
            ) * stx
            ok = ok_y & (x0 >= 1) & (x0 < iw - 4)

            # Corner accumulation with PRECOMPUTED per-pixel terms, in the
            # same f, g, j, k order as _easu_core (weights are per-phase
            # compile-time constants).
            def csel(plane, dx, dy):
                return rsel(
                    rsel(plane, 0, psi(ry, dy, py, qy), sty, ky),
                    1, psi(rx, dx, px_, qx), stx, kx,
                )

            fpx, fpy = ppx, ppy
            dirx = jnp.zeros((ky, kx), jnp.float32)
            diry, length = dirx, dirx
            for (dx, dy, wgt) in (
                (0, 0, (1 - fpx) * (1 - fpy)),
                (1, 0, fpx * (1 - fpy)),
                (0, 1, (1 - fpx) * fpy),
                (1, 1, fpx * fpy),
            ):
                if wgt == 0.0:
                    continue
                dirx = dirx + csel(dpx, dx, dy) * wgt
                diry = diry + csel(dpy, dx, dy) * wgt
                length = length + csel(dpl, dx, dy) * wgt

            val = jnp.where(
                ok, _easu_filter(px, dirx, diry, length, ppx, ppy), px["f"]
            )
            col_groups.append(val)
        row_groups.append(col_groups)
    # Materialization barrier: keeps XLA from fusing the phase math into
    # the interleave concats (chosen on the earlier accelerator; its effect
    # on the GPU is not measured).
    flat = jax.lax.optimization_barrier(
        tuple(v for group in row_groups for v in group)
    )
    row_groups = [list(flat[i * phx : (i + 1) * phx]) for i in range(phy)]
    # Interleave columns then rows: (c, ky, kx, phx) -> (c, ky*phy, kx*phx).
    out = jnp.stack(
        [
            jnp.stack(g, axis=-1).reshape(c, ky, kx * phx)
            for g in row_groups
        ],
        axis=2,
    ).reshape(c, ky * phy, kx * phx)
    out = out[:, :oh, :ow]
    return out[0] if squeeze else out


def easu_scale(
    img: jax.Array,
    out_size: tuple[int, int],
    fmt: PixelFormat = PixelFormat.YUV,
) -> jax.Array:
    """EASU upscale to `out_size` (reference easu_scale, FSR.cl:324-358):
    sample positions follow the half-pixel convention
    p = (u + 0.5) * (in/out) - 0.5.

    Small-rational scale factors (2, 3/2, 4/3, 3, ... — every FSR preset)
    take the gather-free repeat/reshape-select path, which XLA fuses end to
    end; other factors fall back to the gather-based easu_remap evaluated in
    row bands (bounded memory: the 12 full-frame tap planes of a 4K output
    would otherwise exceed device memory)."""
    h, w = img.shape[-2:]
    oh, ow = out_size
    import math

    gy, gx = math.gcd(oh, h), math.gcd(ow, w)
    py, qy = oh // gy, h // gy
    px_, qx = ow // gx, w // gx
    if max(py, px_) <= 8 and py >= qy and px_ >= qx:
        return _easu_scale_rational(img, out_size, fmt, py, qy, px_, qx)

    # Banded fallback for awkward ratios.
    yy = (jax.lax.broadcasted_iota(jnp.float32, (oh, 1), 0) + 0.5) * (h / oh) - 0.5
    xx = (jax.lax.broadcasted_iota(jnp.float32, (1, ow), 1) + 0.5) * (w / ow) - 0.5
    yy = jnp.broadcast_to(jnp.clip(yy, 0.0, h - 1.0), (oh, ow))
    xx = jnp.broadcast_to(jnp.clip(xx, 0.0, w - 1.0), (oh, ow))
    bands = max(1, min(16, oh // 256))
    bh = -(-oh // bands)
    pad = bands * bh - oh
    yyp = jnp.pad(yy, ((0, pad), (0, 0)), mode="edge").reshape(bands, bh, ow)
    xxp = jnp.pad(xx, ((0, pad), (0, 0)), mode="edge").reshape(bands, bh, ow)
    out = jax.lax.map(
        lambda m: easu_remap(img, m, fmt=fmt), jnp.stack([yyp, xxp], axis=1)
    )
    out = jnp.moveaxis(out, 0, -3) if img.ndim == 3 else out
    # lax.map output: (bands, C, bh, ow) or (bands, bh, ow)
    if img.ndim == 3:
        out = out.reshape(img.shape[0], bands * bh, ow)[:, :oh]
    else:
        out = out.reshape(bands * bh, ow)[:oh]
    return out
