"""Stage-level device latency profile of the enhancement filters (deblock, EASU,
RCAS) — the 4K60-chain legs VERDICT r1 flagged.

Usage: python tools/profile_enhance.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import jax.numpy as jnp
import numpy as np

from profile_stages import scan_time


def main():
    from livevisionkit_tpu.ops import color as color_ops
    from livevisionkit_tpu.ops import easu, rcas, resample
    from livevisionkit_tpu.types import PixelFormat

    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.uniform(0.1, 0.9, size=(3, 1080, 1920)).astype(np.float32))
    fmt = PixelFormat.YUV

    block, scaling, ksize = 16, 4, 5
    fh, fw = (1080 // block) * block, 1920 // block * block
    pxc = px[:, :fh, :fw]

    def t(name, body, init=jnp.float32(0)):
        print(f"{name:34s} {scan_time(body, init):7.3f} ms")

    # --- deblock stages ----------------------------------------------------
    small0 = resample.avg_pool(pxc, scaling)

    t("deblock.avg_pool(1/4)", lambda c, i: (c, jnp.sum(
        resample.avg_pool(pxc + 1e-9 * i, scaling)[:, ::64, ::64])))
    t("deblock.median5@270p", lambda c, i: (c, jnp.sum(
        resample.median_blur(small0 + 1e-9 * i, ksize)[:, ::64, ::64])))
    t("deblock.up_linear(4x)", lambda c, i: (c, jnp.sum(
        resample.upsample_linear_int(small0 + 1e-9 * i, (scaling, scaling))[:, ::256, ::256])))

    gray0 = color_ops.luma(pxc, fmt)

    def measure_body(c, i):
        gray = gray0 + 1e-9 * i
        bm = resample.avg_pool(gray, block)
        ref = resample.upsample_nearest_int(bm, block)
        m = resample.avg_pool(jnp.abs(gray - ref), block)
        return c, jnp.sum(m)

    t("deblock.measure(luma+pools)", measure_body)

    def keep_blend_body(c, i):
        gray = gray0 + 1e-9 * i
        bm = resample.avg_pool(gray, block)
        ref = resample.upsample_nearest_int(bm, block)
        m = resample.avg_pool(jnp.abs(gray - ref), block)
        keep_blocks = jnp.minimum(jnp.floor(m * 255.0), 3) / 3
        keep = resample.upsample_linear_int(keep_blocks, (block, block))
        small = resample.median_blur(resample.avg_pool(pxc + 1e-9 * i, scaling), ksize)
        smooth = resample.upsample_linear_int(small, (scaling, scaling))
        blended = pxc * keep[None] + smooth * (1.0 - keep[None])
        return c, jnp.sum(blended[:, ::256, ::256])

    t("deblock.full-fused", keep_blend_body)

    # --- scaling stages ------------------------------------------------------
    t("easu_scale 1080p->4K", lambda c, i: (c, jnp.sum(
        easu.easu_scale(px + 1e-9 * i, (2160, 3840), fmt=fmt)[:, ::256, ::256])))
    up0 = resample.upsample_linear_int(px, (2, 2))
    t("rcas@4K", lambda c, i: (c, jnp.sum(
        rcas.rcas(up0 + 1e-9 * i, 0.8)[:, ::256, ::256])))

    def chain_body(c, i):
        out = easu.easu_scale(px + 1e-9 * i, (2160, 3840), fmt=fmt)
        out = rcas.rcas(out, 0.8)
        return c, jnp.sum(out[:, ::256, ::256])

    t("easu+rcas fused", chain_body)


if __name__ == "__main__":
    main()
