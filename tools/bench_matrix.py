"""Config-ladder benchmark: the BASELINE.md workload matrix on one chip.

Prints one JSON line per config (same scan-differenced methodology as
bench.py; constant inputs get hoisted out of the scan, so every body varies
its pixels with t).

Usage: python tools/bench_matrix.py [--only SUBSTR] [--json-out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from profile_stages import scan_time


def _frame(rng, c, h, w):
    return jnp.asarray(rng.uniform(0.1, 0.9, size=(c, h, w)).astype(np.float32))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="run only configs whose name contains SUBSTR")
    ap.add_argument("--json-out", default=None,
                    help="also append result lines to this file")
    args = ap.parse_args()

    import livevisionkit_tpu as lvk
    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.utils import compile_cache

    compile_cache.enable_default()
    from livevisionkit_tpu import presets
    from livevisionkit_tpu.config import (
        DeblockingFilterSettings,
        ScalingFilterSettings,
    )
    from livevisionkit_tpu.filters.deblocking import DeblockingFilter
    from livevisionkit_tpu.filters.scaling import ScalingFilter

    rng = np.random.default_rng(0)

    def emit(name, ms):
        line = {"config": name, "value": round(ms, 3), "unit": "ms/frame/chip"}
        print(json.dumps(line), flush=True)
        if args.json_out:
            with open(args.json_out, "a") as f:
                f.write(json.dumps(line) + "\n")

    def run(name, filt, c, h, w, fmt):
        if args.only and args.only not in name:
            return
        spec = lvk.FrameSpec(height=h, width=w, channels=c, format=fmt)
        state = filt.init(spec)
        pix = _frame(rng, c, h, w)

        def body(s, t):
            fr = lvk.Frame.create(
                pix + 1e-9 * t, timestamp=t.astype(jnp.float32) / 60.0, fmt=fmt
            )
            s, out = filt.step(s, fr)
            return s, jnp.sum(out.pixels)

        emit(name, scan_time(body, state))

    # 1. Minimum slice: 640x480 gray homography stabilization.
    run(
        "640x480_gray_stabilization",
        _flagship_filter(detection=(240, 320), grid=(12, 16), min_samples=30,
                         hypotheses=128),
        1, 480, 640, lvk.PixelFormat.GRAY,
    )
    # 2. 1080p homography stabilization (the bench.py headline).  The
    # unsuffixed rows are the EASU-warp default (reference parity,
    # WarpMesh.cpp:183-223); _bilinear rows keep the fast option visible.
    import dataclasses as _dc

    run("1080p_homography_stabilization", _flagship_filter(),
        3, 1080, 1920, lvk.PixelFormat.YUV)
    run("1080p_homography_stabilization_bilinear",
        _flagship_filter(warp_filter="bilinear"),
        3, 1080, 1920, lvk.PixelFormat.YUV)
    # 3. 1080p mesh (vector-field) stabilization.
    run(
        "1080p_mesh_stabilization",
        lvk.StabilizationFilter(settings=presets.stabilization_preset(model="field")),
        3, 1080, 1920, lvk.PixelFormat.YUV,
    )
    run(
        "1080p_mesh_stabilization_bilinear",
        lvk.StabilizationFilter(settings=_dc.replace(
            presets.stabilization_preset(model="field"),
            warp_filter="bilinear")),
        3, 1080, 1920, lvk.PixelFormat.YUV,
    )
    # 3b. 1080p adaptive de-blocking.
    run("1080p_deblock", DeblockingFilter(settings=DeblockingFilterSettings()),
        3, 1080, 1920, lvk.PixelFormat.YUV)
    # 4. EASU 2x upscale to 4K + RCAS.
    run(
        "1080p_to_4k_easu_rcas",
        ScalingFilter(settings=ScalingFilterSettings(output_size=(2160, 3840))),
        3, 1080, 1920, lvk.PixelFormat.YUV,
    )
    # 5. 4K-NATIVE rows (BASELINE config 4: 4K60 full chain, 16.6 ms
    # budget).  Tracking still works at detection resolution, so the 4K
    # cost is the full-res warp + enhancement passes.
    run("4k_homography_stabilization", _flagship_filter(),
        3, 2160, 3840, lvk.PixelFormat.YUV)
    run("4k_homography_stabilization_bilinear",
        _flagship_filter(warp_filter="bilinear"),
        3, 2160, 3840, lvk.PixelFormat.YUV)
    run(
        "4k_mesh_stabilization",
        lvk.StabilizationFilter(settings=presets.stabilization_preset(model="field")),
        3, 2160, 3840, lvk.PixelFormat.YUV,
    )
    run(
        "4k_mesh_stabilization_bilinear",
        lvk.StabilizationFilter(settings=_dc.replace(
            presets.stabilization_preset(model="field"),
            warp_filter="bilinear")),
        3, 2160, 3840, lvk.PixelFormat.YUV,
    )
    run("4k_deblock", DeblockingFilter(settings=DeblockingFilterSettings()),
        3, 2160, 3840, lvk.PixelFormat.YUV)
    run("4k_cas", lvk.CASFilter(settings=lvk.CASFilterSettings()),
        3, 2160, 3840, lvk.PixelFormat.YUV)
    # 6. ONE-PROGRAM 4K chain (r4 VERDICT #3): vs(mesh,easu) + adb + cas as a
    # single jitted CompositeFilter step — proves no inter-filter
    # relayout/repack hides between the per-filter rows above (the r3
    # deblocker relayout bug was exactly that class).  Reference: the
    # single-pass chain loop, CompositeFilter.cpp:60-88, vs the 16.6 ms 4K60
    # frame budget.
    run(
        "4k_full_chain_fused",
        lvk.CompositeFilter(filters=(
            lvk.StabilizationFilter(
                settings=presets.stabilization_preset(model="field")),
            DeblockingFilter(settings=DeblockingFilterSettings()),
            lvk.CASFilter(settings=lvk.CASFilterSettings()),
        )),
        3, 2160, 3840, lvk.PixelFormat.YUV,
    )


if __name__ == "__main__":
    main()
