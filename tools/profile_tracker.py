"""Sub-stage device latency profile of FrameTracker.track (scan-delta method).

Usage: python tools/profile_tracker.py [S]

S > 1 vmaps every stage over S streams — the serving decomposition; this
tool attributes the tracker's time to detect / pyramid / LK / RANSAC so
optimization lands on the real cost.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from profile_stages import scan_time


def main():
    from __graft_entry__ import _flagship_filter
    from livevisionkit_tpu.ops import resample
    from livevisionkit_tpu.vision import features as features_mod
    from livevisionkit_tpu.vision import (
        frame_tracker,
        mesh_motion,
        optical_flow,
        ransac,
    )
    from livevisionkit_tpu.vision.optical_flow import Pyramid
    from livevisionkit_tpu.models.warp_field import WarpField

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    filt = _flagship_filter()
    s = filt.settings.tracker
    print(f"S={S} motion_resolution={s.motion_resolution}, "
          f"grid={s.detector.grid_shape}, max_features={s.detector.max_features}, "
          f"hypotheses={s.motion.hypotheses}, levels={s.flow.pyramid_levels}")

    rng = np.random.default_rng(0)
    gray1 = rng.uniform(0.1, 0.9, size=(1080, 1920)).astype(np.float32)
    gray = jnp.asarray(
        np.stack([gray1 * (1.0 + 0.01 * i) for i in range(S)])
    )
    det = jax.vmap(
        lambda g: resample.resize(g, s.detection_size, antialias=True)
    )(gray)
    st0 = jax.vmap(lambda _: frame_tracker.init(s))(jnp.arange(S))

    # Seed a realistic state: run track twice outside timing.
    track_v = jax.vmap(lambda a, b: frame_tracker.track(a, b, s))
    st, _ = track_v(st0, gray)
    st, _ = track_v(st, gray)
    st = jax.block_until_ready(st)
    pyr = jax.vmap(lambda d: Pyramid.build(d, s.flow.pyramid_levels))(det)

    def t_track(c, t):
        st2, res = track_v(st, gray + 1e-6 * t)
        return c, jnp.sum(res.stability) + jnp.sum(st2.features.points) * 1e-9

    print(f"track (whole):        {scan_time(t_track, jnp.float32(0)):7.3f} ms")

    def t_pyr(c, t):
        p = jax.vmap(
            lambda d: Pyramid.build(d, s.flow.pyramid_levels)
        )(det + 1e-6 * t)
        return c, sum(jnp.sum(l[..., ::32, ::32]) for l in p.levels)

    print(f"pyramid.build:        {scan_time(t_pyr, jnp.float32(0)):7.3f} ms")

    def t_flow(c, t):
        pts, ok = jax.vmap(
            lambda sp, pp, fp, fv: optical_flow.track(sp, pp, fp, fv, s.flow)
        )(st.pyramid, pyr, st.features.points + 1e-6 * t, st.features.valid)
        return c, jnp.sum(pts) + jnp.sum(ok)

    print(f"optical_flow.track:   {scan_time(t_flow, jnp.float32(0)):7.3f} ms")

    key = jax.random.key(1)
    keys = jax.random.split(key, S)
    dst = st.features.points + 0.5

    def t_ransac(c, t):
        est = jax.vmap(
            lambda fp, d, fv, k: ransac.estimate(
                fp, d, fv, k, s.motion, use_homography=jnp.asarray(True),
                min_samples=s.min_motion_samples,
            )
        )(st.features.points, dst + 1e-6 * t, st.features.valid, keys)
        return c, jnp.sum(est.stability) + jnp.sum(est.homography.m)

    print(f"ransac.estimate:      {scan_time(t_ransac, jnp.float32(0)):7.3f} ms")

    def t_detect(c, t):
        feats, thr = jax.vmap(
            lambda d, th: features_mod.detect(d, th, s.detector)
        )(det + 1e-6 * t, st.thresholds)
        return c, jnp.sum(feats.points) + jnp.sum(thr)

    print(f"features.detect:      {scan_time(t_detect, jnp.float32(0)):7.3f} ms")

    if tuple(s.motion_resolution) != (2, 2):
        warm = WarpField.identity(s.motion_resolution)
        warm = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (S,) + x.shape), warm
        )

        def t_mesh(c, t):
            fld, _, _ = jax.vmap(
                lambda fp, d, fv, w: mesh_motion.estimate(
                    fp, d, fv, w, s.detection_size, s.mesh
                )
            )(st.features.points, dst + 1e-6 * t,
              st.features.valid.astype(jnp.float32), warm)
            return c, jnp.sum(fld.offsets)

        print(f"mesh_motion.estimate: {scan_time(t_mesh, jnp.float32(0)):7.3f} ms")


if __name__ == "__main__":
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    main()
