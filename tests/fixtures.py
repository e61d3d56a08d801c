"""Synthetic-video fixtures; the generator lives in the package so that
`chip_smoke.py` can use it without importing the tests."""

from livevisionkit_tpu.utils.synthetic import (  # noqa: F401
    camera_pose,
    gt_motion,
    make_texture,
    render_deformed,
    render_frame,
    shaky_clip_bgr_u8,
    shaky_path,
)
