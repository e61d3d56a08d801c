"""LensCorrectionFilter: undistort frames from a calibration profile.

Reference parity: the OBS LCFilter (reference Modules/OBS-Plugin/Sources/
Enhancement/LCFilter.cpp): loads a calibration profile (:99-115), builds
getOptimalNewCameraMatrix + initUndistortRectifyMap as a WarpField with a
normalized view-region crop, cached until size/profile change (:133-171),
and applies it through the standard warp path (:185-191).

Design: the rectification field is computed ONCE at init (host numpy,
vision/calibration.py) and baked into the filter state as a small
WarpField tensor; per frame it's the same warp machinery as stabilization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu.models.warp_field import WarpField
from livevisionkit_tpu.vision.calibration import CameraParameters, undistort_field


@dataclass(frozen=True)
class LensCorrectionFilter(VideoFilter):
    parameters: CameraParameters
    # alpha=0 crops to the valid region (LCFilter's view-region crop);
    # alpha=1 keeps all source pixels (with curved borders visible).
    alpha: float = 0.0
    field_shape: tuple[int, int] = (33, 33)
    # "easu" = reference parity (LCFilter applies through WarpMesh::apply,
    # LCFilter.cpp:185-191, which always EASU-filters); "bilinear" cheaper.
    warp_filter: str = "easu"

    def init(self, spec: FrameSpec) -> WarpField:
        return undistort_field(
            self.parameters, spec.size, self.field_shape, self.alpha
        )

    def step(self, state: Any, frame: Frame, *, drain: bool = False) -> tuple[Any, Frame]:
        field: WarpField = state
        if frame.alpha is None:
            return state, frame.with_pixels(
                field.apply(
                    frame.pixels, fill=0.0, filter_mode=self.warp_filter,
                    fmt=frame.format,
                )
            )
        # Alpha follows the colour geometry (data/frame.py contract): undistort
        # it in the same gather as the colour planes, like the stabilizer's
        # corrective warp does.
        warped = field.apply(
            jnp.concatenate([frame.pixels, frame.alpha[None]]), fill=0.0,
            filter_mode=self.warp_filter, fmt=frame.format,
        )
        return state, frame.replace(pixels=warped[:-1], alpha=warped[-1])
