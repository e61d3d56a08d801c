"""livevisionkit_tpu: a real-time video stabilization & enhancement engine.

A brand-new framework (JAX/XLA/pjit) with the capabilities of
Crowsinc/LiveVisionKit (reference: /root/reference): video stabilization
(grid feature detection, pyramidal sparse Lucas-Kanade flow, batched RANSAC
homography + mesh WarpField motion models, sliding-window path smoothing with
QA trust control), adaptive de-blocking, lens calibration/correction, and
FSR-style EASU upscaling + RCAS sharpening — exposed through a streaming
filter-chain runtime and CLI.

Design: instead of the reference's OpenCL/OpenCV single-GPU architecture
(UMat ping-pong, CPU solver islands), the entire per-frame step runs as ONE
jitted on-device program `(state, frame) -> (state, frame)`; variable-length
keypoint vectors become fixed-shape feature grids with validity masks; the
Eigen CPU solves become on-device batched linear algebra; scale-out is via
`jax.sharding.Mesh` (stream data-parallel + frame tile-parallel) rather than
threads.
"""

__version__ = "0.1.0"

from livevisionkit_tpu.config import (
    CASFilterSettings,
    DeblockingFilterSettings,
    FeatureDetectorSettings,
    FrameTrackerSettings,
    MotionEstimationSettings,
    OpticalFlowSettings,
    PathSmootherSettings,
    ScalingFilterSettings,
    StabilizationFilterSettings,
)
from livevisionkit_tpu.data.frame import Frame, PixelFormat
from livevisionkit_tpu.filters.base import (
    CompositeFilter,
    ConversionFilter,
    FrameSpec,
    IdentityFilter,
    VideoFilter,
)
from livevisionkit_tpu.filters.deblocking import DeblockingFilter
from livevisionkit_tpu.filters.lens_correction import LensCorrectionFilter
from livevisionkit_tpu.filters.scaling import ScalingFilter
from livevisionkit_tpu.filters.sharpening import CASFilter
from livevisionkit_tpu.filters.stabilization import StabilizationFilter
from livevisionkit_tpu.vision.calibration import CameraParameters
from livevisionkit_tpu.models.homography import Homography
from livevisionkit_tpu.models.warp_field import WarpField

__all__ = [
    "Frame",
    "PixelFormat",
    "Homography",
    "WarpField",
    "FrameSpec",
    "VideoFilter",
    "IdentityFilter",
    "CompositeFilter",
    "ConversionFilter",
    "StabilizationFilter",
    "DeblockingFilter",
    "ScalingFilter",
    "CASFilter",
    "LensCorrectionFilter",
    "CameraParameters",
    "FeatureDetectorSettings",
    "OpticalFlowSettings",
    "MotionEstimationSettings",
    "FrameTrackerSettings",
    "PathSmootherSettings",
    "StabilizationFilterSettings",
    "DeblockingFilterSettings",
    "ScalingFilterSettings",
    "CASFilterSettings",
    "__version__",
]
