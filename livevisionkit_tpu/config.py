"""Typed settings tree for every tunable component.

Reference parity: the ``Configurable<T>`` settings-struct pattern
(reference Utility/Configurable.hpp:26-44) and the concrete settings types:
FeatureDetectorSettings (Vision/FeatureDetector.hpp:28-37),
FrameTrackerSettings (Vision/FrameTracker.hpp:31-44),
PathSmootherSettings (Vision/PathSmoother.hpp:29-39),
StabilizationFilterSettings (Filters/StabilizationFilter.hpp:28-39, which
*inherits* tracker + smoother settings), DeblockingFilterSettings
(Filters/DeblockingFilter.hpp:26-32), ScalingFilterSettings
(Filters/ScalingFilter.hpp:26-31).

Design notes: settings are frozen dataclasses (hashable -> usable as
static jit args); everything that decides a tensor SHAPE lives here so a
settings object fully determines the compiled program.  Pixel-unit defaults
match the reference but are expressed on our [0, 1] intensity scale where
applicable (the reference is 8-bit).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class FeatureDetectorSettings:
    """Grid-based adaptive FAST corner detection settings.

    Reference: FeatureDetectorSettings (FeatureDetector.hpp:28-37): detection
    grid + per-region servo-controlled FAST thresholds (FeatureDetector
    .cpp:28-30,159-163).
    """

    # Suppression-grid shape (rows, cols): one feature max per cell — this IS
    # the fixed feature capacity (reference keeps one maximal corner per cell,
    # FeatureDetector.cpp:138-157).  17x30 over 270x480 = 16px cells, 510
    # feature slots (reference default density band 0.05-0.20 of cells).
    grid_shape: tuple[int, int] = (17, 30)
    # Threshold-servo regions (rows, cols) (reference default 2x2 detection
    # regions, FeatureDetector.cpp:159).
    region_shape: tuple[int, int] = (2, 2)
    # FAST ring test: arc length 9 of 16, intensity threshold on [0,1] scale.
    fast_arc_length: int = 9
    fast_threshold_init: float = 40.0 / 255.0
    # Servo: threshold +/- step toward per-region target load, clamped
    # (reference: step 5 in [10, 250] 8-bit units, FeatureDetector.cpp:28-30).
    fast_threshold_min: float = 10.0 / 255.0
    fast_threshold_max: float = 250.0 / 255.0
    fast_threshold_step: float = 5.0 / 255.0
    # Target fraction of grid cells per region that should hold a feature.
    target_cell_load: float = 0.7

    @property
    def max_features(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]


@dataclass(frozen=True)
class OpticalFlowSettings:
    """Sparse pyramidal Lucas-Kanade settings (reference FrameTracker.cpp:33-35:
    11x11 window, 3 pyramid levels, 5 iterations)."""

    window_size: int = 11
    pyramid_levels: int = 3
    iterations: int = 5
    # Tracking rejected when the spatial-gradient matrix is near-singular.
    # OpenCV's minEigThreshold default is 1e-4 on 0-255 intensities; our
    # frames live in [0, 1], so the gradient-energy equivalent is
    # 1e-4 / 255^2 ≈ 1.5e-9.
    min_eigen_threshold: float = 1.5e-9


@dataclass(frozen=True)
class MotionEstimationSettings:
    """Robust global motion-model fit (reference estimate_global_motion,
    FrameTracker.cpp:325-375: USAC/MAGSAC, threshold ~3 px)."""

    # Batched RANSAC hypotheses (one vmapped solve).  The reference's USAC
    # runs 50 sequential iterations (FrameTracker.cpp:337-347); 256 parallel
    # minimal sets give a >5x larger search at ~0.15 ms on one chip.
    hypotheses: int = 256
    inlier_threshold_px: float = 3.0
    refine_iterations: int = 4  # IRLS polish rounds on the winning model
    # Homography only when feature spread is good (reference
    # FrameTracker.cpp:37,171: uniformity > 0.6 else partial-affine).
    min_homography_uniformity: float = 0.6


@dataclass(frozen=True)
class MeshMotionSettings:
    """Local (mesh) motion solve knobs (reference constraint construction:
    generate_mesh_constraints, FrameTracker.cpp:380-457; LSCG solve
    :274-276)."""

    rigidity_weight: float = 1.0  # first-difference smoothness
    # Pull toward the PREVIOUS frame's mesh (the reference's temporal-
    # smoothing constraints + warm start, FrameTracker.cpp:274-276,:380-457):
    # bounds frame-to-frame flicker on weakly-constrained regions.  The
    # per-node weight is temporal_weight / (1 + (s / s0)^2) with s the
    # node's feature support and s0 = temporal_support_scale, so tracked
    # nodes follow the data while unsupported nodes hold to the past.
    temporal_weight: float = 0.5
    temporal_support_scale: float = 0.25
    # Pull toward the per-frame global (homography) fit: anchors untextured
    # nodes on the dominant camera motion.
    global_weight: float = 0.05
    cg_iterations: int = 24
    irls_rounds: int = 2
    inlier_threshold_px: float = 3.0


@dataclass(frozen=True)
class FrameTrackerSettings:
    """Inter-frame motion estimation (reference FrameTrackerSettings,
    FrameTracker.hpp:31-44)."""

    # (h, w); reference works at 480x270 (VSFilter.cpp:259,271) — we round to
    # 480x272 so the suppression grid tiles it in exact 16 px cells.
    detection_size: tuple[int, int] = (272, 480)
    motion_resolution: tuple[int, int] = (2, 2)  # WarpField grid; (16,16) mesh mode
    min_motion_samples: int = 75  # reference min_motion_samples 75
    # Minimum spatial uniformity of tracked points to trust any estimate
    # (reference uniformity_threshold 0.2).
    min_uniformity: float = 0.2
    detector: FeatureDetectorSettings = dataclasses.field(
        default_factory=FeatureDetectorSettings
    )
    flow: OpticalFlowSettings = dataclasses.field(default_factory=OpticalFlowSettings)
    motion: MotionEstimationSettings = dataclasses.field(
        default_factory=MotionEstimationSettings
    )
    mesh: MeshMotionSettings = dataclasses.field(default_factory=MeshMotionSettings)


@dataclass(frozen=True)
class PathSmootherSettings:
    """Sliding-window trajectory smoothing (reference PathSmootherSettings,
    PathSmoother.hpp:29-39: predictive_samples 10, corrective_limits 10%,
    smoothing response 0.04)."""

    predictive_samples: int = 10  # window = 2n+1, output delayed n frames
    corrective_limit: float = 0.10  # max correction, fraction of frame
    response_rate: float = 0.04  # EMA rate of the adaptive-sigma servo
    # Adaptive Gaussian sigma range, in window samples.
    min_sigma: float = 1.0
    max_sigma: float = 6.0
    # Drift-error hysteresis band driving sigma adaptation
    # (reference PathSmoother.cpp:111-132).
    drift_low: float = 0.5
    drift_high: float = 0.9

    @property
    def window(self) -> int:
        return 2 * self.predictive_samples + 1


@dataclass(frozen=True)
class StabilizationFilterSettings:
    """End-to-end stabilizer (reference StabilizationFilterSettings,
    StabilizationFilter.hpp:28-39: composes tracker + smoother settings,
    min_scene_quality 0.8, min_tracking_quality 0.3)."""

    tracker: FrameTrackerSettings = dataclasses.field(
        default_factory=FrameTrackerSettings
    )
    smoother: PathSmootherSettings = dataclasses.field(
        default_factory=PathSmootherSettings
    )
    min_tracking_quality: float = 0.3
    min_scene_quality: float = 0.8
    # QA servo constants (reference StabilizationFilter.cpp:29-30):
    # scene-quality EMA rate QA_UPDATE_RATE and the trust blend step
    # QA_BLEND_STEP applied both raising and dropping (:103-113).
    scene_quality_rate: float = 0.1
    trust_step: float = 0.05
    crop_output: bool = False  # zoom into the stable region on output
    # Storage dtype of the frame delay queue ("uint8" | "float32").  The
    # reference stores frames as 8-bit UMats (Data/VideoFrame.cpp), so u8 is
    # exact parity — and it cuts the queue's HBM footprint and per-step
    # bandwidth 4x, which dominates the step cost at high stream counts
    # (r3: S=8 vmap batch spent ~7 ms/step on the f32 queue alone).
    queue_dtype: str = "uint8"
    # Sampling filter of the corrective warp ("easu" | "bilinear").  The
    # reference always EASU-filters its warps (WarpMesh::apply →
    # easu_remap, WarpMesh.cpp:183-223 / FSR.cl:362-403), so "easu" is the
    # output-quality parity default; "bilinear" is the cheaper option.
    warp_filter: str = "easu"


@dataclass(frozen=True)
class DeblockingFilterSettings:
    """Adaptive macroblock deblocking (reference DeblockingFilterSettings,
    DeblockingFilter.hpp:26-32: levels 3, block 16, median 5, scaling 4)."""

    detection_levels: int = 3
    block_size: int = 16
    filter_size: int = 5
    filter_scaling: int = 4
    # Block-pooling lowering: "reshape" fuses into a cheap producer (a
    # freshly-uploaded frame), but behind a REAL producer (e.g. the
    # stabilizer's warped output in a chain) it can force a layout copy.
    # "reduce_window" consumes any layout directly.  Which is faster on the
    # GPU is not measured.  "auto" picks reshape
    # for unpadded standalone use; CompositeFilter rewrites mid-chain
    # deblockers to "reduce_window" (filters/base.py).
    pool_form: str = "auto"  # auto | reshape | reduce_window


@dataclass(frozen=True)
class CASFilterSettings:
    """AMD contrast-adaptive sharpening (reference CASFilter/CASEffect:
    Modules/OBS-Plugin/Effects/CASEffect.cpp:62-90, kernel ffx_cas_mod.h).
    sharpness 0 = default (lower ringing), 1 = maximum."""

    sharpness: float = 0.8


@dataclass(frozen=True)
class ScalingFilterSettings:
    """FSR upscale + RCAS sharpen (reference ScalingFilter.hpp:26-31).
    output_size=None keeps the input size (CAS-only sharpening)."""

    output_size: tuple[int, int] | None = (1080, 1920)
    sharpness: float = 0.8
