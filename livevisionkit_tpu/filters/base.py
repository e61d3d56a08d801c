"""VideoFilter: the functional filter protocol + composition.

Reference parity: ``lvk::VideoFilter`` (reference Filters/VideoFilter.hpp:
32-64) — the `apply(input, output)` virtual base every filter implements —
and ``lvk::CompositeFilter`` (Filters/CompositeFilter.cpp:60-88), the
sequential chain where an empty output breaks the chain (delay filters).

Design: a filter is a **pure step function** over an explicit
state pytree:

    state = filter.init(spec)
    state, out_frame = filter.step(state, in_frame)     # jittable

There are no virtual calls inside jit — a CompositeFilter unrolls its
(statically known) chain at trace time, so XLA fuses across filter
boundaries.  The reference's "empty output" protocol becomes the Frame
`valid` flag: shapes never change, but a filter whose output is not ready
yet (e.g. the stabilizer during its delay warm-up) emits valid=False, and
downstream filters must not corrupt their temporal state from invalid
frames — `where_state` is the helper for that.

The reference's 3-thread `stream()` pipeline (VideoFilter.cpp:62-209) is a
host-side concern and lives in runtime/stream.py (async dispatch +
double-buffered device feed replace reader/filter/writer threads).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.types import PixelFormat


@dataclass(frozen=True)
class FrameSpec:
    """Static description of a video stream's frames."""

    height: int
    width: int
    channels: int = 3
    format: PixelFormat = PixelFormat.RGB
    # Whether frames carry a separate alpha plane (Frame.alpha) — static
    # pytree structure, so stateful filters need it to build templates.
    has_alpha: bool = False

    @classmethod
    def of(cls, frame: Frame) -> "FrameSpec":
        return cls(
            height=frame.height,
            width=frame.width,
            channels=frame.channels,
            format=frame.format,
            has_alpha=frame.alpha is not None,
        )

    @property
    def size(self) -> tuple[int, int]:
        return (self.height, self.width)


def where_state(pred: jax.Array, new: Any, old: Any) -> Any:
    """Select between two state pytrees elementwise (state-update gating for
    invalid input frames)."""
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), new, old)


class VideoFilter:
    """Base class: stateless configuration object + pure step function."""

    def init(self, spec: FrameSpec) -> Any:
        """Create the initial state pytree for a stream of `spec` frames."""
        return ()

    def step(self, state: Any, frame: Frame, *, drain: bool = False) -> tuple[Any, Frame]:
        """Process one frame. Must be jit-traceable with static `self`.

        `drain` (static) marks END-OF-STREAM flushing: the runtime feeds
        valid=False bubble frames to push delay-queue residents out.  Delay
        filters must ADVANCE their temporal machinery on drain bubbles
        (with identity motion) so queued real frames emit, whereas ordinary
        invalid frames (a slow stream's stall tick, an upstream filter's
        warm-up) FREEZE it — advancing on those desynchronizes the delay
        queue from the trajectory anchor and permanently drops frames (the
        r5 soak found exactly that).  Stateless filters ignore the flag.
        """
        raise NotImplementedError

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        """Spec of output frames (scaling/conversion filters override)."""
        return spec

    @property
    def delay(self) -> int:
        """Output latency in frames (0 unless the filter buffers)."""
        return 0

    @property
    def name(self) -> str:
        return type(self).__name__


class IdentityFilter(VideoFilter):
    """Pass-through (reference IdentityFilter, VideoFilter.hpp:62-64)."""

    def step(self, state: Any, frame: Frame, *, drain: bool = False) -> tuple[Any, Frame]:
        return state, frame


@dataclass(frozen=True)
class CompositeFilter(VideoFilter):
    """Sequential chain (reference CompositeFilter.cpp:60-88).  The chain is
    static; per-filter enable flags of the reference map to just not putting
    the filter in the chain (reconfigure = rebuild, it's all cheap jit)."""

    filters: tuple[VideoFilter, ...]

    def __post_init__(self):
        # Mid-chain producer hint: filters whose settings expose a
        # `pool_form` lowering choice (the deblocker) get the
        # any-layout-safe form when they are NOT first in the chain — their
        # input is then a real upstream output, where the fused "reshape"
        # pooling can force layout copies (see
        # DeblockingFilterSettings.pool_form).
        rewritten = []
        for i, f in enumerate(self.filters):
            s = getattr(f, "settings", None)
            if i > 0 and getattr(s, "pool_form", None) == "auto":
                f = dataclasses.replace(
                    f, settings=dataclasses.replace(
                        s, pool_form="reduce_window"
                    )
                )
            rewritten.append(f)
        object.__setattr__(self, "filters", tuple(rewritten))

    def init(self, spec: FrameSpec) -> Any:
        states = []
        for f in self.filters:
            states.append(f.init(spec))
            spec = f.output_spec(spec)
        return tuple(states)

    def step(self, state: Any, frame: Frame, *, drain: bool = False) -> tuple[Any, Frame]:
        new_states = []
        for f, s in zip(self.filters, state):
            s, frame = f.step(s, frame, drain=drain)
            new_states.append(s)
        return tuple(new_states), frame

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        for f in self.filters:
            spec = f.output_spec(spec)
        return spec

    @property
    def delay(self) -> int:
        return sum(f.delay for f in self.filters)

    @property
    def name(self) -> str:
        return "+".join(f.name for f in self.filters)


@dataclass(frozen=True)
class ConversionFilter(VideoFilter):
    """Colour conversion with optional channel extraction (reference
    ConversionFilter.hpp:29-33: a conversion code plus `output_channels`,
    cv::cvtColor's dstCn — the common use is extracting one plane, e.g. luma,
    after the conversion).  `extract_channel` keeps just that plane of the
    converted frame as a single-channel GRAY stream."""

    target: PixelFormat
    extract_channel: int | None = None

    def step(self, state: Any, frame: Frame, *, drain: bool = False) -> tuple[Any, Frame]:
        out = frame.reformat(self.target)
        if self.extract_channel is not None:
            if not 0 <= self.extract_channel < out.channels:
                raise ValueError(
                    f"extract_channel {self.extract_channel} out of range for "
                    f"{out.channels}-channel {self.target}"
                )
            out = out.replace(
                pixels=out.pixels[self.extract_channel : self.extract_channel + 1],
                format=PixelFormat.GRAY,
            )
        return state, out

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        if self.extract_channel is not None:
            return dataclasses.replace(
                spec, format=PixelFormat.GRAY, channels=1
            )
        return dataclasses.replace(
            spec, format=self.target, channels=self.target.channels
        )
