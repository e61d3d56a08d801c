"""Scale-out: stream-parallel (DP) and frame-tile-sharded execution.

The reference has no distributed computing at all (SURVEY.md §2.4): its only
parallelism is a 3-thread pipeline (reference Filters/VideoFilter.cpp:62-209)
and OpenCL async launches.  Scale-out here is therefore a new design, with
the reference defining only the per-stream numerics:

  * **stream axis (DP)**: N independent videos processed as one vmapped
    step; state pytrees gain a leading stream dimension and shard across
    `Mesh` axis "stream".  No cross-stream communication exists, so XLA
    inserts zero collectives — linear scaling by construction.
  * **tile axis (spatial sharding)**: full-resolution frame tensors (the
    delay queue, warp/remap) shard their W dimension across "tile".  The
    tracking path runs at detection resolution (tiny) and is replicated.
    The warps are XLA gathers, which pjit partitions like any other op.
    `parallel/spatial.py::remap_sharded` is the explicit alternative: it
    exchanges halos with ppermute and warps each stripe inside
    `shard_map`.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter


def make_mesh(n_streams: int, n_tiles: int = 1, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_streams * n_tiles, (
        f"need {n_streams * n_tiles} devices, have {devices.size}"
    )
    grid = devices[: n_streams * n_tiles].reshape(n_streams, n_tiles)
    return Mesh(grid, ("stream", "tile"))


def _spec_for_leaf(x: jax.Array, tile_w: bool) -> P:
    """Shard leading (stream) axis; optionally shard the last axis (W) of
    large image-like leaves across "tile"."""
    if tile_w and x.ndim >= 3 and x.shape[-1] >= 64 and x.shape[-1] % 2 == 0:
        return P("stream", *([None] * (x.ndim - 2)), "tile")
    return P("stream")


class MultiStreamFilter:
    """Runs a VideoFilter over S concurrent streams on a device mesh."""

    def __init__(
        self, filt: VideoFilter, n_streams: int, mesh: Mesh, tile_frames: bool = True
    ):
        self.filt = filt
        self.n_streams = n_streams
        self.mesh = mesh
        self.tile_frames = tile_frames and "tile" in mesh.axis_names

    def _shard(self, tree: Any, tile_w: bool) -> Any:
        def put(x):
            x = jax.numpy.asarray(x)
            if jax.numpy.issubdtype(x.dtype, jax.dtypes.prng_key):
                # PRNG key leaves can't round-trip through numpy; shard the
                # underlying uint32 data and re-wrap.
                data = put(jax.random.key_data(x))
                return jax.random.wrap_key_data(
                    data, impl=jax.random.key_impl(x)
                )
            sharding = NamedSharding(self.mesh, _spec_for_leaf(x, tile_w))
            if not sharding.is_fully_addressable:
                # Multi-process mesh: device_put rejects shardings that span
                # other hosts (found by tools/run_multiproc.py, r4).  Every
                # process computes the same host-side value, so each simply
                # materializes its own addressable shards.
                host = np.asarray(x)
                return jax.make_array_from_callback(
                    host.shape, sharding, lambda idx: host[idx]
                )
            return jax.device_put(x, sharding)

        return jax.tree.map(put, tree)

    def init(self, spec: FrameSpec) -> Any:
        states = jax.vmap(lambda _: self.filt.init(spec))(
            jax.numpy.arange(self.n_streams)
        )
        return self._shard(states, tile_w=self.tile_frames)

    def step(self, states: Any, frames: Frame) -> tuple[Any, Frame]:
        """frames: Frame pytree with leading stream axis on every leaf."""
        return jax.vmap(self.filt.step)(states, frames)

    def jit_step(self):
        return jax.jit(self.step, donate_argnums=0)
