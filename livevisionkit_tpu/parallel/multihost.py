"""Multi-host scale-out: N hosts x M devices.

The reference is a single-process library (SURVEY.md §2.4 — no sockets, no
MPI/NCCL anywhere in the tree), so this layer is a new design.
The model follows JAX's multi-controller SPMD recipe:

  * every host runs the SAME program and calls :func:`initialize` once;
  * one global ``Mesh(("stream", "tile"))`` spans all hosts' devices —
    stream rows are laid out host-major, so a stream's devices share a
    host and the "stream" axis crosses hosts only between rows (no
    cross-stream communication exists, so the host network carries nothing
    in steady state);
  * each host decodes ONLY the streams whose mesh rows live on its local
    devices (:func:`local_stream_indices`) and contributes its shard of the
    global frame batch via ``jax.make_array_from_process_local_data``;
  * the jitted step is the same ``MultiStreamFilter.step`` used on one
    host — pjit handles the rest.

Degenerate single-process use (tests, the driver's virtual CPU mesh) is
first-class: ``initialize()`` is a no-op and every stream is local.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from livevisionkit_tpu.data.frame import Frame
from livevisionkit_tpu.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu.parallel.streams import MultiStreamFilter, _spec_for_leaf


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up jax.distributed for a multi-host run.

    Reads the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) when args are omitted, and is
    a silent no-op for single-process runs so the same entry point works
    everywhere.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_mesh(n_streams: int, n_tiles: int = 1) -> Mesh:
    """Global ("stream", "tile") mesh over every device of every host.

    Streams are laid out host-major: with D local devices per host and
    T = n_tiles, each host owns D // T consecutive stream rows, keeping each
    stream's tile ring on one host.
    """
    devices = np.asarray(jax.devices())
    need = n_streams * n_tiles
    assert devices.size >= need, f"need {need} devices, have {devices.size}"
    grid = devices[:need].reshape(n_streams, n_tiles)
    return Mesh(grid, ("stream", "tile"))


def local_stream_indices(mesh: Mesh) -> list[int]:
    """Stream rows whose devices live (at least partly) on this process.

    These are the streams this host must decode and feed.  With host-major
    layout each row is on exactly one host; a row split across hosts (odd
    tile counts) is fed by every host that owns part of it.
    """
    pid = jax.process_index()
    rows = mesh.devices.reshape(mesh.devices.shape[0], -1)
    return [
        i
        for i in range(rows.shape[0])
        if any(d.process_index == pid for d in rows[i])
    ]


def global_frames_from_local(
    mesh: Mesh, local_frames: Frame, tile_frames: bool = True
) -> Frame:
    """Assemble the global per-step frame batch from this host's decode.

    ``local_frames`` carries a leading axis of ``len(local_stream_indices)``
    on every leaf (this host's streams, in mesh-row order).  Returns a
    globally-sharded Frame whose leading axis is the full stream count.
    """
    n_local = len(local_stream_indices(mesh))
    tile = tile_frames and "tile" in mesh.axis_names

    def put(x):
        x = np.asarray(x)
        assert x.shape[0] == n_local, (
            f"expected {n_local} local streams, got {x.shape[0]}"
        )
        spec = _spec_for_leaf(x, tile)
        global_shape = (mesh.shape["stream"],) + x.shape[1:]
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), x, global_shape
        )

    return jax.tree.map(put, local_frames)


def fetch_local_outputs(mesh: Mesh, out: Frame) -> list[np.ndarray]:
    """Download this host's stream outputs (pixels) from a global batch.

    Uses addressable shards only — no cross-host transfer; each host writes
    the encoders for its own streams.
    """
    local = local_stream_indices(mesh)
    arr = out.pixels
    got: dict[int, list] = {i: [] for i in local}
    for shard in arr.addressable_shards:
        idx = shard.index[0]
        start = idx.start or 0
        data = np.asarray(shard.data)
        for k in range(data.shape[0]):
            stream = start + k
            if stream in got:
                got[stream].append((shard.index[1:], data[k]))
    outs = []
    for i in local:
        pieces = got[i]
        if len(pieces) == 1:
            outs.append(pieces[0][1])
        else:
            # Reassemble W-tiled shards.
            full = np.zeros(arr.shape[1:], arr.dtype)
            for index, data in pieces:
                full[index] = data
            outs.append(full)
    return outs


class MultiHostStreamFilter:
    """SPMD multi-host wrapper: same step everywhere, local I/O per host."""

    def __init__(self, filt: VideoFilter, mesh: Mesh, tile_frames: bool = True):
        self.filt = filt
        self.mesh = mesh
        self.n_streams = int(mesh.shape["stream"])
        self.tile_frames = tile_frames and "tile" in mesh.axis_names
        self._inner = MultiStreamFilter(
            filt, self.n_streams, mesh, tile_frames=tile_frames
        )

    def local_streams(self) -> list[int]:
        return local_stream_indices(self.mesh)

    def init(self, spec: FrameSpec) -> Any:
        return self._inner.init(spec)

    def put_frames(self, local_frames: Frame) -> Frame:
        return global_frames_from_local(self.mesh, local_frames, self.tile_frames)

    def fetch(self, out: Frame) -> list[np.ndarray]:
        return fetch_local_outputs(self.mesh, out)

    def jit_step(self):
        return self._inner.jit_step()
