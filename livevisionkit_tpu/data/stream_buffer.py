"""StreamBuffer: fixed-capacity sliding window as a jit-friendly pytree.

Reference parity: ``lvk::StreamBuffer<T>`` (reference Data/StreamBuffer.hpp:
28-130, StreamBuffer.tpp) — circular window with push/advance, oldest/centre/
newest access and a ``convolve_at`` kernel product (StreamBuffer.tpp:384+).
It backs the PathSmoother's trajectory window (Vision/PathSmoother.cpp:55-73)
and the StabilizationFilter's frame delay queue (Filters/StabilizationFilter
.cpp:62).

Design: the buffer is a pytree of fixed-shape tensors with a
leading capacity axis plus (start, count) scalars, so it lives in a
jit/scan carry.  Pushes are O(1) `dynamic_update_slice` writes into the
circular slot — crucial for the frame delay queue, where a shift-based
buffer would copy ~100 MB/frame.  Window convolutions contract the data
tensor against the *rolled weight vector* (rolling the small weights instead
of the big data), so the PathSmoother's Gaussian smoothing is a single
tensordot.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from livevisionkit_tpu.utils import pytree


def _update_leaf(data: jax.Array, elem: jax.Array, slot: jax.Array) -> jax.Array:
    return jax.lax.dynamic_update_index_in_dim(data, elem.astype(data.dtype), slot, 0)


class StreamBuffer(pytree.PyTreeNode):
    data: Any  # pytree; every leaf has leading dim == capacity
    start: jax.Array  # int32 physical index of the oldest element
    count: jax.Array  # int32 number of valid elements
    capacity: int = pytree.field(static=True)

    # ---- constructors ------------------------------------------------------

    @classmethod
    def create(cls, template: Any, capacity: int) -> "StreamBuffer":
        """Empty buffer shaped after a single-element pytree `template`."""
        data = jax.tree.map(
            lambda x: jnp.zeros((capacity,) + jnp.shape(x), jnp.asarray(x).dtype),
            template,
        )
        return cls(
            data=data,
            start=jnp.zeros((), jnp.int32),
            count=jnp.zeros((), jnp.int32),
            capacity=capacity,
        )

    # ---- state -------------------------------------------------------------

    def is_full(self) -> jax.Array:
        return self.count >= self.capacity

    def _slot(self, logical: jax.Array) -> jax.Array:
        return jax.lax.rem(self.start + logical, self.capacity)

    # ---- mutation (returns new buffer) -------------------------------------

    def push(self, elem: Any, advance: jax.Array | None = None) -> "StreamBuffer":
        """Append; evicts the oldest element when full (reference
        StreamBuffer::push/advance).

        `advance` (traced bool, default always-true) gates the COUNTERS only:
        when false, `elem` is still written — to the slot a normal push would
        use, which when full holds the already-evicted previous oldest and
        when not-full is free — but start/count stay put, so the window's
        contents survive and the write is reclaimed by the next advancing
        push.  This makes a conditional push O(1) with zero extra data
        movement (a `where` over the buffer pytree would copy the whole
        window — ~70 MB/step for the 1080p frame delay queue); the cost is
        that `oldest()` after a full non-advancing push returns `elem`
        itself, which delay-queue callers want anyway (an invalid bubble in,
        an invalid output tick out).
        """
        # When not full we write at logical index `count`; when full the write
        # lands on the oldest slot, which then becomes the newest.
        full = self.is_full()
        write_slot = jax.lax.select(
            full, self.start, jax.lax.rem(self.start + self.count, self.capacity)
        )
        new_data = jax.tree.map(lambda d, e: _update_leaf(d, e, write_slot), self.data, elem)
        new_start = jax.lax.select(
            full, jax.lax.rem(self.start + 1, self.capacity), self.start
        )
        new_count = jax.lax.select(full, self.count, self.count + 1)
        if advance is not None:
            adv = jnp.asarray(advance, jnp.bool_)
            new_start = jax.lax.select(adv, new_start, self.start)
            new_count = jax.lax.select(adv, new_count, self.count)
        return self.replace(data=new_data, start=new_start, count=new_count)

    def skip(self, n: int | jax.Array = 1) -> "StreamBuffer":
        """Drop the n oldest elements (reference StreamBuffer::skip)."""
        n = jnp.minimum(jnp.asarray(n, jnp.int32), self.count)
        return self.replace(
            start=jax.lax.rem(self.start + n, self.capacity), count=self.count - n
        )

    def clear(self) -> "StreamBuffer":
        return self.replace(
            start=jnp.zeros((), jnp.int32), count=jnp.zeros((), jnp.int32)
        )

    # ---- access ------------------------------------------------------------

    def get(self, logical: int | jax.Array) -> Any:
        """Element at logical index (0 = oldest)."""
        slot = self._slot(jnp.asarray(logical, jnp.int32))
        return jax.tree.map(
            lambda d: jax.lax.dynamic_index_in_dim(d, slot, 0, keepdims=False),
            self.data,
        )

    def oldest(self) -> Any:
        return self.get(0)

    def newest(self) -> Any:
        return self.get(jnp.maximum(self.count - 1, 0))

    def centre(self) -> Any:
        """Middle element of the current window (reference
        StreamBuffer::centre, used as the smoothing anchor)."""
        return self.get(jnp.maximum((self.count - 1) // 2, 0))

    # ---- kernels -----------------------------------------------------------

    def logical_weights(self, weights: jax.Array) -> jax.Array:
        """Map logical-position weights (index 0 = oldest) onto physical
        slots: w_phys[slot] = w_logical[(slot - start) mod capacity]."""
        return jnp.roll(weights, self.start)

    def convolve(self, weights: jax.Array) -> Any:
        """Weighted sum over the window: sum_i w[i] * elem[i] with w indexed
        logically (reference StreamBuffer::convolve_at, StreamBuffer.tpp:384+).
        Caller is responsible for zeroing weights beyond `count` (or for only
        convolving when full).  One tensordot per leaf — the weights are
        rolled, not the data."""
        w = self.logical_weights(weights)
        return jax.tree.map(
            lambda d: jnp.tensordot(
                w.astype(d.dtype), d, axes=(0, 0), precision=lax.Precision.HIGHEST
            ),
            self.data,
        )

    def window_valid_mask(self) -> jax.Array:
        """(capacity,) float mask of logically-valid positions."""
        idx = jnp.arange(self.capacity)
        return (idx < self.count).astype(jnp.float32)
