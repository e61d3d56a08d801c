"""Immutable dataclass pytrees for the engine's state and value types.

Subclassing `PyTreeNode` turns a class into a frozen dataclass registered
with `jax.tree_util.register_dataclass`, so instances flow through `jit`,
`vmap`, `scan` carries and `shard_map` like tuples.  Fields declared with
`field(static=True)` are metadata: part of the tree structure (and of the
jit cache key), never traced.  `replace` returns a copy with some fields
swapped, the functional update every state transition uses.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax


def field(*, static: bool = False, **kwargs) -> Any:
    """A dataclass field; `static=True` keeps it out of the traced leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


class PyTreeNode:
    """Base class: subclasses become frozen, pytree-registered dataclasses."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self, **updates) -> Any:
        return dataclasses.replace(self, **updates)
