"""Frozen pytree dataclasses: the engine's state and config containers.

`@dataclass` makes a frozen `dataclasses.dataclass`, registers it with
`jax.tree_util.register_dataclass` and gives it a `.replace(**updates)`.
Fields declared with `field(pytree_node=False)` are static: they live in
the treedef (hashed into jit cache keys), not among the leaves.

    @struct.dataclass
    class Config:
        gains: jnp.ndarray
        horizon: int = struct.field(pytree_node=False, default=10)
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

_T = TypeVar("_T")


def field(pytree_node: bool = True, **kwargs):
    """`dataclasses.field` with a `pytree_node` flag (False = static)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **updates):
    """A copy with the given fields replaced."""
    return dataclasses.replace(self, **updates)


def dataclass(clz: type[_T]) -> type[_T]:
    """Frozen dataclass registered as a pytree (see module docstring)."""
    data_clz = dataclasses.dataclass(frozen=True)(clz)
    data_fields, meta_fields = [], []
    for f in dataclasses.fields(data_clz):
        (data_fields if f.metadata.get("pytree_node", True)
         else meta_fields).append(f.name)
    data_clz.replace = _replace
    jax.tree_util.register_dataclass(data_clz, data_fields, meta_fields)
    return data_clz
