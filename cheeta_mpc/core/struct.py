"""Frozen pytree dataclasses.

``@dataclass`` turns a class into a frozen :mod:`dataclasses` dataclass
registered with :func:`jax.tree_util.register_dataclass`: fields are pytree
leaves unless declared with ``field(pytree_node=False)``, in which case they
are static metadata (part of the treedef, hence of jit cache keys).
Instances are immutable; ``obj.replace(**kw)`` returns a modified copy.
"""

from __future__ import annotations

import dataclasses
import typing

import jax

_T = typing.TypeVar("_T")


def field(pytree_node: bool = True, **kwargs):
    """A :func:`dataclasses.field` that records whether it is a pytree leaf
    (``pytree_node=True``) or static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    """A copy of ``self`` with the given fields replaced."""
    return dataclasses.replace(self, **updates)


@typing.dataclass_transform(field_specifiers=(field,))
def dataclass(cls: type[_T]) -> type[_T]:
    """Frozen dataclass registered as a pytree (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields, meta_fields = [], []
    for f in dataclasses.fields(cls):
        if f.metadata.get("pytree_node", True):
            data_fields.append(f.name)
        else:
            meta_fields.append(f.name)
    cls.replace = _replace
    jax.tree_util.register_dataclass(cls, data_fields, meta_fields)
    return cls
