"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a frozen dataclass whose fields are pytree children unless
declared with `field(static=True)`; static fields are hashable metadata that
jit treats as compile-time constants. `replace(**changes)` returns a copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """dataclasses.field, with `static=True` marking a non-pytree field."""
    if static:
        kwargs["metadata"] = dict(kwargs.get("metadata") or {}, static=True)
    return dataclasses.field(**kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
