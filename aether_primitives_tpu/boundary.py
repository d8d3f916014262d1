"""f32 host↔device boundary for complex sample blocks.

Radio front ends and sample files deliver I/Q as real planes or
interleaved real pairs, and a device function with real-f32 arguments
runs unchanged on every backend. Where a caller keeps samples in that
form, the rule is:

    **device function signatures are real-f32; complex lives only inside
    the trace.**

:class:`Split` is the boundary container — a registered pytree holding
``re``/``im`` float32 planes (each plane contiguous, unlike interleaved
pairs). Use :func:`f32_boundary` to wrap
any complex-in/complex-out function into a split-signature function safe to
``jit`` on any backend, and :func:`split` / :func:`merge` to convert at the
host edge (numpy complex64 files <-> Split planes is a free view/stack).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class Split:
    """A complex block as split re/im f32 planes (boundary-safe)."""

    re: Any
    im: Any

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return jnp.shape(self.re)

    def to_complex(self):
        """Merge into a complex64 array — call only inside a trace or on CPU."""
        return jax.lax.complex(
            jnp.asarray(self.re, jnp.float32), jnp.asarray(self.im, jnp.float32)
        )

    def numpy(self) -> np.ndarray:
        """Host-side merge to a numpy complex64 array."""
        re = np.asarray(self.re, dtype=np.float32)
        im = np.asarray(self.im, dtype=np.float32)
        return re + 1j * im


def split(x) -> Split:
    """Host-side: complex array-like -> :class:`Split` f32 planes.

    Large contiguous complex64 blocks go through the native deinterleave
    hot loop (:mod:`aether_primitives_tpu.native`) — this runs once per
    staged block in the streaming feeder.
    """
    arr = np.asarray(x)
    if (
        arr.dtype == np.complex64
        and arr.size >= (1 << 16)
        and arr.flags.c_contiguous
    ):
        from . import native

        re, im = native.deinterleave(arr)
        return Split(re, im)
    return Split(
        np.ascontiguousarray(arr.real, dtype=np.float32),
        np.ascontiguousarray(arr.imag, dtype=np.float32),
    )


def merge(s: Split) -> np.ndarray:
    return s.numpy() if isinstance(s, Split) else np.asarray(s)


def _is_complex(x) -> bool:
    return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.complexfloating)


def tree_split(tree):
    """Replace every complex leaf with a :class:`Split` (trace- or host-side)."""
    return jax.tree_util.tree_map(
        lambda x: Split(jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))
        if _is_complex(x)
        else x,
        tree,
    )


def tree_merge(tree):
    """Replace every :class:`Split` leaf with a complex array (inside trace)."""
    return jax.tree_util.tree_map(
        lambda x: x.to_complex() if isinstance(x, Split) else x,
        tree,
        is_leaf=lambda x: isinstance(x, Split),
    )


def f32_boundary(fn: Callable) -> Callable:
    """Wrap a complex-signature function into a split-signature one.

    The wrapped function accepts/returns pytrees whose :class:`Split` leaves
    stand in for the original complex leaves; complex values exist only
    inside the computation. Safe to ``jax.jit`` on backends that cannot
    transfer complex arrays.
    """

    def wrapped(*args, **kwargs):
        args = tree_merge(args)
        kwargs = tree_merge(kwargs)
        out = fn(*args, **kwargs)
        return tree_split(out)

    wrapped.__name__ = getattr(fn, "__name__", "wrapped") + "_f32"
    return wrapped
