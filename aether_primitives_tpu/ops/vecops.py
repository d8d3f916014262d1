"""Element-wise complex vector kernels ("VecOps").

Functional re-design of the reference's ``VecOps`` trait
(reference src/vecops.rs:39-332). The reference chains in-place mutations of
a ``Vec<cf32>``; on an accelerator the idiomatic form is *functional*: each op returns a
new (traced) array and XLA fuses the whole chain into a single elementwise kernel
under ``jit`` — there is no per-op memory traffic to save by hand.

Two API levels:

- **functional** module-level ops (``scale``, ``mul``, ``div``, ``conj``,
  ``mirror``, ``add``, ``sub``, ``zero``, ``clone``, ``mutate``) — use these
  inside your own jitted code;
- :class:`CVec` — a chainable wrapper mirroring the reference's fluent API
  (``v.vec_scale(2.0).vec_mul(o).vec_conj().vec_mirror()``), registered as a
  JAX pytree so it passes through ``jit``/``vmap`` transparently.

All ops operate on the **last axis** and broadcast over leading batch axes.
Binary ops require equal trailing lengths (the reference asserts equal
lengths, e.g. src/vecops.rs:100-104; it also had a vestigial truncate-to-min
in ``vec_mul``, src/vecops.rs:106-111, which we do not reproduce — SURVEY.md
§2 quirk 6).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..types import cf32


def _check_same_len(a: jnp.ndarray, b: jnp.ndarray) -> None:
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(
            f"Vectors must have same length (got {a.shape[-1]} and {b.shape[-1]})"
        )


def scale(x: jnp.ndarray, s) -> jnp.ndarray:
    """Scale by a real scalar (reference ``vec_scale``, src/vecops.rs:41)."""
    x = jnp.asarray(x)
    return x * jnp.asarray(s, dtype=jnp.float32)


def mul(x: jnp.ndarray, other) -> jnp.ndarray:
    """Element-wise complex multiply (reference ``vec_mul``, src/vecops.rs:44)."""
    x = jnp.asarray(x)
    other = jnp.asarray(other)
    _check_same_len(x, other)
    return x * other


def div(x: jnp.ndarray, other) -> jnp.ndarray:
    """Element-wise complex divide (reference ``vec_div``, src/vecops.rs:47)."""
    x = jnp.asarray(x)
    other = jnp.asarray(other)
    _check_same_len(x, other)
    return x / other


def conj(x: jnp.ndarray) -> jnp.ndarray:
    """Conjugate each element (reference ``vec_conj``, src/vecops.rs:50)."""
    return jnp.conj(jnp.asarray(x))


def mirror(x: jnp.ndarray) -> jnp.ndarray:
    """Swap elements around the midpoint of the last axis.

    Matches reference ``vec_mirror`` (src/vecops.rs:157-161) exactly: with
    ``mid = n // 2``, element ``i`` swaps with ``i + mid`` for ``i < mid``.
    For even ``n`` this is a half-length rotation (== fftshift); for odd
    ``n`` the final element stays in place (the reference documents "assumes
    an even number of elements" but this is its actual behavior).
    Test vector from the reference: ``[0,1,2,3] -> [2,3,0,1]``
    (src/vecops.rs:396-405).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    mid = n // 2
    if n % 2 == 0:
        return jnp.roll(x, mid, axis=-1)
    head = jnp.roll(x[..., : 2 * mid], mid, axis=-1)
    return jnp.concatenate([head, x[..., 2 * mid :]], axis=-1)


def clone(other) -> jnp.ndarray:
    """Functional stand-in for reference ``vec_clone`` (src/vecops.rs:58).

    In a functional framework a copy is just the value itself; provided for
    API parity and for breaking unwanted aliasing with donated buffers.
    """
    return jnp.asarray(other)


def zero(x: jnp.ndarray) -> jnp.ndarray:
    """Zero the elements (reference ``vec_zero``, src/vecops.rs:61)."""
    return jnp.zeros_like(jnp.asarray(x))


def mutate(x: jnp.ndarray, f: Callable[[jnp.ndarray], jnp.ndarray]) -> jnp.ndarray:
    """Apply an element-wise function (reference ``vec_mutate``, src/vecops.rs:64).

    ``f`` receives the whole array and must act element-wise (vectorized
    form of the reference's ``FnMut(&mut cf32)``). For index-dependent
    mutation use :func:`mutate_indexed`.
    """
    return f(jnp.asarray(x))


def mutate_indexed(
    x: jnp.ndarray, f: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
) -> jnp.ndarray:
    """Apply ``f(values, indices)`` element-wise over the last axis.

    Covers the reference's stateful-closure uses of ``vec_mutate`` (its unit
    test scales element ``i`` by ``i``, src/vecops.rs:441-455) without
    serializing: the index vector is materialized instead of threading
    mutable state.
    """
    x = jnp.asarray(x)
    idx = jnp.arange(x.shape[-1])
    return f(x, idx)


def add(x: jnp.ndarray, other) -> jnp.ndarray:
    """Element-wise add (reference ``vec_add``, src/vecops.rs:67)."""
    x = jnp.asarray(x)
    other = jnp.asarray(other)
    _check_same_len(x, other)
    return x + other


def sub(x: jnp.ndarray, other) -> jnp.ndarray:
    """Element-wise subtract (reference ``vec_sub``, src/vecops.rs:70)."""
    x = jnp.asarray(x)
    other = jnp.asarray(other)
    _check_same_len(x, other)
    return x - other


@jax.tree_util.register_pytree_node_class
class CVec:
    """Chainable complex sample vector, mirroring the reference's fluent API.

    Functional: every ``vec_*`` method returns a **new** ``CVec``; under
    ``jit`` the whole chain fuses into one kernel. FFT methods take the
    :class:`~aether_primitives_tpu.ops.fft.Scale` policy exactly like the
    reference (``vec_fft``/``vec_ifft`` plan-on-the-fly vs
    ``vec_rfft``/``vec_rifft`` with a reusable plan, src/vecops.rs:73-88 —
    here "plan" is a cached jitted transform, so the one-shot variants are
    equally fast after first trace).

    >>> import numpy as np
    >>> twos = np.full(4, 2 + 2j, dtype=np.complex64)
    >>> ones = np.ones(4, dtype=np.complex64)
    >>> v = CVec(np.full(4, 2 + 2j, dtype=np.complex64))
    >>> out = v.vec_div(twos).vec_mul(twos).vec_zero().vec_add(ones).array
    >>> np.asarray(out).tolist()
    [(1+0j), (1+0j), (1+0j), (1+0j)]
    """

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = jnp.asarray(array, dtype=cf32)

    # -- pytree plumbing ---------------------------------------------------
    def tree_flatten(self):
        return (self.array,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.array = children[0]
        return obj

    # -- reference VecOps surface -----------------------------------------
    def vec_scale(self, s) -> "CVec":
        return CVec(scale(self.array, s))

    def vec_mul(self, other) -> "CVec":
        return CVec(mul(self.array, _arr(other)))

    def vec_div(self, other) -> "CVec":
        return CVec(div(self.array, _arr(other)))

    def vec_conj(self) -> "CVec":
        return CVec(conj(self.array))

    def vec_mirror(self) -> "CVec":
        return CVec(mirror(self.array))

    def vec_clone(self, other) -> "CVec":
        return CVec(clone(_arr(other)))

    def vec_zero(self) -> "CVec":
        return CVec(zero(self.array))

    def vec_mutate(self, f) -> "CVec":
        return CVec(mutate(self.array, f))

    def vec_add(self, other) -> "CVec":
        return CVec(add(self.array, _arr(other)))

    def vec_sub(self, other) -> "CVec":
        return CVec(sub(self.array, _arr(other)))

    def vec_fft(self, scale_policy) -> "CVec":
        from . import fft as _fft

        return CVec(_fft.fft(self.array, scale_policy))

    def vec_ifft(self, scale_policy) -> "CVec":
        from . import fft as _fft

        return CVec(_fft.ifft(self.array, scale_policy))

    def vec_rfft(self, plan, scale_policy) -> "CVec":
        return CVec(plan.fwd(self.array, scale_policy))

    def vec_rifft(self, plan, scale_policy) -> "CVec":
        return CVec(plan.bwd(self.array, scale_policy))

    # -- conveniences ------------------------------------------------------
    def __len__(self) -> int:
        return self.array.shape[-1]

    def __repr__(self) -> str:
        return f"CVec({self.array!r})"


def _arr(x):
    return x.array if isinstance(x, CVec) else x
