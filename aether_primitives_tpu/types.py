"""Core sample types and block conventions.

The reference defines ``cf32 = num_complex::Complex32`` with a documented
interleaved-f32 ``repr(C)`` layout (reference src/lib.rs:8-17). The JAX
equivalent is ``jnp.complex64``: numpy/JAX complex64 arrays are the same
back-to-back ``(re: f32, im: f32)`` layout in host memory, so binary sample
files interoperate bit-for-bit (see :mod:`aether_primitives_tpu.utils.file`).

On device, XLA stores complex64 as split or interleaved planes as it sees
fit; code that needs real planes (a kernel without a complex dtype, an
f32 file) uses :func:`split_complex` / :func:`merge_complex`.

Block convention: sample vectors are the **last axis** of an array; every op
in :mod:`~aether_primitives_tpu.ops` is batched over all leading axes so that
large batches keep the device full.
"""

from __future__ import annotations

import jax.numpy as jnp

# The default sample dtype: interleaved (f32, f32) on the host, matching the
# reference's repr(C) contract (reference src/lib.rs:10).
cf32 = jnp.complex64

# Double-precision alias for parity with the reference (src/lib.rs:17). The
# reference itself never uses cf64; on accelerators f64 is slow, so this
# exists for host-side golden computation only.
cf64 = jnp.complex128


def as_cf32(x) -> jnp.ndarray:
    """Coerce array-like input to a complex64 JAX array."""
    return jnp.asarray(x, dtype=cf32)


def split_complex(x):
    """Split a complex array into an (re, im) pair of f32 arrays.

    The layout for kernels without a native complex dtype (SURVEY.md §7
    hard part #1).
    """
    x = jnp.asarray(x)
    return jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)


def merge_complex(re, im) -> jnp.ndarray:
    """Merge split re/im f32 arrays back into a complex64 array."""
    return jax_lax_complex(re, im)


def jax_lax_complex(re, im):
    import jax.lax as lax

    return lax.complex(jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32))
