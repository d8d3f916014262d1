"""AWGN generation and injection.

Data-parallel equivalent of the reference's ``Awgn`` sampler
(reference src/noise.rs): seeded, deterministic complex white Gaussian
noise with per-component std ``sqrt(power)``.

Design decisions (SURVEY.md §7):

- the serial ``StdRng`` stream becomes JAX's counter-based threefry PRNG —
  deterministic for a fixed seed and call sequence, massively parallel on
  device. Streams cannot match the Rust reference bit-for-bit (different
  PRNG); cross-implementation tests therefore assert *statistics* and
  bit-exact modem round-trips, not sample equality;
- **single-scale convention**: noise added by :meth:`Awgn.apply` has
  per-component std ``sqrt(power)``, i.e. complex noise power ``2*power``
  exactly like ``next()``/``fill``/``iter`` in the reference. The
  reference's ``apply`` alone scales a *second* time (std ``power``,
  reference src/noise.rs:53-59 — SURVEY.md §2 quirk 2); we do not reproduce
  that bug.

Functional core + a thin stateful wrapper mirroring the reference's
generator object API (``generator()``, ``new``, ``apply``, ``fill``,
``set_power``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import cf32

DEFAULT_RNG_SEED = 815  # reference src/noise.rs:6


def awgn(key, shape, power=1.0) -> jnp.ndarray:
    """Pure-function complex AWGN block: each component ~ N(0, power).

    ``power`` may be a python float or a traced scalar.
    """
    re_key, im_key = jax.random.split(key)
    scale = jnp.sqrt(jnp.asarray(power, dtype=jnp.float32))
    re = jax.random.normal(re_key, shape, dtype=jnp.float32)
    im = jax.random.normal(im_key, shape, dtype=jnp.float32)
    return (jax.lax.complex(re, im) * scale).astype(cf32)


def apply(key, signal, power=1.0) -> jnp.ndarray:
    """Pure-function noise overlay: ``signal + awgn(key, signal.shape, power)``."""
    signal = jnp.asarray(signal, dtype=cf32)
    return signal + awgn(key, signal.shape, power)


class Awgn:
    """Stateful AWGN generator mirroring the reference object API.

    Deterministic: a fixed ``(power, seed)`` and call sequence always
    produces the same noise. Each call consumes one split of the internal
    key, the counter-based analog of advancing ``StdRng``.
    """

    def __init__(self, power: float = 1.0, seed: int = DEFAULT_RNG_SEED):
        self.power = float(power)
        self._key = jax.random.key(seed)

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def set_power(self, power: float) -> None:
        """Change the noise power (reference src/noise.rs:47-50)."""
        self.power = float(power)

    def next_block(self, shape) -> jnp.ndarray:
        """A block of noise samples (vectorized ``next()``/``NoiseIter``)."""
        if isinstance(shape, int):
            shape = (shape,)
        return awgn(self._next_key(), tuple(shape), self.power)

    def apply(self, signal) -> jnp.ndarray:
        """Overlay the signal with noise (single-scale convention; see
        module docstring for the deliberate divergence from reference
        src/noise.rs:53-59)."""
        return apply(self._next_key(), signal, self.power)

    def fill(self, n: int) -> jnp.ndarray:
        """A length-``n`` noise vector (reference ``fill``, src/noise.rs:62-66)."""
        return self.next_block((int(n),))

    def iter(self, block: int = 4096):
        """Infinite generator of noise blocks — the block-vectorized
        equivalent of the reference's per-sample ``NoiseIter``
        (src/noise.rs:68-85)."""
        while True:
            yield self.next_block((int(block),))


def generator() -> Awgn:
    """Default AWGN generator: power 1, seed 815 (reference src/noise.rs:8-11)."""
    return Awgn(1.0, DEFAULT_RNG_SEED)


def new(power: float, seed: int) -> Awgn:
    """AWGN generator with given power and seed (reference src/noise.rs:14-16)."""
    return Awgn(power, seed)
