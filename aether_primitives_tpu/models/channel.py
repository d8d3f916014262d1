"""Channel simulation: composable RF impairments for link testing.

Every receiver block in the framework is validated against a channel;
this module makes those channels first-class instead of hand-rolled test
fixtures. All impairments are pure functions of ``(key, x)`` (counter-
based randomness — the framework's determinism policy, cf.
:mod:`~..ops.noise`), batched, and jittable, so a whole Monte-Carlo
BER sweep is one vmapped compiled graph.

Impairments:

- :func:`delay_pad` — burst placement at an offset inside a capture;
- :func:`multipath` — static FIR channel (linear convolution);
- :func:`rayleigh_block` — iid block fading (complex Gaussian gain);
- :func:`jakes` — time-varying flat Rayleigh fading with the classic
  Clarke/Jakes Doppler spectrum via sum-of-sinusoids (one broadcast
  reduction — no filtering recursion);
- :func:`cfo` / :func:`phase_noise` — carrier rotation / Wiener phase
  random walk (one cumsum);
- :func:`iq_imbalance` / :func:`dc_offset` — front-end impairments
  (the inverses live in :mod:`~..ops.frontend`);
- :func:`pa_saturate` — Rapp-model power-amplifier compression;
- :class:`Channel` — a config-driven composition of all of the above
  ending in AWGN.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fir as _fir
from ..ops import noise as _noise
from ..types import cf32


def delay_pad(x, offset: int, total_len: int) -> jnp.ndarray:
    """Place a burst at ``offset`` inside a zero capture of
    ``total_len`` samples (static shapes; offset may be traced)."""
    x = jnp.asarray(x, dtype=cf32)
    cap = jnp.zeros(x.shape[:-1] + (total_len,), cf32)
    return jax.lax.dynamic_update_slice_in_dim(
        cap, x, jnp.asarray(offset, jnp.int32), axis=-1
    )


def multipath(x, taps) -> jnp.ndarray:
    """Static multipath: linear convolution with complex channel taps
    (causal; output same length, later echoes spill off the end).
    Short-tap path of :func:`~..ops.fir.fir_filter`."""
    t = np.asarray(taps, dtype=np.complex64)
    return _fir.fir_filter(jnp.asarray(x, dtype=cf32), t)


def rayleigh_block(key, x, block_len: int) -> jnp.ndarray:
    """IID block fading: one CN(0, 1) gain per ``block_len`` samples
    (quasi-static channel — the fade is constant within a block,
    independent across blocks). Length must divide by ``block_len``."""
    x = jnp.asarray(x, dtype=cf32)
    n = x.shape[-1]
    if n % block_len:
        raise ValueError(f"length {n} not divisible by block_len {block_len}")
    nb = n // block_len
    g = jax.random.normal(key, x.shape[:-1] + (nb, 2), jnp.float32)
    gain = jax.lax.complex(g[..., 0], g[..., 1]) / np.sqrt(2.0)
    frames = x.reshape(x.shape[:-1] + (nb, block_len))
    return (frames * gain[..., None]).reshape(x.shape).astype(cf32)


def jakes(key, n: int, doppler: float, n_paths: int = 32) -> jnp.ndarray:
    """Time-varying flat Rayleigh fading, Clarke/Jakes Doppler spectrum.

    Sum-of-sinusoids: ``h[t] = (1/sqrt(M)) sum_m e^{j(2 pi f_d cos(a_m) t
    + phi_m)}`` with uniform arrival angles and phases — unit mean power,
    envelope Rayleigh, autocorrelation ``J0(2 pi f_d tau)`` as M grows.
    ``doppler`` in cycles/sample. One ``[M, n]`` broadcast + reduction
    (elementwise work), no IIR spectral-shaping recursion to serialize.
    """
    ka, kp = jax.random.split(key)
    alpha = jax.random.uniform(ka, (n_paths,), jnp.float32, 0.0, 2.0 * np.pi)
    phi = jax.random.uniform(kp, (n_paths,), jnp.float32, 0.0, 2.0 * np.pi)
    t = jnp.arange(n, dtype=jnp.float32)
    ang = (
        2.0 * jnp.pi * doppler * jnp.cos(alpha)[:, None] * t[None, :]
        + phi[:, None]
    )
    h = jnp.sum(jax.lax.complex(jnp.cos(ang), jnp.sin(ang)), axis=0)
    return (h / np.sqrt(n_paths)).astype(cf32)


def cfo(x, cycles_per_sample: float, phase0: float = 0.0) -> jnp.ndarray:
    """Carrier frequency offset: rotate by ``e^{j(2 pi f n + phase0)}``."""
    x = jnp.asarray(x, dtype=cf32)
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    ang = 2.0 * jnp.pi * cycles_per_sample * n + phase0
    return (x * jax.lax.complex(jnp.cos(ang), jnp.sin(ang))).astype(cf32)


def phase_noise(key, x, linewidth: float) -> jnp.ndarray:
    """Wiener (random-walk) oscillator phase noise: per-sample phase
    increments N(0, 2 pi linewidth) — ``linewidth`` is the normalized
    3-dB linewidth in cycles/sample (sigma^2 = 2 pi * linewidth per
    step). One cumsum."""
    x = jnp.asarray(x, dtype=cf32)
    dphi = jax.random.normal(key, x.shape, jnp.float32) * jnp.sqrt(
        2.0 * jnp.pi * linewidth
    )
    walk = jnp.cumsum(dphi, axis=-1)
    return (x * jax.lax.complex(jnp.cos(walk), jnp.sin(walk))).astype(cf32)


def iq_imbalance(x, amp_db: float = 0.0, phase_deg: float = 0.0) -> jnp.ndarray:
    """Receiver IQ imbalance: gain mismatch ``amp_db`` and quadrature
    skew ``phase_deg`` between the I and Q rails — the impairment
    :func:`~..ops.frontend.iq_correct` removes. Standard model:
    ``y = mu * x + nu * conj(x)`` with ``mu = cos(e) + j g sin(e)``,
    ``nu = g cos(e) - j sin(e)`` ... implemented directly on the rails:
    ``I' = I``, ``Q' = g (Q cos(e) - I sin(e))`` with
    ``g = 10^(amp_db/20)``, ``e = phase_deg`` in radians."""
    x = jnp.asarray(x, dtype=cf32)
    g = 10.0 ** (amp_db / 20.0)
    e = np.deg2rad(phase_deg)
    i, q = jnp.real(x), jnp.imag(x)
    q2 = g * (q * np.cos(e) - i * np.sin(e))
    return jax.lax.complex(i, q2).astype(cf32)


def dc_offset(x, offset: complex) -> jnp.ndarray:
    """Additive LO-leakage DC term."""
    x = jnp.asarray(x, dtype=cf32)
    off = np.complex64(offset)
    return (x + jnp.asarray(off.real) + 1j * jnp.asarray(off.imag)).astype(cf32)


def pa_saturate(x, sat_level: float = 1.0, p: float = 2.0) -> jnp.ndarray:
    """Rapp solid-state PA model: AM/AM compression
    ``|y| = |x| / (1 + (|x|/A)^{2p})^{1/(2p)}`` (phase preserved).
    ``p -> inf`` is a hard limiter; ``p ~ 2`` a typical SSPA."""
    x = jnp.asarray(x, dtype=cf32)
    mag = jnp.abs(x)
    comp = (1.0 + (mag / sat_level) ** (2.0 * p)) ** (1.0 / (2.0 * p))
    return (x / jnp.maximum(comp, 1e-30)).astype(cf32)


@dataclass(frozen=True)
class ChannelConfig:
    """Composition order: PA -> multipath -> fading -> delay ->
    CFO -> phase noise -> IQ imbalance -> DC -> AWGN (TX impairments
    first, propagation, then RX front-end, matching a real chain)."""

    taps: Optional[Tuple[complex, ...]] = None
    doppler: float = 0.0  # Jakes fading when > 0 (cycles/sample)
    delay: int = 0
    capture_len: Optional[int] = None  # None: len(x) + delay
    cfo: float = 0.0
    phase0: float = 0.0
    linewidth: float = 0.0  # Wiener phase noise
    iq_amp_db: float = 0.0
    iq_phase_deg: float = 0.0
    dc: complex = 0j
    sat_level: float = 0.0  # 0: no PA model
    noise_power: float = 0.0


class Channel:
    """Config-driven impairment chain: ``Channel(cfg).apply(key, x)``."""

    def __init__(self, config: ChannelConfig = ChannelConfig()):
        self.config = config

    def apply(self, key, x) -> jnp.ndarray:
        c = self.config
        x = jnp.asarray(x, dtype=cf32)
        k_fade, k_pn, k_awgn = jax.random.split(key, 3)
        if c.sat_level > 0.0:
            x = pa_saturate(x, c.sat_level)
        if c.taps is not None:
            x = multipath(x, np.asarray(c.taps, np.complex64))
        if c.doppler > 0.0:
            x = (x * jakes(k_fade, x.shape[-1], c.doppler)).astype(cf32)
        total = c.capture_len or (x.shape[-1] + c.delay)
        if c.delay or c.capture_len:
            x = delay_pad(x, c.delay, total)
        if c.cfo or c.phase0:
            x = cfo(x, c.cfo, c.phase0)
        if c.linewidth > 0.0:
            x = phase_noise(k_pn, x, c.linewidth)
        if c.iq_amp_db or c.iq_phase_deg:
            x = iq_imbalance(x, c.iq_amp_db, c.iq_phase_deg)
        if c.dc:
            x = dc_offset(x, c.dc)
        if c.noise_power > 0.0:
            x = _noise.apply(k_awgn, x, c.noise_power)
        return x
