"""Chirp spread spectrum (CSS, LoRa-style) modem.

Long-range low-SNR links spread each ``SF``-bit symbol over ``N = 2^SF``
chips of a linear chirp: symbol ``s`` is the base upchirp cyclically
shifted by ``s`` chips. The receiver multiplies by the conjugate base
chirp ("dechirp"), which collapses every symbol to a pure tone at bin
``s`` — so demodulation is ONE batched FFT plus an argmax, and the link
works far below the per-chip noise floor (processing gain ≈
``10 log10(N)`` dB).

Shape: modulation is an exact-integer-mod phase table (the quadratic
chirp phase and the per-symbol tone both reduce mod ``N`` in int32
before the trig, so f32 never sees a large argument — the same
exact-mod discipline as the NCO in :mod:`~..ops.frontend`), and
demodulation is the framework's batched FFT over ``[n_sym, N]``
frames. No scans, no gathers on the device data path.

Identity used: for even ``N``, ``u[(k+s) mod N] = u[s] * u[k] *
e^{j 2 pi s k / N}`` with ``u[k] = e^{j pi k^2 / N}`` — the cyclic shift
IS a tone, which is why dechirp + FFT demodulates exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fft as _fft
from ..ops.fft import Scale
from ..types import cf32


@dataclass(frozen=True)
class CssConfig:
    sf: int = 8  # spreading factor: 2^sf chips/symbol, sf bits/symbol
    fft_backend: str = None

    @property
    def n_chips(self) -> int:
        return 1 << self.sf


class CssModem:
    """CSS modulator/demodulator for a given spreading factor.

    ``tx(bits)``: ``sf``-bit LSB-first symbols -> shifted-upchirp blocks
    (``[..., n_sym * N]`` complex chips). ``rx(chips)``: dechirp,
    frame-FFT, argmax -> bits. ``demod_symbols`` exposes the raw symbol
    decisions and peak magnitudes (a per-symbol confidence)."""

    def __init__(self, config: CssConfig = CssConfig()):
        self.config = config
        n = config.n_chips
        k = np.arange(n, dtype=np.int64)
        # base upchirp e^{j pi k^2 / N}: phase in half-turns = k^2 / N,
        # reduced mod 2 N in exact integers before the division
        ph = (k * k) % (2 * n)
        self._upchirp = np.exp(1j * np.pi * ph / n).astype(np.complex64)

    # ------------------------------------------------------------ TX

    def tx(self, bits) -> jnp.ndarray:
        cfg = self.config
        sf, n = cfg.sf, cfg.n_chips
        b = jnp.asarray(bits).astype(jnp.int32) % 2
        if b.shape[-1] % sf:
            raise ValueError(f"bit count must divide by sf = {sf}")
        groups = b.reshape(b.shape[:-1] + (-1, sf))
        weights = jnp.asarray(2 ** np.arange(sf), jnp.int32)
        sym = jnp.sum(groups * weights, axis=-1)  # [..., n_sym] LSB-first
        return self.modulate_symbols(sym)

    def modulate_symbols(self, symbols) -> jnp.ndarray:
        """Symbols in [0, N) -> chips. Phase built as exact int32 mod-N
        products; one elementwise exp per block."""
        n = self.config.n_chips
        s = jnp.asarray(symbols, jnp.int32)
        k = jnp.arange(n, dtype=jnp.int32)
        # tone phase (s k mod N)/N turns + shift phase (s^2 mod 2N)/2N
        tone = (s[..., None] * k[None, :]) % n  # int32: s k < N^2 <= 2^30
        ang = 2.0 * jnp.pi * tone.astype(jnp.float32) / n
        shift_ph = (s * s) % (2 * n)
        ang = ang + jnp.pi * shift_ph.astype(jnp.float32)[..., None] / n
        chips = jax.lax.complex(jnp.cos(ang), jnp.sin(ang)) * jnp.asarray(
            self._upchirp
        )
        return chips.reshape(chips.shape[:-2] + (-1,)).astype(cf32)

    # ------------------------------------------------------------ RX

    def demod_symbols(self, chips):
        """(symbols, peak_magnitude) per frame — dechirp, batched FFT,
        argmax. ``peak_magnitude`` is normalized to 1.0 for clean input."""
        cfg = self.config
        n = cfg.n_chips
        x = jnp.asarray(chips, dtype=cf32)
        if x.shape[-1] % n:
            raise ValueError(f"chip count must divide by N = {n}")
        frames = x.reshape(x.shape[:-1] + (-1, n))
        d = frames * jnp.conj(jnp.asarray(self._upchirp))
        plan = _fft.plan(n, cfg.fft_backend)
        spec = plan.fwd(d, Scale.NONE)
        mag = jnp.abs(spec)
        sym = jnp.argmax(mag, axis=-1).astype(jnp.int32)
        peak = jnp.take_along_axis(mag, sym[..., None], axis=-1)[..., 0] / n
        return sym, peak

    def rx(self, chips) -> jnp.ndarray:
        cfg = self.config
        sym, _ = self.demod_symbols(chips)
        bit_idx = jnp.arange(cfg.sf, dtype=jnp.int32)
        bits = (sym[..., None] >> bit_idx) & 1  # LSB-first
        return bits.reshape(bits.shape[:-2] + (-1,)).astype(jnp.uint8)

    def loopback(self, bits) -> jnp.ndarray:
        return self.rx(self.tx(bits))
