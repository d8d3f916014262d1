"""Cyclic-prefix OFDM: modulator, demodulator, and CP-based timing/CFO
synchronization.

The framework's TX/RX chains (:mod:`.modem`) are OFDM-*like* (per-frame
FFT, active-bin guard bands, one-tap pilot equalizer) but stream through
pulse-shaping FIRs with no cyclic prefix; this module is the textbook CP
waveform: multipath shorter than the CP becomes a pure per-bin complex
gain, so the :class:`.sync.OfdmEqualizer` is *exact* (not approximate) and
frame alignment/CFO come for free from the CP's self-similarity — no
preamble needed.

Frames are one batched (i)FFT; the CP prepend/strip are
dense slices + concat on the last axis; CP sync is elementwise lag-N
correlation plus a cumsum moving window (no convs, no gathers, no host
scans).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32
from ..ops import modulation as _mod
from ..ops.fft import Scale, plan as fft_plan


@dataclass(frozen=True)
class OfdmConfig:
    """CP-OFDM parameters. ``active_bins`` (even, < fft_len) occupies the
    band center — FFT bins ``[0, a/2)`` and ``[N - a/2, N)`` — leaving
    guard bands at the Nyquist edges (None = all bins). ``cp_len`` must
    exceed the channel's delay spread for exact one-tap equalization."""

    fft_len: int = 256
    cp_len: int = 32
    active_bins: Optional[int] = None
    modulation: str = "qpsk"
    fft_backend: Optional[str] = None

    @property
    def symbol_len(self) -> int:
        return self.fft_len + self.cp_len

    def bins(self) -> int:
        return self.active_bins or self.fft_len


class OfdmModem:
    """CP-OFDM modulator/demodulator (one batched transform per direction).

    ``modulate(bits)``: ``nframes * bins * bits_per_symbol`` bits ->
    ``[nframes * (fft_len + cp_len)]`` time samples (Scale.SN both ways —
    unit average sample power for unit-power constellations).
    ``demodulate(x, h=None)``: aligned time samples -> bits, optionally
    dividing a per-bin channel estimate ``h`` out first (use
    :class:`.sync.OfdmEqualizer` with a pilot frame; exact for any channel
    shorter than the CP).
    """

    def __init__(self, config: OfdmConfig = OfdmConfig()):
        self.config = config
        name = config.modulation
        if name == "qpsk":
            self.modulation = _mod.qpsk()
        elif name == "bpsk":
            self.modulation = _mod.bpsk()
        elif name.startswith("qam") and name[3:].isdigit():
            self.modulation = _mod.qam(int(name[3:]))
        else:
            raise ValueError(f"unknown modulation {name!r}")
        a = config.bins()
        if a > config.fft_len or a % 2:
            raise ValueError("active_bins must be even and <= fft_len")
        self._plan = fft_plan(config.fft_len, config.fft_backend)

    def bits_per_frame(self) -> int:
        return self.config.bins() * self.modulation.bits_per_symbol

    # -- TX -----------------------------------------------------------------
    def frames_to_spectra(self, syms: jnp.ndarray) -> jnp.ndarray:
        """Map ``[..., nf, bins]`` symbols onto full ``[..., nf, N]`` frames
        (center band split across the DC edges, zeros in the guards)."""
        cfg = self.config
        a = cfg.bins()
        if a == cfg.fft_len:
            return syms
        half = a // 2
        batch = syms.shape[:-1]
        gap = jnp.zeros(batch + (cfg.fft_len - a,), dtype=cf32)
        return jnp.concatenate(
            [syms[..., :half], gap, syms[..., half:]], axis=-1
        )

    def modulate(self, bits) -> jnp.ndarray:
        cfg = self.config
        bpf = self.bits_per_frame()
        bits = jnp.asarray(bits)
        if bits.shape[-1] % bpf:
            raise ValueError(f"bit count must divide into frames of {bpf}")
        nf = bits.shape[-1] // bpf
        syms = self.modulation.modulate(bits).reshape(
            bits.shape[:-1] + (nf, cfg.bins())
        )
        spec = self.frames_to_spectra(syms)
        time = self._plan.bwd(spec, Scale.SN)  # [..., nf, N]
        cp = time[..., -cfg.cp_len:] if cfg.cp_len else time[..., :0]
        frames = jnp.concatenate([cp, time], axis=-1)
        return frames.reshape(bits.shape[:-1] + (nf * cfg.symbol_len,))

    # -- RX -----------------------------------------------------------------
    def spectra(self, x) -> jnp.ndarray:
        """Aligned time samples -> active-bin spectra ``[..., nf, bins]``."""
        cfg = self.config
        x = jnp.asarray(x, dtype=cf32)
        nf = x.shape[-1] // cfg.symbol_len
        fr = x[..., : nf * cfg.symbol_len].reshape(
            x.shape[:-1] + (nf, cfg.symbol_len)
        )[..., cfg.cp_len:]
        spec = self._plan.fwd(fr, Scale.SN)
        a = cfg.bins()
        if a == cfg.fft_len:
            return spec
        half = a // 2
        return jnp.concatenate(
            [spec[..., :half], spec[..., cfg.fft_len - (a - half):]], axis=-1
        )

    def demodulate(self, x, h=None) -> jnp.ndarray:
        spec = self.spectra(x)
        if h is not None:
            spec = spec / jnp.asarray(h, dtype=cf32)
        bits = self.modulation.demod(spec)
        return bits.reshape(bits.shape[:-2] + (-1,))


def cp_sync(x, config: OfdmConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blind frame timing + fractional CFO from the cyclic prefix
    (van de Beek): the CP repeats ``fft_len`` samples later, so

        c[n] = sum_{i<cp} x[n+i] * conj(x[n+i+N])

    peaks at every frame start; folding all frames' contributions onto one
    symbol period before the argmax averages the metric over the whole
    capture. Returns ``(offset, cfo)``: ``offset`` into the first full
    symbol, and the carrier offset in cycles/sample (unambiguous for
    ``|cfo| < 1/(2*fft_len)``), from the angle of the folded correlation
    at the peak. One cumsum + elementwise math — no scan, no conv.
    """
    cfg = config
    x = jnp.asarray(x, dtype=cf32)
    n = cfg.fft_len
    cp = cfg.cp_len
    sym = cfg.symbol_len
    p = x[..., :-n] * jnp.conj(x[..., n:])
    # moving sum over the cp window via cumsum difference
    c = jnp.cumsum(p, axis=-1)
    zero = jnp.zeros(c.shape[:-1] + (1,), dtype=c.dtype)
    c = jnp.concatenate([zero, c], axis=-1)
    w = c[..., cp:] - c[..., :-cp]  # w[m] = sum_{i<cp} p[m+i]
    nf = w.shape[-1] // sym
    folded = jnp.sum(
        w[..., : nf * sym].reshape(w.shape[:-1] + (nf, sym)), axis=-2
    )
    off = jnp.argmax(jnp.abs(folded), axis=-1)
    peak = jnp.take_along_axis(folded, off[..., None], axis=-1)[..., 0]
    cfo = -jnp.angle(peak) / (2.0 * np.pi * n)
    return off, cfo.astype(jnp.float32)


def sc_preamble(config: OfdmConfig, seed: int = 815) -> np.ndarray:
    """Schmidl-Cox preamble symbol (CP included): PN QPSK on the *even*
    active subcarriers only (amplitude √2 keeps unit average power), so
    the useful part consists of two identical ``fft_len/2`` halves —
    the self-similarity :func:`sc_sync` detects. Host-side numpy
    (complex constants embed at trace time).
    """
    cfg = config
    if cfg.fft_len % 2:
        raise ValueError("sc_preamble needs an even fft_len")
    rng = np.random.default_rng(seed)
    a = cfg.bins()
    half = a // 2
    # even-bin indices inside the active band (centered split, cf.
    # frames_to_spectra)
    bins = np.concatenate(
        [np.arange(0, half), np.arange(cfg.fft_len - (a - half), cfg.fft_len)]
    )
    even = bins[bins % 2 == 0]
    spec = np.zeros(cfg.fft_len, np.complex64)
    qpsk = (1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j)
    spec[even] = np.sqrt(2.0) * np.array(
        [qpsk[i] for i in rng.integers(0, 4, even.shape[0])], np.complex64
    ) / np.sqrt(2.0 * a / cfg.fft_len)
    time = np.fft.ifft(spec) * np.sqrt(cfg.fft_len)  # Scale.SN convention
    pre = np.concatenate([time[-cfg.cp_len:], time]) if cfg.cp_len else time
    return pre.astype(np.complex64)


def sc_sync(x, config: OfdmConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Schmidl-Cox timing + fractional CFO from a :func:`sc_preamble`.

    Timing metric ``M(d) = |P(d)|² / R(d)²`` with

        P(d) = Σ_{i<N/2} conj(x[d+i]) · x[d+i+N/2]
        R(d) = Σ_{i<N/2} |x[d+i+N/2]|²

    — both are length-``N/2`` moving windows realized as one cumsum
    difference each (no conv, no scan). The metric plateaus over the
    preamble CP; the returned ``offset`` is the start of the *useful*
    part, recovered as the plateau midpoint (first/last crossing of
    90% of the peak — two argmaxes) plus ``cp/2``. ``cfo`` (cycles per
    sample) comes from the angle of ``P`` mid-plateau; unambiguous for
    ``|cfo| < 1/fft_len`` — twice :func:`cp_sync`'s range, and unlike
    it Schmidl-Cox stays sharp through multipath and works per-burst
    (Schmidl & Cox, IEEE Trans. Comm. 45(12), 1997).
    """
    cfg = config
    x = jnp.asarray(x, dtype=cf32)
    n = cfg.fft_len
    h = n // 2

    def moving(v, w):
        c = jnp.cumsum(v, axis=-1)
        zero = jnp.zeros(c.shape[:-1] + (1,), dtype=c.dtype)
        c = jnp.concatenate([zero, c], axis=-1)
        return c[..., w:] - c[..., :-w]

    p = moving(jnp.conj(x[..., :-h]) * x[..., h:], h)  # P(d), d + N <= L
    r = moving(jnp.abs(x[..., h:]) ** 2, h)
    m = jnp.abs(p) ** 2 / jnp.maximum(r, 1e-12) ** 2
    peak = jnp.max(m, axis=-1, keepdims=True)
    above = m > 0.9 * peak
    first = jnp.argmax(above, axis=-1)
    last = above.shape[-1] - 1 - jnp.argmax(above[..., ::-1], axis=-1)
    mid = (first + last) // 2
    offset = mid + cfg.cp_len - cfg.cp_len // 2  # plateau mid -> useful start
    pmid = jnp.take_along_axis(p, mid[..., None], axis=-1)[..., 0]
    cfo = jnp.angle(pmid) / (np.pi * n)
    return offset, cfo.astype(jnp.float32)
