"""Frequency-hopping spread spectrum (FHSS).

The hop/dehop pair for a synchronized slow-FHSS link: the baseband
signal is carved into hop dwells and each dwell mixed to its channel by
a per-dwell complex rotator — one batched elementwise pass (the dwell
axis is the batch axis; per-dwell oscillators come from one host
table, no sequential NCO state). The hop pattern derives from the
framework's PN machinery (:func:`~..ops.sequence.lte_gold`), so TX and
RX regenerate it from a shared seed.

The classic payoff — a partial-band jammer only hits the dwells parked
on its channels, and FEC + interleaving ride through — is exactly the
composition the tests build (QPSK + conv/Viterbi through a jammed band).
Phase continuity across dwells is NOT maintained (real synthesizers
don't either); run a per-dwell phase estimator or differential coding
downstream, or keep dwells within the carrier-tracking loop bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import sequence as _seq
from ..types import cf32

__all__ = ["FhssConfig", "hop_sequence", "hop_spread", "hop_despread"]


@dataclass(frozen=True)
class FhssConfig:
    n_channels: int = 16
    dwell: int = 256  # samples per hop
    cinit: int = 0x7E57  # PN seed shared by TX and RX
    spacing: float = 0.0  # channel spacing in cycles/sample; 0 = 1/n_channels

    @property
    def channel_spacing(self) -> float:
        return self.spacing if self.spacing > 0 else 1.0 / self.n_channels


def hop_sequence(cfg: FhssConfig, n_hops: int) -> np.ndarray:
    """Channel index per dwell from the shared Gold-sequence PN: ``ceil
    log2(n_channels)`` bits per hop, rejected-and-wrapped into range (host
    numpy — the pattern is a design-time constant for a given seed)."""
    bits_per = max(1, int(np.ceil(np.log2(cfg.n_channels))))
    bits = np.asarray(_seq.lte_gold(cfg.cinit, n_hops * bits_per)).astype(np.int64)
    weights = 2 ** np.arange(bits_per)
    idx = bits.reshape(n_hops, bits_per) @ weights
    return (idx % cfg.n_channels).astype(np.int64)


def _dwell_rotators(cfg: FhssConfig, n_hops: int, conj: bool) -> np.ndarray:
    """[n_hops, dwell] complex rotators e^{+-2 pi i f_h n} (host f64:
    exact per-dwell phase; dwell-start phase resets each hop)."""
    seq = hop_sequence(cfg, n_hops)
    # channels centered around 0: index c -> (c - (N-1)/2) * spacing
    f = (seq - (cfg.n_channels - 1) / 2.0) * cfg.channel_spacing
    n = np.arange(cfg.dwell, dtype=np.float64)
    ang = 2.0 * np.pi * f[:, None] * n[None, :]
    if conj:
        ang = -ang
    return np.exp(1j * ang).astype(np.complex64)


def hop_spread(x, cfg: FhssConfig) -> jnp.ndarray:
    """TX hop: ``[..., n]`` baseband (``n % dwell == 0``) -> hopped
    passband-composite at the same rate."""
    x = jnp.asarray(x, dtype=cf32)
    n = int(x.shape[-1])
    if n % cfg.dwell:
        raise ValueError(f"length {n} must be a multiple of the dwell {cfg.dwell}")
    n_hops = n // cfg.dwell
    rot = jnp.asarray(_dwell_rotators(cfg, n_hops, conj=False))
    xb = x.reshape(x.shape[:-1] + (n_hops, cfg.dwell))
    return (xb * rot).reshape(x.shape).astype(cf32)


def hop_despread(y, cfg: FhssConfig) -> jnp.ndarray:
    """RX dehop (synchronized): conjugate per-dwell rotators."""
    y = jnp.asarray(y, dtype=cf32)
    n = int(y.shape[-1])
    if n % cfg.dwell:
        raise ValueError(f"length {n} must be a multiple of the dwell {cfg.dwell}")
    n_hops = n // cfg.dwell
    rot = jnp.asarray(_dwell_rotators(cfg, n_hops, conj=True))
    yb = y.reshape(y.shape[:-1] + (n_hops, cfg.dwell))
    return (yb * rot).reshape(y.shape).astype(cf32)
