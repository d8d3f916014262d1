"""Antenna diversity: receive combining (MRC/EGC/selection) and the
Alamouti 2x1 space-time block code.

Multi-antenna capture is the natural batch axis — a diversity
receiver is ONE fused elementwise pass over ``[..., n_rx, n]`` blocks
(no per-antenna loops), and the Alamouti decoder is two conjugate
multiplies and an add. Everything here is flat-fading per-branch
(equalize or channelize first for frequency selectivity; per-subcarrier
use is just a broadcast of ``h`` over the symbol axis).

Conventions: channels ``h`` are complex gains per branch (``[..., n_rx]``
or broadcastable to the sample axis); combiners return unit-reference
symbol estimates (the constellation scale, not the raw channel scale),
so hard/soft demods apply directly.

- :func:`mrc_combine` — maximal-ratio: ``sum_i conj(h_i) y_i / sum_i
  |h_i|^2``; optimal (matched filter in space), array gain = sum of
  branch SNRs.
- :func:`egc_combine` — equal-gain: co-phase only (``e^{-j arg h_i}``),
  for when branch amplitudes are unreliable.
- :func:`selection_combine` — pick the strongest branch per block.
- :func:`alamouti_encode` / :func:`alamouti_decode` — the rate-1 2-TX
  orthogonal STBC (Alamouti 1998): TX antennas send ``(s0, s1)`` then
  ``(-conj(s1), conj(s0))``; with per-burst-static channels ``(h0, h1)``
  the decoder's conjugate combining yields ``(|h0|^2 + |h1|^2) s_i`` +
  noise — full 2-branch diversity from ONE receive antenna, no channel
  knowledge at the TX. Decoder extends to MRC over multiple RX antennas.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..types import cf32


def _norm2(h):
    return jnp.real(h) ** 2 + jnp.imag(h) ** 2


def mrc_combine(y, h, axis: int = -2) -> jnp.ndarray:
    """Maximal-ratio combining of branches along ``axis`` of ``y`` with
    channel gains ``h`` (broadcastable to ``y``): the SNR-optimal
    ``sum conj(h) y / sum |h|^2`` (unit-reference output)."""
    y = jnp.asarray(y, dtype=cf32)
    h = jnp.asarray(h, dtype=cf32)
    num = jnp.sum(jnp.conj(h) * y, axis=axis)
    den = jnp.sum(_norm2(h), axis=axis)
    return (num / jnp.maximum(den, 1e-30)).astype(cf32)


def egc_combine(y, h, axis: int = -2) -> jnp.ndarray:
    """Equal-gain combining: co-phase each branch (``e^{-j arg h}``) and
    average — amplitude-blind, ~0.5-1 dB under MRC on Rayleigh branches."""
    y = jnp.asarray(y, dtype=cf32)
    h = jnp.asarray(h, dtype=cf32)
    mag = jnp.sqrt(jnp.maximum(_norm2(h), 1e-30))
    phased = y * jnp.conj(h) / mag
    n_rx = y.shape[axis]
    return (jnp.sum(phased, axis=axis) / n_rx).astype(cf32)


def selection_combine(y, h, axis: int = -2) -> jnp.ndarray:
    """Selection diversity: take the branch with the largest ``|h|``
    (per leading-batch element), channel-corrected."""
    y = jnp.asarray(y, dtype=cf32)
    h = jnp.asarray(h, dtype=cf32)
    hb = jnp.broadcast_to(h, y.shape)
    axis = axis % y.ndim
    # branch power: reduce every axis after `axis` (the sample axes)
    red = tuple(range(axis + 1, y.ndim))
    power = jnp.sum(_norm2(hb), axis=red) if red else _norm2(hb)
    best = jnp.argmax(power, axis=-1)
    yb = jnp.take_along_axis(
        y, best[(...,) + (None,) * (y.ndim - axis)].astype(jnp.int32), axis=axis
    )
    hbb = jnp.take_along_axis(
        hb, best[(...,) + (None,) * (y.ndim - axis)].astype(jnp.int32), axis=axis
    )
    out = jnp.squeeze(yb, axis=axis)
    hsel = jnp.squeeze(hbb, axis=axis)
    return (out * jnp.conj(hsel) / jnp.maximum(_norm2(hsel), 1e-30)).astype(cf32)


def alamouti_encode(symbols) -> jnp.ndarray:
    """Alamouti 2x1 STBC: ``[..., n]`` symbols (n even) ->
    ``[..., 2, n]`` per-TX-antenna streams. Antenna 0 sends
    ``s0, -conj(s1), s2, -conj(s3), ...``; antenna 1 sends
    ``s1, conj(s0), s3, conj(s2), ...`` (one symbol pair per 2 uses,
    rate 1)."""
    s = jnp.asarray(symbols, dtype=cf32)
    if s.shape[-1] % 2:
        raise ValueError("Alamouti encodes symbol PAIRS: length must be even")
    pairs = s.reshape(s.shape[:-1] + (-1, 2))
    s0, s1 = pairs[..., 0], pairs[..., 1]
    tx0 = jnp.stack([s0, -jnp.conj(s1)], axis=-1).reshape(s.shape)
    tx1 = jnp.stack([s1, jnp.conj(s0)], axis=-1).reshape(s.shape)
    return jnp.stack([tx0, tx1], axis=-2)


def alamouti_decode(y, h0, h1) -> jnp.ndarray:
    """Alamouti combining at one RX antenna: ``[..., n]`` received
    (n even), per-burst channels ``h0``/``h1`` (scalars or ``[...]``
    broadcastable) -> ``[..., n]`` symbol estimates with full 2-branch
    diversity::

        s0_hat = (conj(h0) r0 + h1 conj(r1)) / (|h0|^2 + |h1|^2)
        s1_hat = (conj(h1) r0 - h0 conj(r1)) / (|h0|^2 + |h1|^2)

    For multiple RX antennas, decode each and MRC by summing the
    UNNORMALIZED numerators (or just average the unit-reference outputs
    weighted by each antenna's ``|h0|^2 + |h1|^2``).
    """
    y = jnp.asarray(y, dtype=cf32)
    if y.shape[-1] % 2:
        raise ValueError("Alamouti decodes symbol PAIRS: length must be even")
    h0 = jnp.asarray(h0, dtype=cf32)[..., None]
    h1 = jnp.asarray(h1, dtype=cf32)[..., None]
    pairs = y.reshape(y.shape[:-1] + (-1, 2))
    r0, r1 = pairs[..., 0], pairs[..., 1]
    den = _norm2(h0) + _norm2(h1)
    s0 = (jnp.conj(h0) * r0 + h1 * jnp.conj(r1)) / jnp.maximum(den, 1e-30)
    s1 = (jnp.conj(h1) * r0 - h0 * jnp.conj(r1)) / jnp.maximum(den, 1e-30)
    out = jnp.stack([s0, s1], axis=-1)
    return out.reshape(y.shape).astype(cf32)


# ------------------------------------------------------- spatial multiplexing


def mimo_detect_zf(y, h):
    """Zero-forcing detection for spatial multiplexing: per symbol time,
    ``y = H s + n`` with ``y [..., n_rx]``, ``h [..., n_rx, n_tx]``
    (broadcastable — pass one matrix per burst or per symbol). Returns
    ``s_hat = pinv(H) y`` computed via the normal equations
    (``(H^H H)^{-1} H^H y`` — batched tiny solves).
    Requires ``n_rx >= n_tx``."""
    y = jnp.asarray(y, dtype=cf32)
    h = jnp.asarray(h, dtype=cf32)
    hh = jnp.conj(jnp.swapaxes(h, -1, -2))
    a = hh @ h  # [..., n_tx, n_tx]
    b = (hh @ y[..., None])[..., 0]
    return jnp.linalg.solve(a, b[..., None])[..., 0].astype(cf32)


def mimo_detect_mmse(y, h, noise_var):
    """Linear MMSE detection: ``(H^H H + sigma^2 I)^{-1} H^H y`` —
    trades residual interference against noise enhancement (the standard
    improvement over ZF at low SNR; per-stream BER gain tested).
    ``noise_var``: scalar or broadcastable noise power per RX antenna
    (unit-energy symbols assumed; scale accordingly)."""
    y = jnp.asarray(y, dtype=cf32)
    h = jnp.asarray(h, dtype=cf32)
    hh = jnp.conj(jnp.swapaxes(h, -1, -2))
    n_tx = h.shape[-1]
    a = hh @ h + jnp.asarray(noise_var, jnp.float32) * jnp.eye(n_tx, dtype=cf32)
    b = (hh @ y[..., None])[..., 0]
    return jnp.linalg.solve(a, b[..., None])[..., 0].astype(cf32)


def mimo_stream_snr(h, noise_var):
    """Post-detection SNR per spatial stream for the ZF detector:
    ``1 / (noise_var * [(H^H H)^{-1}]_kk)`` — the link-adaptation metric
    (which streams can carry which constellation)."""
    h = jnp.asarray(h, dtype=cf32)
    hh = jnp.conj(jnp.swapaxes(h, -1, -2))
    a = hh @ h
    inv = jnp.linalg.inv(a)
    diag = jnp.real(jnp.diagonal(inv, axis1=-2, axis2=-1))
    return (1.0 / (jnp.asarray(noise_var, jnp.float32) * diag)).astype(jnp.float32)
