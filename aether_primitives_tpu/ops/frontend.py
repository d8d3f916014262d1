"""Receiver front-end conditioning: NCO mixing, DC offset removal,
IQ-imbalance estimation/correction, and block AGC.

Completes the analog-front-end story around the reference's modem chain
(the reference assumes a perfect front end — its loopback feeds the
modulator's output straight to the demodulator, reference
examples/modem.rs:23-31; a real receiver first has to center, balance, and
level the capture). Every op here is feedforward and batched — elementwise
math plus reductions, fully fused by XLA; the one sequential element
(AGC gain smoothing across blocks) is a ``lax.scan`` carrying a single
scalar, the compiler-friendly form of the classic feedback loop.

Conventions: frequencies are in **cycles/sample** (normalized to the sample
rate), phases in radians. The IQ-imbalance model is the standard
direct-conversion receiver model — the I arm is the reference, the Q arm
carries a gain error ``g`` and a phase error ``phi``::

    I' = I
    Q' = g * (Q * cos(phi) + I * sin(phi))

equivalently ``y = K1*x + K2*conj(x)`` with ``K1 = (1 + g e^{j phi})/2``,
``K2 = (1 - g e^{-j phi})/2`` — the image-leakage form (image rejection
ratio ``IRR = |K1|^2 / |K2|^2``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32


_NCO_BLOCK = 1024  # index-split size for the exact-mod phase tables


def _is_concrete(v) -> bool:
    """True when ``v`` is host data (python/numpy scalars or arrays) —
    i.e. its f64 phase tables can be computed exactly at trace time."""
    return isinstance(v, (int, float, np.floating, np.integer, np.ndarray, list, tuple))


def nco_mix(x, freq, phase0=0.0) -> jnp.ndarray:
    """Mix ``x`` with a numerically controlled oscillator:
    ``y[n] = x[n] * e^{j*(2*pi*freq*n + phase0)}``.

    ``freq`` is in cycles/sample (positive shifts the spectrum up). Batched
    over leading axes; per-row ``freq`` broadcasts against the sample index.

    Precision: a naive f32 ramp ``f*n`` loses ~``log2(n)`` bits before the
    mod — at 4M samples the phase error reaches whole cycles. When ``freq``
    (and ``phase0``) are host values — the usual case; they are exact at
    trace time — the cycle ramp is built from two small f64-exact mod-1
    tables over the index split ``n = q*B + r``::

        cycles[n] = hi[q] + lo[r],   hi[q] = (f*B*q + p0) mod 1,
                                     lo[r] = (f*r) mod 1

    which broadcast as an outer sum (no gathers) and keep the phase error
    at f32 rounding (~-120 dB EVM) for any block length. Traced ``freq``
    falls back to the direct f32 ramp (fine for short blocks; document
    your lengths or pass host frequencies).

    For streaming continuity across blocks, carry
    ``phase0' = next_phase(n, freq, phase0)`` into the next call.

    >>> import numpy as np
    >>> y = np.asarray(nco_mix(np.ones(4, np.complex64), 0.25))
    >>> bool(np.allclose(y, [1, 1j, -1, -1j], atol=1e-6))
    True
    >>> float(next_phase(4, 0.25))  # a whole number of cycles -> phase 0
    0.0
    """
    x = jnp.asarray(x, dtype=cf32)
    n = x.shape[-1]
    two_pi = 2.0 * np.float32(np.pi)
    if _is_concrete(freq) and _is_concrete(phase0):
        f = np.asarray(freq, np.float64)
        p0 = np.asarray(phase0, np.float64) / (2.0 * np.pi)
        b = _NCO_BLOCK
        nq = -(-n // b)
        q = np.arange(nq, dtype=np.float64)
        r = np.arange(b, dtype=np.float64)
        hi = np.mod(f[..., None] * (b * q) + p0[..., None], 1.0)  # [..., nq]
        lo = np.mod(f[..., None] * r, 1.0)  # [..., b]
        # embed the two SMALL rotator tables (exp is exact-to-f32 on the
        # f64-reduced cycles) and form the full rotator as their outer
        # product on device: e^{2pi i(hi+lo)} = e^{2pi i hi} * e^{2pi i lo}
        rot_hi = jnp.asarray(np.exp(2j * np.pi * hi).astype(np.complex64))
        rot_lo = jnp.asarray(np.exp(2j * np.pi * lo).astype(np.complex64))
        rot = (rot_hi[..., :, None] * rot_lo[..., None, :]).reshape(
            hi.shape[:-1] + (nq * b,)
        )[..., :n]
        return (x * rot).astype(cf32)
    nn = jnp.arange(n, dtype=jnp.float32)
    f = jnp.asarray(freq, dtype=jnp.float32)
    if f.ndim:
        f = f[..., None]
    cycles = f * nn + jnp.asarray(phase0, jnp.float32) / two_pi
    ang = two_pi * jnp.mod(cycles, 1.0)
    rot = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    return (x * rot).astype(cf32)


def next_phase(n_samples: int, freq, phase0=0.0):
    """Oscillator phase (radians, reduced to [0, 2*pi)) after ``n_samples``
    — feed as ``phase0`` of the next :func:`nco_mix` block. Host f64 when
    the inputs are host values (exact continuity), f32 jnp otherwise."""
    if _is_concrete(freq) and _is_concrete(phase0):
        f = np.asarray(freq, np.float64)
        cycles = f * n_samples + np.asarray(phase0, np.float64) / (2.0 * np.pi)
        return 2.0 * np.pi * np.mod(cycles, 1.0)
    f = jnp.asarray(freq, dtype=jnp.float32)
    cycles = f * n_samples + jnp.asarray(phase0, jnp.float32) / (2.0 * np.float32(np.pi))
    return (2.0 * np.float32(np.pi)) * jnp.mod(cycles, 1.0)


def dc_offset(x) -> jnp.ndarray:
    """Mean of the block — the DC estimate (complex scalar per batch row)."""
    return jnp.mean(jnp.asarray(x, dtype=cf32), axis=-1)


def remove_dc(x) -> jnp.ndarray:
    """Subtract the per-row block mean (one-shot DC block removal)."""
    x = jnp.asarray(x, dtype=cf32)
    return (x - jnp.mean(x, axis=-1, keepdims=True)).astype(cf32)


def apply_iq_imbalance(x, gain: float, phase: float) -> jnp.ndarray:
    """Simulate a direct-conversion front end with Q-arm gain error
    ``gain`` (linear, 1.0 = balanced) and phase error ``phase`` (radians):
    ``I' = I``, ``Q' = gain * (Q cos(phase) + I sin(phase))``."""
    x = jnp.asarray(x, dtype=cf32)
    i = jnp.real(x)
    q = jnp.imag(x)
    g = jnp.float32(gain)
    qp = g * (q * np.float32(np.cos(phase)) + i * np.float32(np.sin(phase)))
    return jax.lax.complex(i, qp).astype(cf32)


def estimate_iq_imbalance(x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blind (data-aided-free) imbalance estimate from second-order
    statistics, valid for any proper (circularly symmetric) signal —
    noise, PSK/QAM, OFDM all qualify::

        gain  = sqrt(E[Q^2] / E[I^2])
        phase = asin( E[I*Q] / sqrt(E[I^2] * E[Q^2]) )

    Exact (in expectation) under the model in the module docstring, since
    a proper ``x`` has ``E[I^2] = E[Q^2]`` and ``E[I*Q] = 0``. Estimate
    over the trailing axis; remove DC first for captures with offset.
    Returns ``(gain, phase)`` f32 scalars (or per-row for batched input).
    """
    x = jnp.asarray(x, dtype=cf32)
    i = jnp.real(x)
    q = jnp.imag(x)
    pii = jnp.mean(i * i, axis=-1)
    pqq = jnp.mean(q * q, axis=-1)
    piq = jnp.mean(i * q, axis=-1)
    gain = jnp.sqrt(pqq / pii)
    phase = jnp.arcsin(jnp.clip(piq / jnp.sqrt(pii * pqq), -1.0, 1.0))
    return gain.astype(jnp.float32), phase.astype(jnp.float32)


def correct_iq_imbalance(x, gain, phase) -> jnp.ndarray:
    """Invert :func:`apply_iq_imbalance` exactly:
    ``Q = (Q'/gain - I' sin(phase)) / cos(phase)``, ``I = I'``.

    Compose with :func:`estimate_iq_imbalance` for the blind pipeline::

        y = correct_iq_imbalance(x, *estimate_iq_imbalance(remove_dc(x)))
    """
    x = jnp.asarray(x, dtype=cf32)
    i = jnp.real(x)
    q = jnp.imag(x)
    g = jnp.asarray(gain, jnp.float32)
    ph = jnp.asarray(phase, jnp.float32)
    if g.ndim:
        g = g[..., None]
    if ph.ndim:
        ph = ph[..., None]
    qc = (q / g - i * jnp.sin(ph)) / jnp.cos(ph)
    return jax.lax.complex(i, qc).astype(cf32)


def image_rejection_db(x, tone_bin: int) -> jnp.ndarray:
    """Image-rejection ratio of a single-tone capture: power at ``tone_bin``
    over power at its image bin ``-tone_bin`` (dB). The standard front-end
    figure of merit for validating :func:`correct_iq_imbalance`."""
    x = jnp.asarray(x, dtype=cf32)
    spec = jnp.fft.fft(x, axis=-1)
    n = x.shape[-1]
    p_sig = jnp.abs(spec[..., tone_bin % n]) ** 2
    p_img = jnp.abs(spec[..., (-tone_bin) % n]) ** 2
    return (10.0 * jnp.log10(p_sig / (p_img + 1e-30))).astype(jnp.float32)


def estimate_snr_m2m4(y) -> jnp.ndarray:
    """Blind SNR estimate from second/fourth moments (M2M4, the classic
    NDA in-service estimator): for a constant-modulus signal ``s``
    (``|s|^2 = S``) in circular complex AWGN of power ``N``::

        m2 = E[|y|^2] = S + N
        m4 = E[|y|^4] = S^2 + 4 S N + 2 N^2
        =>  S = sqrt(2 m2^2 - m4),  N = m2 - S

    Returns the linear SNR ``S / N`` (f32; per-row for batched input;
    ``inf`` when the noise estimate underflows to <= 0 on clean signals).
    Exact in expectation for PSK; for QAM the constant-modulus assumption
    biases the estimate (the standard M2M4 caveat) — calibrate or use a
    pilot-aided estimate when the constellation has amplitude rings.
    """
    y = jnp.asarray(y, dtype=cf32)
    p = jnp.real(y) ** 2 + jnp.imag(y) ** 2
    m2 = jnp.mean(p, axis=-1)
    m4 = jnp.mean(p * p, axis=-1)
    s = jnp.sqrt(jnp.maximum(2.0 * m2 * m2 - m4, 0.0))
    n = m2 - s
    return jnp.where(n > 0, s / jnp.where(n > 0, n, 1.0), jnp.inf).astype(
        jnp.float32
    )


def agc(
    x,
    target_rms: float = 1.0,
    block: int = 1024,
    alpha: float = 0.5,
    gain0: Optional[float] = None,
    eps: float = 1e-12,
):
    """Block automatic gain control: per-block measured gain, first-order
    smoothed across blocks, applied per block.

    The classic feedback AGC loop re-cast compiler-friendly: the signal is
    reshaped into ``[nblocks, block]`` (the trailing ragged tail is
    processed at the running gain) and a ``lax.scan`` carries one scalar
    gain ``g`` — per block ``g <- (1-alpha)*g + alpha * target/rms`` is
    applied *before* the update (the loop acts on the measurement of the
    previous block, like a hardware AGC). ``alpha=1`` is instantaneous
    per-block normalization; small ``alpha`` tracks slow fading.

    Returns ``(y, final_gain)`` — feed ``final_gain`` as ``gain0`` of the
    next capture block for streaming continuity. 1-D input only (the gain
    state is a stream property; vmap for independent channels).
    """
    x = jnp.asarray(x, dtype=cf32)
    if x.ndim != 1:
        raise ValueError("agc is a stream op: 1-D input (vmap for channels)")
    n = x.shape[-1]
    block = int(block)
    nb = n // block
    a = jnp.float32(alpha)
    t = jnp.float32(target_rms)
    g_init = jnp.float32(1.0 if gain0 is None else gain0)

    def step(g, xb):
        y = xb * g
        rms = jnp.sqrt(jnp.mean(jnp.real(xb) ** 2 + jnp.imag(xb) ** 2) + eps)
        g_new = (1.0 - a) * g + a * (t / rms)
        return g_new, y

    if nb:
        head = x[: nb * block].reshape(nb, block)
        g_final, yb = jax.lax.scan(step, g_init, head)
        y = yb.reshape(nb * block)
    else:
        g_final, y = g_init, x[:0]
    tail = x[nb * block :]
    if tail.shape[-1]:
        y = jnp.concatenate([y, tail * g_final])
    return y.astype(cf32), g_final


def normalize_rms(x, target_rms: float = 1.0, eps: float = 1e-12) -> jnp.ndarray:
    """One-shot per-row RMS normalization (the ``alpha=1`` whole-block AGC)."""
    x = jnp.asarray(x, dtype=cf32)
    rms = jnp.sqrt(
        jnp.mean(jnp.real(x) ** 2 + jnp.imag(x) ** 2, axis=-1, keepdims=True) + eps
    )
    return (x * (jnp.float32(target_rms) / rms)).astype(cf32)


def impulse_blank(x, threshold_sigma: float = 5.0, mode: str = "zero") -> jnp.ndarray:
    """Impulse-noise blanker: samples whose envelope exceeds
    ``threshold_sigma`` x the block's ROBUST scale (median absolute
    envelope / sqrt(ln 4), the Rayleigh-consistent estimator — a mean
    would be dragged by the very impulses being removed) are zeroed
    (``mode="zero"``) or clipped to the threshold magnitude with phase
    kept (``mode="clip"``). The classic HF/power-line-noise front-end
    stage; one fused elementwise pass, batched over leading axes."""
    x = jnp.asarray(x, dtype=cf32)
    env = jnp.sqrt(jnp.real(x) ** 2 + jnp.imag(x) ** 2)
    # Rayleigh: median = sigma * sqrt(ln 4); scale = sigma of the quadrature
    med = jnp.median(env, axis=-1, keepdims=True)
    scale = med / np.sqrt(np.log(4.0))
    thresh = jnp.float32(threshold_sigma) * scale
    if mode == "zero":
        keep = env <= thresh
        return jnp.where(keep, x, jnp.complex64(0.0)).astype(cf32)
    if mode == "clip":
        g = jnp.where(env > thresh, thresh / jnp.maximum(env, 1e-30), 1.0)
        return (x * g).astype(cf32)
    raise ValueError(f"mode must be 'zero' or 'clip', got {mode!r}")


def squelch(x, threshold_db: float, ref_power: float = 1.0) -> jnp.ndarray:
    """Power squelch: rows (bursts) whose mean power falls below
    ``threshold_db`` relative to ``ref_power`` are zeroed — the
    open/closed gate of a scanning receiver. Returns ``(gated, open)``
    where ``open`` is the per-row bool gate state."""
    x = jnp.asarray(x, dtype=cf32)
    p = jnp.mean(jnp.real(x) ** 2 + jnp.imag(x) ** 2, axis=-1, keepdims=True)
    open_ = p > jnp.float32(ref_power * 10.0 ** (threshold_db / 10.0))
    return (
        jnp.where(open_, x, jnp.complex64(0.0)).astype(cf32),
        open_[..., 0],
    )
