"""Resampling: linear interpolation upsampling and decimating downsampling.

Data-parallel re-design of reference ``src/sampling.rs``: both ops are pure
reshapes/broadcasts over the last axis, fully batched, fused by XLA.

Deliberate fix (SURVEY.md §2 quirk 1): the reference's ``interpolate``
computes the imaginary ramp from the **real** base value
(``im: x1.re + i*rate.1``, reference src/sampling.rs:19) — an obvious typo
its tests never catch because they only use signals with ``re == im``. We
interpolate the imaginary part from ``x1.im``; all reference test vectors
still match exactly.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32


@functools.lru_cache(maxsize=None)
def _interp_matrix(chunk: int, b1: int) -> np.ndarray:
    """[chunk+1, chunk*b1] linear-interp operator: output ``j = i*b1 + t``
    draws ``(1 - t/b1)`` from input ``i`` and ``t/b1`` from ``i+1``."""
    m = np.zeros((chunk + 1, chunk * b1), np.float32)
    for i in range(chunk):
        for t in range(b1):
            w = t / b1
            m[i, i * b1 + t] = 1.0 - w
            m[i + 1, i * b1 + t] = w
    return m


def _dense_interpolate(src: jnp.ndarray, n_between: int) -> jnp.ndarray:
    """Interpolation as a chunked dense **matmul**.

    The broadcasted form materializes a ``[..., n-1, n_between+1]`` tensor
    with a tiny minor axis. Instead: split the ``n-1`` intervals into chunks of
    ``c``, extend each chunk with its right-neighbor sample, and apply a
    precomputed ``[c+1, c*(n_between+1)]`` interpolation operator — all
    dense, ~``c`` MACs per output sample.
    """
    n = src.shape[-1]
    b1 = n_between + 1
    nseg = n - 1
    divisors = [c for c in range(1, min(nseg, 256) + 1) if nseg % c == 0]
    aligned = [c for c in divisors if c % 8 == 0]
    chunk = max(aligned) if aligned else max(divisors)
    if chunk < 8:
        return _broadcast_interpolate(src, n_between)
    g = nseg // chunk
    batch = src.shape[:-1]
    a = src[..., :-1].reshape(batch + (g, chunk))
    # right-neighbor sample of each chunk: the next chunk's first element,
    # then the final source sample (g values total — negligible traffic)
    nxt = jnp.concatenate([a[..., 1:, :1], src[..., None, -1:]], axis=-2)
    ext = jnp.concatenate([a, nxt], axis=-1)  # [..., g, chunk+1]
    m = jnp.asarray(_interp_matrix(chunk, b1))
    y = jnp.matmul(ext, m.astype(src.dtype)
                   if jnp.issubdtype(src.dtype, jnp.complexfloating) else m)
    flat = y.reshape(batch + (nseg * b1,))
    return jnp.concatenate([flat, src[..., -1:]], axis=-1)


def _broadcast_interpolate(src: jnp.ndarray, n_between: int) -> jnp.ndarray:
    x1 = src[..., :-1]  # [..., n-1]
    x2 = src[..., 1:]
    step = jnp.float32(1.0 / (n_between + 1))
    rate = (x2 - x1) * step
    i = jnp.arange(n_between + 1, dtype=jnp.float32)  # [n_between+1]
    seg = x1[..., :, None] + i * rate[..., :, None]  # [..., n-1, n_between+1]
    n = src.shape[-1]
    flat = seg.reshape(src.shape[:-1] + ((n - 1) * (n_between + 1),))
    return jnp.concatenate([flat, src[..., -1:]], axis=-1)


def interpolate(src, n_between: int, dense: bool = False) -> jnp.ndarray:
    """Linearly interpolate ``n_between`` samples between consecutive pairs.

    Output length is ``n + (n - 1) * n_between`` (verified by the reference's
    tests, src/sampling.rs:98): each of the ``n-1`` source intervals expands
    to ``n_between + 1`` points, plus the final source sample.

    Batched over leading axes. One broadcasted multiply-add by default;
    ``dense=True`` selects the chunked interpolation-operator matmul
    (:func:`_dense_interpolate`).
    """
    src = jnp.asarray(src, dtype=cf32)
    n = src.shape[-1]
    if n < 2:
        return src
    if dense:
        return _dense_interpolate(src, n_between)
    return _broadcast_interpolate(src, n_between)


@functools.lru_cache(maxsize=None)
def _decim_select_matrix(chunk_out: int, dec: int) -> np.ndarray:
    """[chunk_out*dec, chunk_out] one-hot selector: row ``dec*m`` -> col ``m``."""
    d = np.zeros((chunk_out * dec, chunk_out), np.float32)
    d[dec * np.arange(chunk_out), np.arange(chunk_out)] = 1.0
    return d


def _dense_decimate(src: jnp.ndarray, dec: int) -> jnp.ndarray:
    """Decimation as a chunked one-hot **matmul**.

    Avoids the strided slice (``x[..., ::dec]``) and the tiny
    ``[..., m, dec]`` minor axis. Instead: reshape to major-axis chunks
    ``[..., n/S, S]`` (``S = chunk_out * dec``, lane-aligned) and contract
    the chunk with a precomputed ``[S, chunk_out]`` one-hot selector —
    dense accesses only, ~``chunk_out`` MACs per input sample.
    """
    n = src.shape[-1]
    out_len = n // dec
    # chunk = largest divisor of out_len <= 512, preferring lane-aligned
    # multiples of 128; fall back to the strided slice if only tiny chunks
    # divide (rare ragged lengths — the flops would then exceed the win)
    divisors = [c for c in range(1, min(out_len, 512) + 1) if out_len % c == 0]
    aligned = [c for c in divisors if c % 128 == 0]
    chunk_out = max(aligned) if aligned else max(divisors)
    if chunk_out < 8:
        return src[..., ::dec]
    s = chunk_out * dec
    xv = src.reshape(src.shape[:-1] + (n // s, s))
    sel = jnp.asarray(_decim_select_matrix(chunk_out, dec))
    y = jnp.matmul(xv, sel.astype(src.dtype) if jnp.issubdtype(src.dtype, jnp.complexfloating) else sel)
    return y.reshape(src.shape[:-1] + (out_len,))


def downsample(src, out_len: int, dense: bool = False) -> jnp.ndarray:
    """Integer decimation: every ``(n / out_len)``-th sample starting at 0.

    No anti-alias filter, matching reference ``downsample``
    (src/sampling.rs:28-42); only even decimations are supported
    (``n % out_len == 0`` asserted like the reference).

    The plain strided slice by default; ``dense=True`` selects the chunked
    one-hot matmul (:func:`_dense_decimate`). Pipelines that decimate
    right after an FFT stage should prefer the
    fully fused :func:`..fft.fft_of_decimated`, which never materializes
    the full-rate signal at all.
    """
    src = jnp.asarray(src)
    n = src.shape[-1]
    out_len = int(out_len)
    if n % out_len != 0:
        raise ValueError(
            f"Only even decimations are supported ({n} % {out_len} != 0)"
        )
    dec = n // out_len
    if dec == 1:
        return src
    if dense:
        return _dense_decimate(src, dec)
    return src[..., ::dec]


def resample_fft(src, out_len: int, fft_backend=None) -> jnp.ndarray:
    """Bandlimited rational resampling in the frequency domain.

    Beyond the reference's linear-interp/decimate pair: exact for signals
    bandlimited below the smaller Nyquist, any rational ratio, and composed
    purely of FFTs + dense slicing (no strided gathers, no convs). Energy-preserving convention: output amplitude
    matches the input signal (``Scale`` handled internally).
    """
    from . import fft as _fft

    src = jnp.asarray(src, dtype=cf32)
    n = src.shape[-1]
    out_len = int(out_len)
    if out_len == n:
        return src
    spec = _fft.plan(n, fft_backend).fwd(src, _fft.Scale.NONE)
    batch = src.shape[:-1]
    if out_len > n:
        # upsample: zero-pad the spectrum middle; an even-length input's
        # Nyquist bin splits equally between +/- frequencies
        if n % 2 == 0:
            h = n // 2
            ny = 0.5 * spec[..., h : h + 1]
            parts = [
                spec[..., :h],
                ny,
                jnp.zeros(batch + (out_len - n - 1,), dtype=cf32),
                ny,
                spec[..., h + 1 :],
            ]
        else:
            h = (n + 1) // 2
            parts = [
                spec[..., :h],
                jnp.zeros(batch + (out_len - n,), dtype=cf32),
                spec[..., h:],
            ]
    else:
        # downsample: truncate the middle; an even output folds the two
        # edge bins into its Nyquist bin (scipy.signal.resample convention)
        if out_len % 2 == 0:
            h = out_len // 2
            ny = spec[..., h : h + 1] + spec[..., n - h : n - h + 1]
            parts = [spec[..., :h], ny, spec[..., n - h + 1 :]]
        else:
            h = (out_len + 1) // 2
            parts = [spec[..., :h], spec[..., n - (out_len - h) :]]
    out_spec = jnp.concatenate(parts, axis=-1)
    y = _fft.plan(out_len, fft_backend).bwd(out_spec, _fft.Scale.N)
    return y * (jnp.float32(out_len) / jnp.float32(n))


@functools.lru_cache(maxsize=None)
def _farrow_matrix(p: int, q: int) -> np.ndarray:
    """``[q+3, p]`` cubic-Lagrange resampling operator for one period.

    Output phase ``j`` of each period sits at input position
    ``t_j = j*q/p = n_j + mu_j``; column ``j`` holds the 4 Lagrange weights
    of ``x[n_j - 1 .. n_j + 2]`` at fraction ``mu_j`` (f64 design). A
    period consumes ``q`` inputs and produces ``p`` outputs; the operator
    contracts an input window of ``q + 3`` samples (1 left + 2 right
    neighbors)."""
    m = np.zeros((q + 3, p), np.float64)
    for j in range(p):
        t = j * q / p
        n = int(np.floor(t))
        mu = t - n
        # cubic Lagrange weights at points (-1, 0, 1, 2)
        w = np.array([
            -mu * (mu - 1) * (mu - 2) / 6.0,
            (mu + 1) * (mu - 1) * (mu - 2) / 2.0,
            -(mu + 1) * mu * (mu - 2) / 2.0,
            (mu + 1) * mu * (mu - 1) / 6.0,
        ])
        m[n : n + 4, j] = w  # rows are x[n-1 .. n+2] shifted by the +1 halo
    return m.astype(np.float32)


def resample_poly(src, p: int, q: int) -> jnp.ndarray:
    """Arbitrary rational resampling by ``p/q`` via cubic (Farrow-style)
    interpolation — the streaming/chunked complement of
    :func:`resample_fft` (which transforms the whole block and assumes a
    hard bandlimit).

    The fractional-position pattern repeats every ``p`` outputs / ``q``
    inputs, so the whole resampler is one precomputed ``[q+3, p]``
    operator (:func:`_farrow_matrix`) applied per input period: reshape
    into ``[n/q, q]`` periods, extend each with 1 left + 2 right neighbor
    samples (stride-1 slices — the overlap-save pattern), and batch-matmul
    — dense, no gathers. Output length is ``n * p / q`` (input
    length must divide by ``q``; pad to taste). Cubic interpolation is
    exact for polynomials up to degree 3 (tested) and ~-50 dB images for
    oversampled signals; pre-filter with :func:`~..fir.fir_filter_os` when
    downsampling aliasable content.
    """
    src = jnp.asarray(src, dtype=cf32)
    p = int(p)
    q = int(q)
    g = int(np.gcd(p, q))
    p //= g
    q //= g
    if p == q:
        return src
    n = src.shape[-1]
    if n % q:
        raise ValueError(f"input length {n} must be divisible by q = {q}")
    nper = n // q
    batch = src.shape[:-1]
    # windows: period k needs x[k*q - 1 .. k*q + q + 1] (q + 3 samples);
    # edge periods use zero padding (the causal/flush convention). Built
    # from whole q-sized slabs (dense concat of shifted slab views — the
    # same pattern as the channelizer's overlapped frames)
    xp = jnp.pad(src, [(0, 0)] * (src.ndim - 1) + [(1, 2)])
    nslabs = 1 + -(-3 // q)  # slabs covering q + 3 samples
    total = (nper + nslabs - 1) * q
    xp = jnp.pad(xp, [(0, 0)] * (src.ndim - 1) + [(0, total - xp.shape[-1])])
    slabs = xp.reshape(batch + (nper + nslabs - 1, q))
    parts = [slabs[..., i : i + nper, :] for i in range(nslabs)]
    win = jnp.concatenate(parts, axis=-1)[..., : q + 3]  # [..., nper, q+3]
    m = jnp.asarray(_farrow_matrix(p, q))
    y = jnp.matmul(win, m.astype(src.dtype) if jnp.issubdtype(
        src.dtype, jnp.complexfloating) else m)
    return y.reshape(batch + (nper * p,)).astype(cf32)


def fractional_delay(src, tau, fft_backend=None) -> jnp.ndarray:
    """Delay ``src`` by ``tau`` samples (any real value) via the spectral
    phase ramp: ``y = ifft( fft(x) * e^{-j 2 pi f tau} )`` with ``f`` the
    signed bin frequencies.

    Exact for bandlimited signals; the shift is **circular** (the last
    ``ceil(|tau|)`` samples wrap) — keep a margin or trim the edges for
    linear use. Integer ``tau`` reduces to an exact circular roll. Batched;
    composed of two batched FFTs + one elementwise multiply (the ramp is
    host-precomputed f64 when ``tau`` is a host value). The correction
    partner of
    :func:`~aether_primitives_tpu.models.sync.estimate_timing`:
    ``fractional_delay(x, -tau_hat)`` aligns symbol instants to the grid.
    """
    from . import fft as _fft

    src = jnp.asarray(src, dtype=cf32)
    n = src.shape[-1]
    freqs = np.fft.fftfreq(n)  # signed cycles/sample, f64
    if isinstance(tau, (int, float, np.floating, np.integer)):
        ramp = jnp.asarray(
            np.exp(-2j * np.pi * freqs * float(tau)).astype(np.complex64)
        )
    else:
        t = jnp.asarray(tau, jnp.float32)
        ang = -2.0 * np.float32(np.pi) * jnp.asarray(
            freqs.astype(np.float32)
        ) * t[..., None]
        ramp = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    plan = _fft.plan(n, fft_backend)
    spec = plan.fwd(src, _fft.Scale.NONE) * ramp
    return plan.bwd(spec, _fft.Scale.N).astype(cf32)


def downsample_by(src, factor: int, dense: bool = False) -> jnp.ndarray:
    """Decimate by an explicit integer factor (see :func:`downsample`)."""
    factor = int(factor)
    n = jnp.shape(src)[-1]
    if n % factor != 0:
        raise ValueError("Input length must be divisible by the decimation factor")
    return downsample(src, n // factor, dense=dense)


def decimate(
    src,
    factor: int,
    cutoff: float = 0.8,
    atten_db: float = 60.0,
    fft_backend=None,
) -> jnp.ndarray:
    """Anti-aliased decimation: Kaiser-designed lowpass at ``cutoff`` of
    the post-decimation Nyquist, applied through the fused decimating
    overlap-save FIR (:func:`~.fir.fir_filter_os_decimate`) — filter and
    rate change in ONE spectral-fold pass, never materializing the
    full-rate filtered signal.

    The raw :func:`downsample`/:func:`downsample_by` are the reference's
    filterless decimators (reference src/sampling.rs:28-42 — they alias by
    design); this is the one-call user API a deployed chain wants. Taps
    come from :func:`~.firdes.kaiser_lowpass` (host f64, design cached);
    group delay is NOT compensated (causal, like every FIR here).

    ``cutoff`` is the passband edge as a fraction of the POST-decimation
    Nyquist; the transition band runs from there to that Nyquist, so
    aliases land at least ``atten_db`` down.
    """
    factor = int(factor)
    if factor < 1:
        raise ValueError("factor must be >= 1")
    src = jnp.asarray(src, dtype=cf32)
    if factor == 1:
        return src
    if not (0.0 < cutoff < 1.0):
        raise ValueError("cutoff must be in (0, 1) of the output Nyquist")
    from . import fir as _fir

    taps = _decimate_taps(factor, float(cutoff), float(atten_db))
    return _fir.fir_filter_os_decimate(src, taps, factor, fft_backend=fft_backend)


@functools.lru_cache(maxsize=None)
def _decimate_taps(factor: int, cutoff: float, atten_db: float) -> np.ndarray:
    from .firdes import kaiser_lowpass

    out_nyq = 0.5 / factor  # in cycles/(input sample)
    edge = cutoff * out_nyq
    width = out_nyq - edge
    # cutoff at the middle of the transition band (kaiser_lowpass centers it)
    return kaiser_lowpass(edge + width / 2.0, width, atten_db).astype(np.float32)
