"""Adaptive channel equalization: trained/decision-directed LMS and blind
CMA, as ``lax.scan`` kernels.

Completes the receiver alongside :class:`.sync.OfdmEqualizer` (which is
one-tap-per-subcarrier and needs a pilot *frame*): these are the
single-carrier, time-domain equalizers that track an unknown FIR channel
from a training sequence (LMS), from its own decisions (decision-directed),
or fully blind from the constant-modulus property (CMA).

Adaptation is inherently sequential — each symbol's weight update feeds the
next — so the realization is a ``lax.scan`` carrying the ``[ntaps]``
weight vector: one compiled loop, no Python iteration, batched inner dots.
The sliding input windows are built once from ``ntaps`` stride-1 slices
(the shift-and-add layout; no gathers). For block-rate adaptation of very
long streams prefer a frame equalizer (:class:`.sync.OfdmEqualizer` /
:func:`~aether_primitives_tpu.ops.fir.fir_filter_os` with re-estimated
taps); these scan kernels are for burst acquisition at symbol rate.

Convention: equalizer output ``y[i] = sum_t w[t] * x[i - t]`` (causal
window), decisions/training aligned so ``y[i]`` estimates ``d[i]``; pick a
``delay`` roughly ``ntaps // 2`` samples into the training sequence for a
centered channel inverse.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32


def _sliding(x: jnp.ndarray, ntaps: int) -> jnp.ndarray:
    """``[n, ntaps]`` causal windows ``rows[i, t] = x[i - t]`` (zeros before
    the start) from ``ntaps`` stride-1 slices — no gather, no small-stride
    access."""
    n = x.shape[-1]
    xp = jnp.pad(x, (ntaps - 1, 0))
    cols = [
        jax.lax.slice_in_dim(xp, ntaps - 1 - t, ntaps - 1 - t + n, axis=-1)
        for t in range(ntaps)
    ]
    return jnp.stack(cols, axis=-1)


def lms_equalize(
    x,
    training,
    ntaps: int = 11,
    mu: float = 0.01,
    delay: int = 0,
    w0=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Trained LMS: adapt ``w`` over the training span, then run the frozen
    (final) weights over the whole input.

    ``x``: received symbols (1-D). ``training``: known transmitted symbols;
    the equalizer is trained so ``y[i]`` estimates ``training[i - delay]``
    (choose ``delay`` ≈ channel main-tap lag + a few, so the causal window
    sees the whole pulse). Returns ``(y, w, err)`` — the equalized stream
    (full length, filtered with the final weights; ``y[i]`` estimates the
    symbol ``i - delay``), the final ``[ntaps]`` weights, and the per-step
    training error magnitudes (convergence monitor). Normalized-LMS step:
    the update divides by the window energy, making ``mu`` scale-free
    (stable for ``0 < mu < 2``).
    """
    x = jnp.asarray(x, dtype=cf32)
    d = jnp.asarray(training, dtype=cf32)
    rows = _sliding(x, ntaps)  # [n, ntaps]
    m = min(int(d.shape[-1]), rows.shape[0] - int(delay))
    d = d[:m]
    train_rows = rows[delay : delay + m]
    if w0 is None:
        w_init = jnp.zeros((ntaps,), cf32).at[0].set(1.0 + 0.0j)
    else:
        w_init = jnp.asarray(w0, dtype=cf32)
    mu = jnp.float32(mu)

    def step(w, inp):
        row, dd = inp
        y = jnp.sum(w * row)
        e = dd - y
        en = jnp.sum(jnp.real(row) ** 2 + jnp.imag(row) ** 2) + 1e-12
        w = w + (mu / en) * e * jnp.conj(row)
        return w, jnp.abs(e)

    w, err = jax.lax.scan(step, w_init, (train_rows, d))
    y = jnp.matmul(rows, w)
    return y.astype(cf32), w, err


def dd_equalize(
    x,
    table,
    ntaps: int = 11,
    mu: float = 0.01,
    w0=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Decision-directed LMS: the training signal is the nearest
    constellation point of the equalizer's own output — run it after
    :func:`lms_equalize` has opened the eye (pass its ``w`` as ``w0``).

    ``table``: constellation points (e.g. ``modulation.qpsk().table``).
    Returns ``(y, w)`` where ``y`` is the *adapting* output (each sample
    produced by the weights as of that step — the true tracking behavior).
    """
    x = jnp.asarray(x, dtype=cf32)
    pts = jnp.asarray(np.asarray(table, np.complex64))
    rows = _sliding(x, ntaps)
    if w0 is None:
        w_init = jnp.zeros((ntaps,), cf32).at[0].set(1.0 + 0.0j)
    else:
        w_init = jnp.asarray(w0, dtype=cf32)
    mu = jnp.float32(mu)

    def step(w, row):
        y = jnp.sum(w * row)
        d2 = jnp.abs(pts - y) ** 2
        dec = pts[jnp.argmin(d2)]
        e = dec - y
        en = jnp.sum(jnp.real(row) ** 2 + jnp.imag(row) ** 2) + 1e-12
        w = w + (mu / en) * e * jnp.conj(row)
        return w, y

    w, y = jax.lax.scan(step, w_init, rows)
    return y.astype(cf32), w


def fdaf(
    x,
    d,
    ntaps: int,
    mu: float = 0.5,
    forget: float = 0.9,
    eps: float = 1e-6,
    fft_backend=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Frequency-domain adaptive filter (constrained overlap-save block
    NLMS): identify/track the system mapping ``x -> d`` with one weight
    update per ``B``-sample block — the accelerator-idiomatic adaptive
    filter.

    Where :func:`lms_equalize` updates per symbol (a serial scan of tiny
    dots), FDAF does all of its work as ``2B``-point batched FFTs and
    elementwise math, adapting ``B`` samples at a time: per block,
    ``Y = X . W`` (overlap-save), the error transforms back, each bin's
    step is normalized by its running input power (per-bin NLMS — uniform
    convergence across the spectrum, the classic FDAF advantage), and the
    gradient is projected back to causal length-``B`` support (the
    "constrained" variant — unbiased, exact LMS equivalence in
    expectation). The classic echo-canceller / long-channel-tracker
    structure.

    ``B`` is the smallest power of two >= ``ntaps`` (FFT size ``2B``).
    Returns ``(y, w, err)``: the filter output stream (length of ``x``,
    adapting as it goes), the final ``[ntaps]`` time-domain weights, and
    per-block RMS error (convergence monitor).
    """
    from ..ops import fft as _fft

    x = jnp.asarray(x, dtype=cf32)
    dd = jnp.asarray(d, dtype=cf32)
    n = x.shape[-1]
    if dd.shape[-1] != n:
        raise ValueError("x and d must have equal lengths")
    b = 1
    while b < ntaps:
        b *= 2
    nfft = 2 * b
    nb = -(-n // b)
    npad = nb * b
    if npad != n:
        pad = [(0, npad - n)]
        x = jnp.pad(x, pad)
        dd = jnp.pad(dd, pad)
    xb = x.reshape(nb, b)
    db = dd.reshape(nb, b)
    plan = _fft.plan(nfft, fft_backend)
    scale_n = _fft.Scale.N
    none = _fft.Scale.NONE
    mu = jnp.float32(mu)
    lam = jnp.float32(forget)
    zeros_b = jnp.zeros((b,), cf32)

    def step(carry, inp):
        w, p, prev = carry
        xcur, dcur = inp
        buf = jnp.concatenate([prev, xcur])
        xf = plan.fwd(buf, none)
        y = plan.bwd(xf * w, scale_n)[b:]
        e = dcur - y
        ef = plan.fwd(jnp.concatenate([zeros_b, e]), none)
        p = lam * p + (1.0 - lam) * (jnp.real(xf) ** 2 + jnp.imag(xf) ** 2)
        g = jnp.conj(xf) * ef / (p + eps)
        # gradient constraint: causal length-B support
        gt = plan.bwd(g, scale_n)
        g = plan.fwd(jnp.concatenate([gt[:b], zeros_b]), none)
        w = w + mu * g
        rms = jnp.sqrt(jnp.mean(jnp.real(e) ** 2 + jnp.imag(e) ** 2))
        return (w, p, xcur), (y, rms)

    w0 = jnp.zeros((nfft,), cf32)
    p0 = jnp.full((nfft,), jnp.float32(eps))
    (w, _, _), (yb, err) = jax.lax.scan(step, (w0, p0, zeros_b), (xb, db))
    y = yb.reshape(npad)[:n]
    w_time = plan.bwd(w, scale_n)[:ntaps]
    return y.astype(cf32), w_time.astype(cf32), err


def cma_equalize(
    x,
    ntaps: int = 11,
    mu: float = 0.005,
    r2: Optional[float] = None,
    w0=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Blind constant-modulus (Godard) equalizer: drives ``|y|^2`` toward
    the dispersion constant ``r2 = E[|s|^4]/E[|s|^2]`` (1.0 for unit PSK,
    the default) with no training at all — acquisition when nothing is
    known but the modulation family. Phase-blind (CMA leaves an arbitrary
    rotation; follow with a phase estimate or differential coding).

    Returns ``(y, w)`` with ``y`` the adapting output.
    """
    x = jnp.asarray(x, dtype=cf32)
    rows = _sliding(x, ntaps)
    if w0 is None:
        w_init = jnp.zeros((ntaps,), cf32).at[0].set(1.0 + 0.0j)
    else:
        w_init = jnp.asarray(w0, dtype=cf32)
    mu = jnp.float32(mu)
    r2 = jnp.float32(1.0 if r2 is None else r2)

    def step(w, row):
        y = jnp.sum(w * row)
        e = y * (jnp.abs(y) ** 2 - r2)  # Godard-2 gradient term
        en = jnp.sum(jnp.real(row) ** 2 + jnp.imag(row) ** 2) + 1e-12
        w = w - (mu / en) * e * jnp.conj(row)
        return w, y

    w, y = jax.lax.scan(step, w_init, rows)
    return y.astype(cf32), w


def rls_equalize(
    x,
    training,
    ntaps: int = 11,
    lam: float = 0.99,
    delta: float = 0.01,
    delay: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Trained RLS (recursive least squares): same contract as
    :func:`lms_equalize` but converging in ~2*ntaps symbols instead of
    hundreds (tested) — the short-preamble equalizer. The price is an
    ``[ntaps, ntaps]`` inverse-correlation state updated per step; at
    equalizer lengths (tens of taps) that is a tiny outer product per
    scan step, fused elementwise.

    ``lam``: forgetting factor (1.0 = growing window; < 1 tracks drift).
    ``delta``: initial inverse-correlation scale (P0 = I/delta) — small
    values mean aggressive early steps.
    """
    x = jnp.asarray(x, dtype=cf32)
    d = jnp.asarray(training, dtype=cf32)
    rows = _sliding(x, ntaps)
    m = min(int(d.shape[-1]), rows.shape[0] - int(delay))
    d = d[:m]
    train_rows = rows[delay : delay + m]
    w0 = jnp.zeros((ntaps,), cf32)
    p0 = jnp.eye(ntaps, dtype=cf32) / jnp.float32(delta)
    lamf = jnp.float32(lam)

    def step(carry, inp):
        w, p = carry
        u, dd = inp  # regression row, desired
        pu = p @ u
        denom = lamf + jnp.sum(jnp.conj(u) * pu)
        k = pu / denom
        e = dd - jnp.sum(jnp.conj(w) * u)
        w = w + k * jnp.conj(e)
        p = (p - k[:, None] * jnp.conj(pu)[None, :]) / lamf
        return (w, p), jnp.abs(e)

    (w, _), err = jax.lax.scan(step, (w0, p0), (train_rows, d))
    y = jnp.matmul(rows, jnp.conj(w))
    return y.astype(cf32), jnp.conj(w), err
