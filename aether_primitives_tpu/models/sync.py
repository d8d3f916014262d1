"""Synchronization and channel equalization for the modem chains.

Completes the receive story beyond the reference's scope: the reference's
modem loopback assumes perfect alignment and an ideal channel
(reference examples/modem.rs); a deployed receiver must first *find* the
signal and undo the channel. Both steps reuse the framework's primitives:

- :func:`detect_preamble` — timing acquisition via the overlap-save matched
  filter (peak of ``|matched_filter(x, preamble)|``); returns the sample
  offset where the preamble starts. One fused jitted computation (the
  argmax runs on device — no host scan).
- :class:`OfdmEqualizer` — one-tap per-subcarrier least-squares channel
  estimate from a known pilot frame (``H = Y_pilot / X_pilot``), applied as
  a per-bin divide before demod. Exact for any channel shorter than the
  frame's effective guard (here: the TX/RX pulse-shaping cascade).
- :func:`estimate_timing` — non-data-aided symbol-timing estimate
  (Oerder & Meyr square-law): the squared envelope of a pulse-shaped
  stream carries a spectral line at the symbol rate whose phase IS the
  timing offset. One reduction over the block — fully feedforward (no
  per-symbol feedback loop to serialize), the data-parallel form of timing
  recovery. Correct with :func:`~aether_primitives_tpu.ops.sampling.fractional_delay`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fft as _fft_mod
from ..ops import fir as _fir
from ..types import cf32


def detect_preamble(x, preamble, fft_backend: Optional[str] = None):
    """(offset, peak_metric) of the best preamble alignment in ``x``.

    ``offset`` is where the preamble's first sample sits;
    ``peak_metric`` is ``|correlation|^2 / energy(preamble)^2`` — 1.0 for a
    clean hit, near 0 for noise-only input (threshold it for detection).
    """
    x = jnp.asarray(x, dtype=cf32)
    pre = np.asarray(preamble, dtype=np.complex64)
    y = _fir.matched_filter(x, pre, fft_backend=fft_backend)
    mag2 = jnp.real(y) ** 2 + jnp.imag(y) ** 2
    peak_pos = jnp.argmax(mag2, axis=-1)
    energy = float(np.sum(np.abs(pre) ** 2))
    peak_val = jnp.take_along_axis(mag2, peak_pos[..., None], axis=-1)[..., 0]
    # matched filter peaks at offset + len(pre) - 1 (causal convention)
    offset = peak_pos - (pre.shape[-1] - 1)
    return offset, peak_val / jnp.float32(energy**2)


def estimate_timing(x, sps: int) -> jnp.ndarray:
    """Non-data-aided symbol-timing offset (Oerder & Meyr 1988 square-law).

    For a pulse-shaped linear modulation oversampled by ``sps`` (>= 3;
    classically 4) with excess bandwidth (e.g. RRC beta > 0), the squared
    envelope ``|x[n]|^2`` contains a tone at the symbol rate whose phase
    encodes the timing::

        tau = -sps/(2*pi) * arg( sum_n |x[n]|^2 e^{-j 2 pi n / sps} )

    Returns ``tau`` in SAMPLES, wrapped to ``[-sps/2, sps/2)``: the
    fractional delay by which the symbol instants lead the sample grid —
    advance the stream by ``tau`` (``fractional_delay(x, -tau)``) to put
    optimal sampling instants on indices ``0, sps, 2*sps, ...``. Fully
    feedforward (one reduction; batched over leading axes) — the
    block-parallel alternative to a Gardner/Mueller-Muller feedback loop,
    which would serialize per symbol.
    """
    x = jnp.asarray(x, dtype=cf32)
    env = jnp.real(x) ** 2 + jnp.imag(x) ** 2
    n = x.shape[-1]
    # e^{-j 2 pi n / sps} is periodic in sps: embed one exact period and
    # tile by reshape when sps divides n (the usual case), else build the
    # full ramp from host f64 (still exact mod 1)
    idx = np.arange(n, dtype=np.float64)
    tone = np.exp(-2j * np.pi * np.mod(idx, sps) / sps).astype(np.complex64)
    c = jnp.sum(env * jnp.asarray(tone), axis=-1)
    tau = -jnp.angle(c) * (sps / (2.0 * np.pi))
    # wrap to [-sps/2, sps/2)
    return jnp.mod(tau + sps / 2.0, float(sps)) - sps / 2.0


def estimate_baud_rate(x, osr: int = 4, min_rate: float = 0.02) -> jnp.ndarray:
    """Blind symbol-rate estimate (cycles/sample, f32) of a pulse-shaped
    linear modulation — the acquisition-side complement of
    :func:`estimate_timing`: the same square-law cyclostationary line,
    but with the rate UNKNOWN, so instead of correlating against one
    known tone the whole periodogram of the (mean-removed) squared
    envelope is searched for its strongest line. Zero-padding by ``osr``
    refines the grid; parabolic interpolation refines below the bin. One
    batched FFT + one argmax on device; batched over leading axes.

    Needs excess bandwidth (RRC beta > 0) like every square-law timing
    method, and a rate above ``min_rate`` (the DC skirt of the envelope
    spectrum is masked out). Resolution scales as ~1/(osr*n).
    """
    x = jnp.asarray(x, dtype=cf32)
    env = jnp.real(x) ** 2 + jnp.imag(x) ** 2
    env = env - jnp.mean(env, axis=-1, keepdims=True)
    n = env.shape[-1]
    nfft = int(osr) * int(2 ** np.ceil(np.log2(max(n, 2))))
    ez = jnp.concatenate(
        [env.astype(cf32), jnp.zeros(env.shape[:-1] + (nfft - n,), cf32)],
        axis=-1,
    )
    plan = _fft_mod.plan(nfft)
    mag = jnp.abs(plan.fwd(ez, _fft_mod.Scale.NONE))
    # search only (min_rate, 0.5]: mask DC skirt and negative frequencies
    k_lo = int(np.ceil(float(min_rate) * nfft))
    k_hi = nfft // 2 + 1
    mask = np.zeros(nfft, np.float32)
    mask[k_lo:k_hi] = 1.0
    mag = mag * jnp.asarray(mask)
    k = jnp.argmax(mag, axis=-1)
    km1 = jnp.take_along_axis(mag, ((k - 1) % nfft)[..., None], axis=-1)[..., 0]
    k0 = jnp.take_along_axis(mag, k[..., None], axis=-1)[..., 0]
    kp1 = jnp.take_along_axis(mag, ((k + 1) % nfft)[..., None], axis=-1)[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    off = jnp.where(jnp.abs(denom) > 1e-30, 0.5 * (km1 - kp1) / denom, 0.0)
    return ((k.astype(jnp.float32) + off) / nfft).astype(jnp.float32)


def _mpsk_grid_ref(m: int, grid: str) -> complex:
    """M-th-power reference of the constellation grid: ``"diagonal"``
    (the framework's BPSK/QPSK tables, points at ``pi/M + 2 pi k/M``)
    powers to ``e^{j pi}``; ``"axes"`` (index-linear :func:`psk_table`,
    points at ``2 pi k/M``) powers to ``e^{j 0}``. Using the wrong one
    locks a tracking loop ``pi/M`` off — onto the decision boundaries."""
    if grid == "diagonal":
        return complex(np.exp(-1j * np.pi))
    if grid == "axes":
        return 1.0 + 0.0j
    raise ValueError(f"grid must be 'diagonal' or 'axes', got {grid!r}")


def estimate_phase_mpsk(x, m: int = 4, grid: str = "diagonal") -> jnp.ndarray:
    """Feedforward carrier-phase estimate for M-PSK (Viterbi & Viterbi
    M-th power): raising M-PSK symbols to the M-th power wipes the data
    (``s^M`` is constant), leaving ``M`` times the common phase::

        phi = angle( sum_n x[n]^M ) / M

    Returns radians in ``[-pi/M, pi/M)`` — the estimate is modulo the
    constellation's ``2*pi/M`` rotational symmetry (resolve the ambiguity
    with a pilot or differential coding). The natural partner of the blind
    :func:`~aether_primitives_tpu.models.equalizer.cma_equalize`, which
    converges with an arbitrary rotation. One reduction, batched.

    For the standard QPSK table (constellation on the diagonals at
    ``pi/4 + k*pi/2``), a zero-offset stream returns ~0: the estimator
    references the M-th-power phase of the table itself (``(e^{j pi/4})^4
    = e^{j pi} = -1``), which is divided out before the angle.
    """
    x = jnp.asarray(x, dtype=cf32)
    acc = jnp.sum(x**m, axis=-1)
    # reference rotation of the constellation grid (see _mpsk_grid_ref;
    # default: the framework's diagonal tables)
    acc = acc * jnp.complex64(_mpsk_grid_ref(m, grid))
    return (jnp.angle(acc) / m).astype(jnp.float32)


def estimate_cfo(x, rep_len: int) -> jnp.ndarray:
    """Carrier-frequency-offset estimate from a repeated preamble
    (Schmidl & Cox): with ``x`` starting at two identical ``rep_len``-sample
    halves, a CFO of ``f`` cycles/sample rotates the second half by
    ``2*pi*f*rep_len``, so::

        f = angle( sum_n x[n + rep_len] * conj(x[n]) ) / (2*pi*rep_len)

    Unambiguous for ``|f| < 1/(2*rep_len)``. Returns cycles/sample (f32).
    """
    x = jnp.asarray(x, dtype=cf32)
    a = x[..., :rep_len]
    b = x[..., rep_len : 2 * rep_len]
    corr = jnp.sum(b * jnp.conj(a), axis=-1)
    return (jnp.angle(corr) / (2.0 * jnp.pi * rep_len)).astype(jnp.float32)


def estimate_cfo_blind(x, m: int = 4, osr: int = 4) -> jnp.ndarray:
    """Blind (non-data-aided) CFO estimate from M-PSK payload symbols.

    Raising the stream to the M-th power wipes the data and leaves a
    complex tone at ``M`` times the frequency offset; its frequency is
    read off the PERIODOGRAM peak — full coherent integration, so unlike
    the lag-1 autocorrelation estimator the variance shrinks with the
    whole block length even at low SNR (the M-th power costs ~12 dB of
    effective SNR for QPSK; the FFT gain buys it back). ``osr``
    zero-pads the transform for a finer grid; a parabolic interpolation
    of the peak's neighbors refines below the bin. One batched FFT + one
    argmax, all on device. Unambiguous for ``|f| < 1/(2M)`` cycles/sample.
    """
    x = jnp.asarray(x, dtype=cf32)
    z = x**m
    n = z.shape[-1]
    nfft = int(osr) * int(2 ** np.ceil(np.log2(max(n, 2))))
    zp = jnp.concatenate(
        [z, jnp.zeros(z.shape[:-1] + (nfft - n,), cf32)], axis=-1
    )
    plan = _fft_mod.plan(nfft)
    mag = jnp.abs(plan.fwd(zp, _fft_mod.Scale.NONE))
    k = jnp.argmax(mag, axis=-1)
    km1 = jnp.take_along_axis(mag, ((k - 1) % nfft)[..., None], axis=-1)[..., 0]
    k0 = jnp.take_along_axis(mag, k[..., None], axis=-1)[..., 0]
    kp1 = jnp.take_along_axis(mag, ((k + 1) % nfft)[..., None], axis=-1)[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    off = jnp.where(jnp.abs(denom) > 1e-30, 0.5 * (km1 - kp1) / denom, 0.0)
    kf = k.astype(jnp.float32) + off
    kf = jnp.where(kf > nfft / 2, kf - nfft, kf)  # signed frequency
    return (kf / (nfft * m)).astype(jnp.float32)


def apply_freq_shift(x, cycles_per_sample) -> jnp.ndarray:
    """Mix ``x`` by ``e^{-j 2 pi f n}`` (undo a +f CFO). Batched; the
    rotator is a fused elementwise exp, no host trig."""
    x = jnp.asarray(x, dtype=cf32)
    n = jnp.arange(x.shape[-1], dtype=jnp.float32)
    f = jnp.asarray(cycles_per_sample, dtype=jnp.float32)
    if f.ndim:
        f = f[..., None]  # per-row CFOs broadcast against the sample index
    ang = -2.0 * jnp.pi * f * n
    rot = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    return (x * rot).astype(cf32)


def costas_loop(
    x,
    m: int = 4,
    loop_bw: float = 0.01,
    damping: float = 0.7071,
    phase0: float = 0.0,
    freq0: float = 0.0,
    grid: str = "diagonal",
):
    """Second-order decision-free carrier-tracking PLL (Costas loop,
    M-th-power phase detector) — returns ``(y, phase, freq)`` where ``y``
    is the de-rotated stream and ``phase``/``freq`` are the per-sample
    loop traces (radians, radians/sample).

    The block estimators above (:func:`estimate_phase_mpsk`,
    :func:`estimate_cfo`) are the data-parallel fast path for *static*
    offsets — one reduction each. A *time-varying* carrier (oscillator
    phase noise, residual CFO drift, Doppler) needs feedback: this is the
    classic proportional-integral loop as a ``lax.scan`` carrying
    ``(phase, freq)``, with the M-th-power detector
    ``e = angle((y_n)^M · e^{-j·pi}) / M`` (data wiped for any M-PSK, same
    grid-reference rotation as :func:`estimate_phase_mpsk`; estimates are
    modulo ``2*pi/M``). Gains follow the standard loop-bandwidth
    normalization: ``theta = Bn/(zeta + 1/(4 zeta))``,
    ``Kp = 4 zeta theta / d``, ``Ki = 4 theta^2 / d`` with
    ``d = 1 + 2 zeta theta + theta^2``; ``Bn`` = ``loop_bw`` in cycles per
    SYMBOL (run at one sample/symbol after timing recovery).

    Serial by nature (each correction feeds the next decision), so the
    scan step is kept scalar-tiny; for multi-burst workloads batch via
    leading axes (the scan vectorizes across them). Track, then hand the
    corrected stream to the block demod.
    """
    x = jnp.asarray(x, dtype=cf32)
    zeta = float(damping)
    theta = float(loop_bw) / (zeta + 1.0 / (4.0 * zeta))
    d = 1.0 + 2.0 * zeta * theta + theta * theta
    kp = jnp.float32(4.0 * zeta * theta / d)
    ki = jnp.float32(4.0 * theta * theta / d)
    mm = jnp.float32(m)
    # grid reference: "diagonal" for the framework's BPSK/QPSK tables,
    # "axes" for index-linear psk_table constellations — the wrong one
    # locks pi/M off, onto the decision boundaries (see _mpsk_grid_ref)
    ref = jnp.complex64(_mpsk_grid_ref(m, grid))

    def step(carry, xn):
        phase, freq = carry
        rot = jax.lax.complex(jnp.cos(-phase), jnp.sin(-phase))
        y = xn * rot
        # M-th power detector, grid-referenced like estimate_phase_mpsk
        ym = y**m * ref
        err = jnp.angle(ym) / mm
        freq = freq + ki * err
        phase_out = phase
        phase = phase + freq + kp * err
        return (phase, freq), (y, phase_out, freq)

    init = (jnp.float32(phase0), jnp.float32(freq0))
    if x.ndim == 1:
        _, (y, ph, fr) = jax.lax.scan(step, init, x)
        return y.astype(cf32), ph, fr
    scan_t = jax.vmap(
        lambda row: jax.lax.scan(step, init, row)[1], in_axes=0, out_axes=0
    )
    y, ph, fr = scan_t(x.reshape(-1, x.shape[-1]))
    shp = x.shape
    return (
        y.reshape(shp).astype(cf32),
        ph.reshape(shp),
        fr.reshape(shp),
    )


def gardner_loop(
    x,
    sps: int = 2,
    loop_bw: float = 0.01,
    damping: float = 0.7071,
    n_symbols: Optional[int] = None,
):
    """Decision-free feedback symbol-timing recovery (Gardner 1986) —
    returns ``(symbols, tau_trace)``: one complex sample per symbol strobed
    at the loop's interpolated optimum, plus the per-symbol fractional
    position trace (in samples, for diagnostics).

    :func:`estimate_timing` is the data-parallel fast path for a *static*
    offset — one reduction. A *drifting* sample clock (TCXO ppm error,
    Doppler time dilation) needs feedback; this is the classic
    second-order loop as a ``lax.scan`` over symbols. The Gardner error
    ``e = Re{(y_k - y_{k-1}) · conj(y_{k-1/2})}`` uses only on-time and
    midpoint strobes — carrier-phase independent, so it runs *before*
    carrier recovery (pair with :func:`costas_loop` downstream).

    Strobes are cubic-Lagrange interpolations of 4 adjacent input samples
    (the same kernel as
    :func:`~aether_primitives_tpu.ops.sampling.resample_poly`'s Farrow
    operator) fetched with ``dynamic_slice`` inside the scan — serial by
    nature, so per-step work is kept tiny; batch bursts via leading axes.
    Loop gains use the standard bandwidth normalization (``loop_bw`` in
    cycles/symbol, cf. :func:`costas_loop`).

    ``n_symbols`` bounds the output (static shape). The default leaves an
    8-sample + 0.2% margin so a clock error up to ~2000 ppm cannot read
    past the buffer; reads are index-clamped regardless.
    """
    x = jnp.asarray(x, dtype=cf32)
    if x.ndim != 1:
        raise ValueError("gardner_loop takes a single stream; vmap for batches")
    n = int(x.shape[-1])
    sps = int(sps)
    if sps < 2:
        raise ValueError("Gardner needs >= 2 samples/symbol")
    if n_symbols is None:
        n_symbols = max(int((n - 8) // sps * 0.998) - 1, 0)
    zeta = float(damping)
    theta = float(loop_bw) / (zeta + 1.0 / (4.0 * zeta))
    d = 1.0 + 2.0 * zeta * theta + theta * theta
    kp = jnp.float32(4.0 * zeta * theta / d)
    ki = jnp.float32(4.0 * theta * theta / d)

    re = jnp.real(x)
    im = jnp.imag(x)
    nmax = jnp.float32(n - 3)

    def interp(p):
        """Cubic Lagrange at fractional position ``p`` (clamped)."""
        p = jnp.clip(p, 1.0, nmax - 1.0)
        i = jnp.floor(p).astype(jnp.int32)
        mu = p - i.astype(jnp.float32)
        rr = jax.lax.dynamic_slice(re, (i - 1,), (4,))
        ii = jax.lax.dynamic_slice(im, (i - 1,), (4,))
        c0 = -mu * (mu - 1.0) * (mu - 2.0) / 6.0
        c1 = (mu + 1.0) * (mu - 1.0) * (mu - 2.0) / 2.0
        c2 = -(mu + 1.0) * mu * (mu - 2.0) / 2.0
        c3 = (mu + 1.0) * mu * (mu - 1.0) / 6.0
        w = jnp.stack([c0, c1, c2, c3])
        return jax.lax.complex(jnp.sum(w * rr), jnp.sum(w * ii))

    def step(carry, _):
        pos, w, prev = carry
        y_on = interp(pos)
        y_mid = interp(pos - w * 0.5)
        # e > 0 <=> strobing LATE (midpoint sits on the transition slope
        # in the direction of y_on - prev), so the correction SUBTRACTS
        e = jnp.real((y_on - prev) * jnp.conj(y_mid))
        w_new = w - ki * e
        pos_new = pos + w_new - kp * e
        return (pos_new, w_new, y_on), (y_on, pos)

    w0 = jnp.float32(sps)
    carry0 = (jnp.float32(2.0 + sps), w0, jnp.complex64(0.0))
    _, (syms, tau) = jax.lax.scan(step, carry0, None, length=int(n_symbols))
    return syms.astype(cf32), tau


class OfdmEqualizer:
    """One-tap per-subcarrier equalizer from a known pilot frame.

    ``estimate(rx_pilot_spec, tx_pilot_spec)`` -> per-bin channel ``H``;
    ``apply(spec, H)`` divides it out. Bins where the pilot is zero (guard
    bands) get ``H = 1`` so the divide is a no-op there.
    """

    @staticmethod
    def estimate(rx_pilot_spec, tx_pilot_spec) -> jnp.ndarray:
        rx = jnp.asarray(rx_pilot_spec, dtype=cf32)
        tx = jnp.asarray(tx_pilot_spec, dtype=cf32)
        occupied = jnp.abs(tx) > 0
        h = jnp.where(occupied, rx / jnp.where(occupied, tx, 1.0), 1.0)
        return h.astype(cf32)

    @staticmethod
    def apply(spec, h) -> jnp.ndarray:
        return (jnp.asarray(spec, dtype=cf32) / jnp.asarray(h, dtype=cf32)).astype(
            cf32
        )


def code_tracking_loop(
    x,
    chips,
    sps: int = 2,
    loop_bw: float = 0.005,
    damping: float = 0.7071,
    n_dwells: Optional[int] = None,
):
    """Early-late delay-locked loop (DLL) for DSSS/GNSS code tracking —
    returns ``(prompt, tau_trace)``: one complex prompt correlation per
    code period (the despread symbol stream; its angle carries the data
    and residual carrier) plus the tracked code phase in samples.

    The spreading-code complement of :func:`gardner_loop`: after
    acquisition (:func:`~aether_primitives_tpu.models.caf.ambiguity`
    over e.g. :func:`~aether_primitives_tpu.ops.sequence.gps_ca_code`)
    pins the code phase to a sample, a drifting chip clock (TCXO ppm
    error, Doppler time dilation) needs feedback to hold it. Per dwell
    the scan fetches one code period of samples, applies the COMMON
    fractional shift with a cubic 4-tap kernel (one vectorized pass —
    every sample in a dwell shares the loop's tau), despreads at three
    half-chip-spaced lags, and drives a second-order loop with the
    normalized noncoherent early-late power discriminator
    ``(|E|^2 - |L|^2) / (|E|^2 + |L|^2)`` — carrier-phase and CFO
    insensitive, so it runs before any carrier recovery.

    ``chips``: the code in {0,1} or ±1, length L (one dwell = ``L*sps``
    samples nominal); ``sps`` integer samples/chip >= 2; ``loop_bw`` in
    cycles/dwell. Alignment contract: slice the capture so the code's
    first chip begins ~``sps`` samples in (one chip of lead-in — the
    acquisition's code phase gives the slice point); the loop then locks
    with ``tau`` near 0 and follows clock drift from there. Pull-in
    range is ~±half a chip and the slew limit is set by ``loop_bw``
    (drift per dwell must stay well under ``kp * sps/2`` — any real
    TCXO/Doppler is orders below it). 1-D input; vmap for batches.
    """
    x = jnp.asarray(x, dtype=cf32)
    if x.ndim != 1:
        raise ValueError("code_tracking_loop takes one stream; vmap batches")
    sps = int(sps)
    if sps < 2:
        raise ValueError("DLL needs >= 2 samples/chip (half-chip lags)")
    c = np.asarray(chips)
    code = np.where(c > 0.5, 1.0, -1.0).astype(np.float32) if c.min() >= 0 \
        else c.astype(np.float32)
    l_chips = code.shape[-1]
    dwell = l_chips * sps
    half = sps // 2
    n = int(x.shape[-1])
    if n_dwells is None:
        # leave a margin for the fractional window and clock drift
        n_dwells = max((n - 2 * sps - 8) // dwell - 1, 1)

    zeta = float(damping)
    theta = float(loop_bw) / (zeta + 1.0 / (4.0 * zeta))
    d = 1.0 + 2.0 * zeta * theta + theta * theta
    kp = jnp.float32(4.0 * zeta * theta / d)
    ki = jnp.float32(4.0 * theta * theta / d)

    re = jnp.real(x)
    im = jnp.imag(x)
    code_j = jnp.asarray(code)
    win = dwell + 2 * half + 4  # E..L span + cubic kernel margin
    nmax = jnp.float32(n - win - 2)

    def despread(seg_r, seg_i, off):
        cols_r = jax.lax.dynamic_slice(seg_r, (off,), (dwell,)).reshape(
            l_chips, sps
        )[:, 0]
        cols_i = jax.lax.dynamic_slice(seg_i, (off,), (dwell,)).reshape(
            l_chips, sps
        )[:, 0]
        return jnp.dot(code_j, cols_r), jnp.dot(code_j, cols_i)

    def step(carry, k):
        tau, rate = carry
        base = k.astype(jnp.float32) * dwell + tau
        base = jnp.clip(base, 1.0, nmax)
        i0 = jnp.floor(base).astype(jnp.int32)
        mu = base - i0.astype(jnp.float32)
        wr = jax.lax.dynamic_slice(re, (i0 - 1,), (win,))
        wi = jax.lax.dynamic_slice(im, (i0 - 1,), (win,))
        # common fractional shift: cubic Lagrange on the whole window
        c0 = -mu * (mu - 1.0) * (mu - 2.0) / 6.0
        c1 = (mu + 1.0) * (mu - 1.0) * (mu - 2.0) / 2.0
        c2 = -(mu + 1.0) * mu * (mu - 2.0) / 2.0
        c3 = (mu + 1.0) * mu * (mu - 1.0) / 6.0
        sr = (c0 * wr[:-3] + c1 * wr[1:-2] + c2 * wr[2:-1] + c3 * wr[3:])
        si = (c0 * wi[:-3] + c1 * wi[1:-2] + c2 * wi[2:-1] + c3 * wi[3:])
        er, ei = despread(sr, si, 0)          # early  (-half samples)
        pr, pi = despread(sr, si, half)       # prompt
        lr, li = despread(sr, si, 2 * half)   # late   (+half samples)
        pe = er * er + ei * ei
        pl = lr * lr + li * li
        # > 0 when the EARLY lag matches best, i.e. the signal's code sits
        # earlier than the local prompt -> move the local window earlier
        err = (pe - pl) / (pe + pl + 1e-12)
        rate_new = rate - ki * err * jnp.float32(half)
        tau_new = tau + rate_new - kp * err * jnp.float32(half)
        return (tau_new, rate_new), (jax.lax.complex(pr, pi), tau + jnp.float32(half))

    ks = jnp.arange(int(n_dwells), dtype=jnp.int32)
    # geometric equilibrium for the documented alignment (code phase 0 at
    # sample sps): prompt lag sits half a chip into each chip
    tau0 = jnp.float32(sps - half)
    _, (prompt, tau_trace) = jax.lax.scan(step, (tau0, jnp.float32(0.0)), ks)
    return prompt, tau_trace


def carrier_tracking_loop(
    prompts,
    pll_bw: float = 0.03,
    fll_bw: float = 0.3,
    damping: float = 0.7071,
):
    """FLL-assisted Costas PLL on a despread prompt stream — the carrier
    layer of a GNSS/DSSS tracking channel, joined to
    :func:`code_tracking_loop`'s output.

    The DLL's prompt correlations still rotate at the residual carrier
    (CFO x dwell cycles per prompt) and carry the BPSK nav data in their
    sign; this loop wipes the carrier so the data lands on the real axis:

    - **FLL** (pull-in): the data-invariant cross/dot discriminator
      between consecutive derotated prompts,
      ``f_err = atan2(I0*Q1 - Q0*I1, I0*I1 + Q0*Q1) / 2pi`` cycles/dwell
      — immune to 180 deg data flips, pull range +-1/4 cycle/dwell (vs
      the PLL's +-1/8), so large initial CFOs converge;
    - **PLL** (precision): the Costas ``atan(Q/I) / 2pi`` phase
      discriminator (also data-flip invariant) through a second-order
      proportional-integral loop (same gain derivation as
      :func:`costas_loop` / :func:`gardner_loop`).

    Returns ``(wiped, phase_trace, freq_trace)``: derotated prompts
    (data on the real axis, up to the Costas 180 deg ambiguity — resolve
    with :func:`nav_bit_sync` + the frame preamble, as GPS does),
    accumulated phase (cycles), and per-dwell frequency (cycles/dwell).
    1-D input; vmap for batches. ``pll_bw``/``fll_bw`` in cycles/dwell.
    """
    p = jnp.asarray(prompts, dtype=cf32)
    if p.ndim != 1:
        raise ValueError("carrier_tracking_loop takes one stream; vmap batches")
    zeta = float(damping)
    theta = float(pll_bw) / (zeta + 1.0 / (4.0 * zeta))
    d = 1.0 + 2.0 * zeta * theta + theta * theta
    kp = jnp.float32(4.0 * zeta * theta / d)
    ki = jnp.float32(4.0 * theta * theta / d)
    kf = jnp.float32(fll_bw)
    pr, pi = jnp.real(p), jnp.imag(p)
    two_pi = jnp.float32(2.0 * np.pi)

    def step(carry, xy):
        phi, freq, i_prev, q_prev = carry
        r, i = xy
        c = jnp.cos(-two_pi * phi)
        s = jnp.sin(-two_pi * phi)
        iw = r * c - i * s
        qw = r * s + i * c
        # FLL cross/dot between consecutive wiped prompts, folded by
        # sign(dot): the plain atan2(cross, dot) is invariant to a COMMON
        # data flip but reads ~+-1/2 cycle across a nav-bit EDGE (the two
        # prompts differ by pi), biasing the loop once per bit; folding
        # halves the range to +-1/4 cycle/dwell and makes edges read ~0
        cross = i_prev * qw - q_prev * iw
        dot = i_prev * iw + q_prev * qw
        f_err = jnp.arctan2(
            cross * jnp.sign(dot), jnp.abs(dot) + 1e-12
        ) / two_pi
        # Costas atan discriminator (data-invariant), cycles
        p_err = jnp.arctan2(qw, jnp.abs(iw) + 1e-12) * jnp.sign(iw) / two_pi
        freq_new = freq + ki * p_err + kf * f_err
        phi_new = phi + freq_new + kp * p_err
        out = (jax.lax.complex(iw, qw), phi, freq_new)
        return (phi_new, freq_new, iw, qw), out

    init = (jnp.float32(0.0), jnp.float32(0.0),
            jnp.float32(1.0), jnp.float32(0.0))
    _, (wiped, phase_trace, freq_trace) = jax.lax.scan(
        step, init, (pr, pi)
    )
    return wiped, phase_trace, freq_trace


def nav_bit_sync(symbols, period: int = 20):
    """Bit synchronization + decision for a carrier-wiped prompt stream
    whose BPSK data lasts ``period`` prompts per bit (GPS L1 C/A: 50 bps
    over 1 ms code periods -> 20).

    Tries all ``period`` edge offsets, scores each by the summed
    magnitude of its coherent per-bit integrations (a misaligned edge
    splits energy across sign flips), and returns ``(bits, offset,
    quality)`` for the argmax — ``bits [n_bits]`` uint8 (0 = +I; the
    Costas 180 deg ambiguity means a frame preamble must resolve global
    polarity, as in a real receiver), ``offset`` the winning edge phase,
    ``quality`` the winner's mean per-bit |integration| normalized by
    the stream's mean |symbol| x period (1.0 = fully coherent). Static
    shapes throughout: one ``[period, n_bits]`` reduction per offset.
    """
    s = jnp.asarray(symbols, dtype=cf32)
    if s.ndim != 1:
        raise ValueError("nav_bit_sync takes one stream; vmap batches")
    n = s.shape[-1]
    per = int(period)
    n_bits = (n - per + 1) // per  # complete bits at the worst offset
    if n_bits < 1:
        raise ValueError(f"need >= {2 * per - 1} symbols, got {n}")
    sums = []
    for off in range(per):
        seg = jax.lax.dynamic_slice_in_dim(s, off, n_bits * per, axis=0)
        sums.append(seg.reshape(n_bits, per).sum(axis=-1))
    sums = jnp.stack(sums)  # [period, n_bits]
    score = jnp.sum(jnp.abs(sums), axis=-1)
    best = jnp.argmax(score)
    win = sums[best]
    bits = (jnp.real(win) < 0).astype(jnp.uint8)
    denom = jnp.mean(jnp.abs(s)) * per * n_bits + 1e-12
    quality = score[best] / denom
    return bits, best, quality
