"""FIR filtering and frequency-domain correlation.

The reference's ``src/fir.rs`` is a non-functional stub (SURVEY.md §2 #7);
its only *working* correlator is the freq-domain composition in its benches
(``vec_rfft -> vec_mul(conj) -> vec_rifft``, reference benches/benches.rs:
410-417), and its README lists FIR and freq-domain convolution as TODO
(reference README.md:95-96). This module supplies the finished capability:

- :func:`fir_filter` / :func:`fir_filter_decimate` — causal time-domain
  FIR as a shift-and-add over K static stride-1 slices of split re/im
  planes (a fused multiply-add chain). ``lax.conv`` is deliberately not
  used for batch-1/channel-1 filtering, and decimation can instead fuse
  into the FFT (:func:`..fft.mm_fft_decimate`).
- :func:`fir_filter_os` — overlap-save block convolution through the FFT
  backend: for long blocks the cost is two FFTs + one element-wise multiply
  per block, the classic O(log L) per sample path. This is also the form
  that shards across chips with a (taps-1)-sample halo exchange
  (:mod:`aether_primitives_tpu.parallel.halo`).
- :func:`correlate` — circular frequency-domain correlation
  ``ifft(fft(x) * conj(fft(ref)))``, the cleaned-up semantics of the
  reference bench correlator (which multiplied by the conjugated
  *time-domain* reference; the intent per its own naming was spectral
  correlation — we implement the mathematically meaningful op and test it
  against a direct O(N^2) golden).

Convention: ``y[n] = sum_k taps[k] * x[n - k]`` with zero initial state
(causal, "same" length output).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32
from . import fft as _fft
from .fft import Scale


def _as_c64(x):
    return jnp.asarray(x, dtype=cf32)


def _good_fft_size(n: int) -> int:
    """Smallest 7-smooth integer >= n (factors only 2/3/5/7).

    7-smooth sizes always factor into <=128 chunks for the matmul FFT, and
    choosing the smallest such size instead of the next power of two nearly
    halves overlap-save FFT work for block lengths just past a power of two
    (e.g. 8224 -> 8232 instead of 16384).
    """
    best = 1
    while best < n:
        best *= 2
    # exhaustive smooth search up to the power-of-two bound
    smooth = [1]
    for p in (2, 3, 5, 7):
        smooth = sorted(
            {s * p**e for s in smooth for e in range(0, 20) if s * p**e <= best}
        )
    for s in smooth:
        if s >= n:
            return int(s)
    return int(best)


def rrc_taps(sps: int, span: int = 10, beta: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse-shaping taps (host f64 design, complex64).

    ``sps`` samples/symbol, ``span`` symbols each side (length
    ``2*span*sps + 1``), roll-off ``beta`` in (0, 1]. Normalized to unit
    energy so a matched TX/RX pair has unity cascade gain at the symbol
    instants. The standard pulse for the timing-recovery path
    (:func:`~aether_primitives_tpu.models.sync.estimate_timing` needs the
    excess-bandwidth line beta > 0 provides).
    """
    if not 0.0 < beta <= 1.0:
        raise ValueError("beta must be in (0, 1]")
    t = np.arange(-span * sps, span * sps + 1, dtype=np.float64) / sps
    h = np.empty_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif abs(abs(4.0 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
            )
        else:
            num = np.sin(np.pi * ti * (1.0 - beta)) + 4.0 * beta * ti * np.cos(
                np.pi * ti * (1.0 + beta)
            )
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            h[i] = num / den
    h /= np.sqrt(np.sum(h * h))
    return h.astype(np.complex64)


def fir_filter(x, taps) -> jnp.ndarray:
    """Causal FIR: ``y[n] = sum_k taps[k] x[n-k]``, output same length as x.

    Realized as :func:`fir_filter_decimate` with factor 1 — a shift-and-add
    over K static stride-1 slices on split re/im planes (see that
    function's note on ``lax.conv``). Batched over leading axes.
    For long tap counts prefer :func:`fir_filter_os`.
    """
    return fir_filter_decimate(x, taps, 1)


def fir_filter_decimate(x, taps, factor: int, padding: str = "causal") -> jnp.ndarray:
    """Fused causal FIR + decimation: ``y[m] = sum_k taps[k] x[m*factor - k]``.

    The polyphase identity the fused chain leans on: filtering then keeping
    every ``factor``-th sample computes (and discards) ``factor-1`` of every
    ``factor`` outputs — a strided convolution computes only the survivors,
    cutting FIR work by ``factor`` with bit-identical results to
    ``downsample(fir_filter(x, taps), n/factor)``.

    ``padding="causal"`` left-pads ``taps-1`` zeros (fresh stream);
    ``padding="valid"`` assumes the input is already extended with its
    ``taps-1``-sample history (the sharded halo path) and emits
    ``(n - taps + 1) / factor`` outputs aligned to the first fresh sample.

    Implementation note: this is a **shift-and-add** over K static
    strided slices, not ``lax.conv`` — a batch-1/channel-1 strided conv
    is a poor fit for convolution libraries built for many channels,
    while K multiply-adds on contiguous slices are plain elementwise
    work that XLA can fuse.
    """
    x = _as_c64(x)
    taps = _as_c64(taps)
    k = taps.shape[-1]
    s = int(factor)
    if padding == "causal":
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(k - 1, 0)])
    n_ext = x.shape[-1]
    n_out = (n_ext - k) // s + 1
    xr = jnp.real(x)
    xi = jnp.imag(x)
    tr = jnp.real(taps)
    ti = jnp.imag(taps)

    def tap_slice(plane, t):
        # column for tap t: ext[m*s + (k-1) - t], m = 0..n_out-1
        start = k - 1 - t
        return jax.lax.slice_in_dim(
            plane, start, start + (n_out - 1) * s + 1, stride=s, axis=-1
        )

    yr = jnp.zeros(xr.shape[:-1] + (n_out,), jnp.float32)
    yi = jnp.zeros_like(yr)
    for t in range(k):
        sr = tap_slice(xr, t)
        si = tap_slice(xi, t)
        a = tr[t]
        b = ti[t]
        yr = yr + a * sr - b * si
        yi = yi + a * si + b * sr
    return jax.lax.complex(yr, yi).astype(cf32)


def fir_filter_os(
    x,
    taps,
    block_len: Optional[int] = None,
    fft_backend: Optional[str] = None,
    history=None,
    fft_len: Optional[int] = None,
) -> jnp.ndarray:
    """Causal FIR via overlap-save block convolution (freq domain).

    Splits the signal into blocks of ``block_len`` fresh samples, each
    extended with the previous ``K-1`` samples (zero history before the
    first block), multiplies the block spectrum by the precomputed tap
    spectrum, inverse-transforms, and discards the first ``K-1`` outputs of
    each block. Exactly equal (to rounding) to :func:`fir_filter`.

    ``history``: optional ``[..., K-1]`` samples preceding ``x`` (the halo
    received from the left-neighbor shard in the sharded chain); defaults to
    zeros — the causal initial state.

    ``taps`` may carry leading batch axes (``[..., K]``) that broadcast
    against ``x``'s batch axes — each row filtered by its own taps with ONE
    shared tap-spectrum transform (the per-channel frame-axis FIR of
    :func:`~aether_primitives_tpu.models.channelizer.pfb_synthesize` uses
    this).

    Any ``block_len >= K-1`` works (the tail block is zero-padded and the
    output sliced back); the default picks a power-of-two near
    ``max(1024, 8*K)``. All blocks are processed as one batched FFT, so
    throughput is the batched-FFT rate.
    """
    x = _as_c64(x)
    taps = _as_c64(taps)
    n = x.shape[-1]
    k = taps.shape[-1]
    if block_len is None:
        # the power of two nearest max(1024, 8K); divisibility is no longer
        # required — the tail block pads and the output slices back
        target = max(1024, 8 * k)
        block_len = 1024
        while block_len * 2 <= target:
            block_len *= 2
        block_len = min(block_len, max(n, k - 1 if k > 1 else 1))
    block_len = int(block_len)
    if k > 1 and block_len < k - 1:
        raise ValueError(f"block_len {block_len} must be >= taps-1 ({k - 1})")
    # any block length works: pad the tail block with zeros and slice the
    # output back to n (zeros after the real data produce only the filter
    # decay, which the final slice discards)
    n_pad = -(-n // block_len) * block_len
    if n_pad != n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n_pad - n)])
    if fft_len is None:
        fft_len = _good_fft_size(block_len + k - 1)
    elif fft_len < block_len + k - 1:
        raise ValueError(f"fft_len {fft_len} < block_len + taps - 1")
    nblocks = n_pad // block_len

    batch = x.shape[:-1]
    xb = x.reshape(batch + (nblocks, block_len))
    if k > 1:
        # history rows: external history for block 0, then each previous
        # block's last K-1 samples
        if history is None:
            h0 = jnp.zeros(batch + (1, k - 1), dtype=cf32)
        else:
            h0 = _as_c64(history)
            if h0.shape[-1] != k - 1:
                raise ValueError(f"history must have K-1 = {k - 1} samples")
            h0 = jnp.broadcast_to(h0, batch + (k - 1,))[..., None, :]
        prev_tails = xb[..., :-1, -(k - 1):]
        hist = jnp.concatenate([h0, prev_tails], axis=-2)
    else:
        hist = xb[..., :0]
    ext = jnp.concatenate([hist, xb], axis=-1)  # [..., nblocks, K-1+block_len]
    pad = fft_len - ext.shape[-1]
    if pad:
        ext = jnp.pad(ext, [(0, 0)] * (ext.ndim - 1) + [(0, pad)])

    h = jnp.zeros(taps.shape[:-1] + (fft_len,), dtype=cf32).at[..., :k].set(taps)
    plan = _fft.plan(fft_len, fft_backend)
    hspec = plan.fwd(h, Scale.NONE)
    if h.ndim > 1:  # per-row taps: broadcast across the block axis
        hspec = hspec[..., None, :]
    spec = plan.fwd(ext, Scale.NONE) * hspec
    y = plan.bwd(spec, Scale.N)
    y = y[..., (k - 1) : (k - 1) + block_len] if k > 1 else y[..., :block_len]
    return y.reshape(batch + (n_pad,))[..., :n].astype(cf32)


def fir_filter_os_decimate(
    x,
    taps,
    factor: int,
    block_len: Optional[int] = None,
    fft_backend: Optional[str] = None,
    history=None,
) -> jnp.ndarray:
    """Fused overlap-save FIR + decimation with a **time-domain** output:
    ``y[m] = sum_k taps[k] x[m*factor - k]`` — equal (to rounding) to
    ``fir_filter_decimate(x, taps, factor)`` but at the overlap-save cost
    model, with the inverse transform shrunk by ``factor``.

    The dense formulation (contrast :func:`fir_decimate_fft`, whose output is
    the *frame spectrum* for chains that FFT right after): keeping every
    ``factor``-th sample of the block's circular convolution is a spectral
    fold — with ``M = fft_len / factor``,

        y_dec[i] = iFFT_M( fold )[i],
        fold[r] = (1/factor) * sum_p Y[r + p*M]

    where ``Y`` is the product spectrum *pre-rotated* by
    ``e^{+2pi i q (K-1)/fft_len}`` so the overlap-save discard of the first
    ``K-1`` samples lands on fold index 0 (the rotation rides the
    precomputed tap spectrum — free). The fold is a major-axis reshape +
    mean (stride-1, lane-safe); no strided slice ever materializes, and the
    backward FFT runs at ``1/factor`` the points of the plain
    :func:`fir_filter_os` + ``downsample`` composition.

    Output positions are global multiples of ``factor`` (causal
    convention), ``ceil(n / factor)`` samples total. ``history`` as in
    :func:`fir_filter_os`. This is the core of the digital down-converter
    (:class:`aether_primitives_tpu.models.ddc.Ddc`). ``taps`` must be host
    numpy (the rotated tap spectrum precomputes in f64 at trace time).
    """
    x = _as_c64(x)
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    n = x.shape[-1]
    k = taps.shape[-1]
    s = int(factor)
    if s < 1:
        raise ValueError("factor must be >= 1")
    if s == 1:
        return fir_filter_os(
            x, taps, block_len=block_len, fft_backend=fft_backend,
            history=history,
        )
    if block_len is None:
        target = max(1024, 8 * k)
        block_len = s
        while block_len * 2 <= target:
            block_len *= 2
    block_len = int(block_len)
    if block_len % s:
        raise ValueError(f"block_len {block_len} must be a multiple of {s}")
    if k > 1 and block_len < k - 1:
        raise ValueError(f"block_len {block_len} must be >= taps-1 ({k - 1})")
    # fft_len = factor * M with M 7-smooth: guarantees the fold divides
    # evenly and the backward M-point plan factors well
    m_len = _good_fft_size(-(-(block_len + k - 1) // s))
    fft_len = s * m_len

    n_pad = -(-n // block_len) * block_len
    if n_pad != n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n_pad - n)])
    nblocks = n_pad // block_len
    batch = x.shape[:-1]
    xb = x.reshape(batch + (nblocks, block_len))
    if k > 1:
        if history is None:
            h0 = jnp.zeros(batch + (1, k - 1), dtype=cf32)
        else:
            h0 = _as_c64(history)
            if h0.shape[-1] != k - 1:
                raise ValueError(f"history must have K-1 = {k - 1} samples")
            h0 = jnp.broadcast_to(h0, batch + (k - 1,))[..., None, :]
        prev_tails = xb[..., :-1, -(k - 1):]
        hist = jnp.concatenate([h0, prev_tails], axis=-2)
    else:
        hist = xb[..., :0]
    ext = jnp.concatenate([hist, xb], axis=-1)
    pad = fft_len - ext.shape[-1]
    if pad:
        ext = jnp.pad(ext, [(0, 0)] * (ext.ndim - 1) + [(0, pad)])

    # tap spectrum x discard rotation, precomputed in f64 on host
    hs = np.fft.fft(np.asarray(taps, np.complex64).astype(np.complex128),
                    fft_len)
    hs *= np.exp(2j * np.pi * np.arange(fft_len) * (k - 1) / fft_len)
    spec = _fft.plan(fft_len, fft_backend).fwd(ext, Scale.NONE)
    spec = spec * jnp.asarray(hs.astype(np.complex64))
    fold = jnp.mean(
        spec.reshape(spec.shape[:-1] + (s, m_len)), axis=-2
    )
    yd = _fft.plan(m_len, fft_backend).bwd(fold, Scale.N)
    yd = yd[..., : block_len // s]  # fresh decimated outputs of each block
    n_out = -(-n // s)
    return yd.reshape(batch + (n_pad // s,))[..., :n_out].astype(cf32)


@functools.lru_cache(maxsize=None)
def _fused_stage_matrices(
    taps_bytes: bytes, k: int, dec: int, fft_len: int, n1: int
):
    """Two-matrix factorization of (circular FIR ∘ decimate ∘ DFT) per frame.

    Cooley-Tukey over ``span = n1 * n2`` with output ``X[k1 + n1*k2]``:
    stage 1 is the dense ``DFT_{n1}`` contraction; stage 2's DFT, the
    twiddles, the tap spectrum ``Hs`` (circular convolution diagonal), and
    the decimation **spectral fold** ``Z[j] = (1/dec) sum_p Y[j + p*fft_len]``
    all collapse into one precomputed (f64) tensor

        G'[k1, m2, d] = T[k1, m2] * (1/dec) *
                        sum_p F2[m2, d + p*r] * Hs[k1 + n1*(d + p*r)]

    (``r = fft_len / n1``, ``d < r``; ``T`` = twiddles, ``F2 = DFT_{n2}``),
    so the on-device work is exactly two einsums and the folded 8192-point
    spectrum is never materialized. Returns ``(f1 [n1, n1], G' [n1, n2, r])``
    complex64.
    """
    h = np.frombuffer(taps_bytes, dtype=np.complex64).astype(np.complex128)
    span = dec * fft_len
    n2 = span // n1
    r = fft_len // n1
    hs = np.fft.fft(h, span)  # [span], f64
    k1 = np.arange(n1, dtype=np.float64)
    m2 = np.arange(n2, dtype=np.float64)
    f1 = np.exp(-2j * np.pi / n1 * np.outer(k1, k1))  # [n, k1] (symmetric)
    t = np.exp(-2j * np.pi / span * np.outer(k1, m2))  # twiddle [k1, m2]
    f2 = np.exp(-2j * np.pi / n2 * np.outer(m2, m2))  # [m2, k2]
    # k2 grid of the fold: k2 = d + p*r, d < r, p < dec
    k2_idx = np.arange(r)[:, None] + r * np.arange(dec)[None, :]  # [d, p]
    f2_sel = f2[:, k2_idx]  # [m2, d, p]
    hs_m = hs.reshape(n2, n1).T  # Hs[k1 + n1*k2] -> [k1, k2]
    hs_sel = hs_m[:, k2_idx]  # [k1, d, p]
    g = np.einsum("mdp,kdp->kmd", f2_sel, hs_sel) / dec  # [k1, m2, d]
    g *= t[:, :, None]
    return f1.astype(np.complex64), g.astype(np.complex64)


def _fused_stage_n1(
    dec: int, fft_len: int, override: Optional[int] = None
) -> Optional[int]:
    """First-stage size for the two-einsum path.

    Resolution order: explicit ``override`` (validated), then the
    heuristic — the largest ``n1 | fft_len`` with ``n1 <= 128`` whose
    G' tensor (``span * fft_len / n1`` entries) stays under ~4 MB.
    ``override`` wins when given — the chain exposes it as
    ``RxChainConfig.stage_n1`` because the choice trades stage-1 contraction
    depth against stage-2's minor-dim layout and total FLOPs, which only
    a measurement on the device can settle.
    """
    span = dec * fft_len
    if override is not None:
        n1 = int(override)
        if n1 < 1 or fft_len % n1:
            raise ValueError(
                f"stage_n1 {n1} must divide fft_len {fft_len}"
            )
        # G' has span * (fft_len/n1) complex64 entries; cap at 64 MB to
        # catch typos, not to tune (the tensor is HBM-resident weights)
        if span * (fft_len // n1) * 8 > 64 << 20:
            raise ValueError(f"stage_n1 {n1} implies a >64 MB G' tensor")
        return n1
    for n1 in range(min(fft_len, 128), 0, -1):
        if fft_len % n1 == 0:
            if span * (fft_len // n1) * 8 <= 4 << 20:
                return n1
            return None
    return None


@functools.lru_cache(maxsize=None)
def _fused_rx_matrices(taps_bytes: bytes, k: int, dec: int, fft_len: int):
    """Precomputed (f64) constants for :func:`fir_decimate_fft`.

    Returns ``(Hs [span], Cm [K-1, fft_len])`` complex64:

    - ``Hs``: span-point DFT of the taps — the circular-convolution diagonal.
    - ``Cm``: the wrap-correction operator. The span-point circular
      convolution ``c`` of a frame differs from the true causal FIR output
      ``y`` only in its first ``K-1`` samples:
      ``e[m] = c[m] - y[m] = sum_{u=m}^{K-2} h[m+(K-1)-u] *
      (cur_tail[u] - prev_tail[u])`` where the tails are the last ``K-1``
      samples of the current / previous frame. Decimating ``e`` and taking
      its ``fft_len``-point DFT is the composite
      ``Cm[u, k] = sum_{m2} T[dec*m2, u] e^{-2pi i k m2 / fft_len}`` with
      ``T[m, u] = h[m + (K-1) - u]`` (upper-triangular band).
    """
    h = np.frombuffer(taps_bytes, dtype=np.complex64).astype(np.complex128)
    span = dec * fft_len
    hs = np.fft.fft(h, span).astype(np.complex64)
    if k <= 1:
        return hs, np.zeros((0, fft_len), np.complex64)
    t = np.zeros((k - 1, k - 1), np.complex128)
    for m in range(k - 1):
        for u in range(m, k - 1):
            t[m, u] = h[m + (k - 1) - u]
    td = t[::dec, :]  # decimated error rows: m = 0, dec, 2*dec, ...
    m2 = np.arange(td.shape[0], dtype=np.float64)
    kk = np.arange(fft_len, dtype=np.float64)
    f = np.exp(-2j * np.pi / fft_len * np.outer(m2, kk))
    cm = np.einsum("mu,mk->uk", td, f).astype(np.complex64)
    return hs, cm


def fir_decimate_fft(
    x,
    taps: np.ndarray,
    dec: int,
    fft_len: int,
    scale: Scale = Scale.NONE,
    history=None,
    fft_backend: Optional[str] = None,
    precision=None,
    stage_n1: Optional[int] = None,
    _staged_layout: bool = False,
) -> jnp.ndarray:
    """Fused causal FIR -> decimate-by-``dec`` -> blocked ``fft_len``-point
    FFT, as ONE forward FFT per frame — the RX chain's hot path.

    Equivalent (to rounding) to::

        y = fir_filter(x, taps)                      # causal FIR
        z = y.reshape(..., nsym, dec * fft_len)      # frame
        out = fft(z[..., ::dec])                     # decimate + FFT

    but with the overlap-save round trip (FFT -> H -> iFFT -> discard ->
    reshape -> decimating FFT: three transform passes) collapsed into one
    span-point forward FFT per frame plus O(K * fft_len) fix-up flops:

    1. frame the input at full rate: ``span = dec * fft_len`` samples/frame;
    2. span-point forward FFT (matmul backend: pure matmuls), multiply by the
       precomputed tap spectrum ``Hs`` — the *circular* convolution of each
       frame in the frequency domain;
    3. **decimate by spectral folding**: decimation in time is aliasing in
       frequency, ``Z[k] = (1/dec) * sum_p Yc[k + p*fft_len]`` — a dense
       reshape-and-sum, never a strided slice and
       never an inverse transform;
    4. subtract the circular-wrap error: it lives only in the first ``K-1``
       samples of each frame and is a linear function of the current and
       previous frame tails — a tiny ``[K-1, fft_len]`` matmul
       (:func:`_fused_rx_matrices`), so causality across frame boundaries
       (and shard boundaries, via ``history``) is exact.

    ``x``: ``[..., n]`` with ``n % span == 0``. ``taps`` must be host-side
    numpy (they are baked into trace constants in f64). ``history``:
    optional ``[..., K-1]`` samples preceding ``x`` (zeros = causal start;
    the sharded chain passes the halo received from the left neighbor).
    Returns ``[..., n // span, fft_len]`` spectra, scaled by ``scale``.
    ``stage_n1`` overrides the two-einsum path's first-stage size (must
    divide ``fft_len``; see :func:`_fused_stage_n1`).

    ``_staged_layout=True`` (two-einsum path only; internal, used by the
    RX chain's sign-demod fast path): returns ``[n1, ..., nsym, r]`` with
    the ``k1`` stage axis LEADING — natural bin ``k = k1 + n1*d`` — and
    the wrap correction applied in that layout. Leading ``k1`` makes it
    the native batch dimension of the second (batched-GEMM) einsum, so
    XLA inserts no hidden transposes, and
    the caller defers natural-order reordering to its (much smaller)
    post-demod tensor.
    """
    x = _as_c64(x)
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    k = taps.shape[-1]
    span = dec * fft_len
    n = x.shape[-1]
    if n % span:
        raise ValueError(f"length {n} not divisible by dec*fft_len = {span}")
    if k - 1 > span:
        raise ValueError(f"taps ({k}) longer than a frame ({span}) + 1")
    batch = x.shape[:-1]
    nsym = n // span
    frames = x.reshape(batch + (nsym, span))

    hs, cm = _fused_rx_matrices(taps.tobytes(), k, dec, fft_len)
    backend = fft_backend or _fft.default_backend()
    # HIGHEST (full f32) keeps the fused path near -133 dB RMS vs f64;
    # callers with relaxed accuracy needs may pass Precision.HIGH
    prec = jax.lax.Precision.HIGHEST if precision is None else precision
    n1 = _fused_stage_n1(dec, fft_len, stage_n1) if backend == "matmul" else None
    if n1 is not None:
        # two-einsum matmul path: stage-1 DFT, then the combined
        # (twiddle * H * DFT_{n2} * spectral-fold) tensor — the folded
        # span-point spectrum is never materialized (see
        # :func:`_fused_stage_matrices`)
        n2 = span // n1
        f1, gp = _fused_stage_matrices(taps.tobytes(), k, dec, fft_len, n1)
        xv = frames.reshape(batch + (nsym, n1, n2))
        if _staged_layout:
            # k1 leads: it is then the native batch dim of the second
            # batched GEMM — no hidden XLA transposes between the einsums
            a = jnp.einsum(
                "...nm,nk->k...m", xv, jnp.asarray(f1), precision=prec
            )
            z = jnp.einsum(
                "k...m,kmd->k...d", a, jnp.asarray(gp), precision=prec
            )  # [k1, ..., nsym, d]
        else:
            a = jnp.einsum(
                "...nm,nk->...km", xv, jnp.asarray(f1), precision=prec
            )
            zk = jnp.einsum(
                "...km,kmd->...kd", a, jnp.asarray(gp), precision=prec
            )
            # output index j = k1 + n1*d -> natural order is (d, k1)
            z = jnp.swapaxes(zk, -1, -2).reshape(batch + (nsym, fft_len))
    else:
        if _staged_layout:
            raise ValueError(
                "_staged_layout requires the two-einsum matmul path"
            )
        plan = _fft.plan(span, fft_backend)
        spec = plan.fwd(frames, Scale.NONE) * jnp.asarray(hs)
        # spectral fold = decimation in time (dense reshape + sum, no strides)
        z = spec.reshape(batch + (nsym, dec, fft_len)).sum(axis=-2)
        z = z * jnp.float32(1.0 / dec)

    if k > 1:
        tails = frames[..., :, span - (k - 1):]
        if history is None:
            h0 = jnp.zeros(batch + (1, k - 1), dtype=cf32)
        else:
            h0 = _as_c64(history)
            if h0.shape[-1] != k - 1:
                raise ValueError(f"history must have K-1 = {k - 1} samples")
            h0 = jnp.broadcast_to(h0, batch + (k - 1,))[..., None, :]
        prev = jnp.concatenate([h0, tails[..., :-1, :]], axis=-2)
        delta = tails - prev
        if _staged_layout:
            # correction in the k1-leading stage layout: natural bin index
            # k = k1 + n1*d, so Cm's bin axis reshapes to [d, k1]
            r = fft_len // n1
            cm_kd = np.ascontiguousarray(
                cm.reshape(k - 1, r, n1).transpose(0, 2, 1)
            )
            ecorr = jnp.einsum(
                "...nu,ukd->k...nd", delta, jnp.asarray(cm_kd),
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            ecorr = jnp.einsum(
                "...nu,uk->...nk", delta, jnp.asarray(cm),
                precision=jax.lax.Precision.HIGHEST,
            )
        z = z - ecorr
    return scale.apply(z)


def fir_decimate_fft_planes(
    xr,
    xi,
    taps: np.ndarray,
    dec: int,
    fft_len: int,
    history=None,
    fft_backend: Optional[str] = None,
    precision=None,
):
    """Split-plane variant of the k1-leading staged path
    (:func:`fir_decimate_fft` with ``_staged_layout=True``): takes f32
    re/im planes, runs the two stage contractions as explicit REAL einsums
    (4 per stage), and returns ``(zr, zi)`` planes in the ``[n1, ...,
    nsym, r]`` layout, unscaled, wrap-corrected.

    It deletes the complex64 merge/extract passes around the hot loop,
    at the price of four separate real einsums that each re-read their
    operands (a complex GEMM shares each operand load across the four
    real products). Kept as an API for plane-native pipelines; the RX
    chain uses the complex path.
    """
    xr = jnp.asarray(xr, jnp.float32)
    xi = jnp.asarray(xi, jnp.float32)
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    k = taps.shape[-1]
    span = dec * fft_len
    n = xr.shape[-1]
    if n % span:
        raise ValueError(f"length {n} not divisible by dec*fft_len = {span}")
    if k - 1 > span:
        raise ValueError(f"taps ({k}) longer than a frame ({span}) + 1")
    backend = fft_backend or _fft.default_backend()
    n1 = _fused_stage_n1(dec, fft_len) if backend == "matmul" else None
    if n1 is None:
        raise ValueError("plane path requires the two-einsum matmul backend")
    prec = jax.lax.Precision.HIGHEST if precision is None else precision
    batch = xr.shape[:-1]
    nsym = n // span
    n2 = span // n1
    r = fft_len // n1
    f1, gp = _fused_stage_matrices(taps.tobytes(), k, dec, fft_len, n1)
    f1r, f1i = np.ascontiguousarray(f1.real), np.ascontiguousarray(f1.imag)
    gpr, gpi = np.ascontiguousarray(gp.real), np.ascontiguousarray(gp.imag)

    fr = xr.reshape(batch + (nsym, span))
    fi = xi.reshape(batch + (nsym, span))
    xvr = fr.reshape(batch + (nsym, n1, n2))
    xvi = fi.reshape(batch + (nsym, n1, n2))

    def e1(x, m):
        return jnp.einsum("...nm,nk->k...m", x, jnp.asarray(m), precision=prec)

    def e2(x, m):
        return jnp.einsum("k...m,kmd->k...d", x, jnp.asarray(m), precision=prec)

    ar = e1(xvr, f1r) - e1(xvi, f1i)
    ai = e1(xvr, f1i) + e1(xvi, f1r)
    zr = e2(ar, gpr) - e2(ai, gpi)
    zi = e2(ar, gpi) + e2(ai, gpr)

    if k > 1:
        _, cm = _fused_rx_matrices(taps.tobytes(), k, dec, fft_len)
        cm_kd = np.ascontiguousarray(cm.reshape(k - 1, r, n1).transpose(0, 2, 1))
        cmr, cmi = np.ascontiguousarray(cm_kd.real), np.ascontiguousarray(cm_kd.imag)
        tr = fr[..., :, span - (k - 1):]
        ti = fi[..., :, span - (k - 1):]
        if history is None:
            h0r = jnp.zeros(batch + (1, k - 1), jnp.float32)
            h0i = h0r
        else:
            hr, hi = history
            hr = jnp.asarray(hr, jnp.float32)
            hi = jnp.asarray(hi, jnp.float32)
            if hr.shape[-1] != k - 1:
                raise ValueError(f"history must have K-1 = {k - 1} samples")
            h0r = jnp.broadcast_to(hr, batch + (k - 1,))[..., None, :]
            h0i = jnp.broadcast_to(hi, batch + (k - 1,))[..., None, :]
        dr = tr - jnp.concatenate([h0r, tr[..., :-1, :]], axis=-2)
        di = ti - jnp.concatenate([h0i, ti[..., :-1, :]], axis=-2)

        def ec(x, m):
            return jnp.einsum(
                "...nu,ukd->k...nd", x, jnp.asarray(m),
                precision=jax.lax.Precision.HIGHEST,
            )

        zr = zr - (ec(dr, cmr) - ec(di, cmi))
        zi = zi - (ec(dr, cmi) + ec(di, cmr))
    return zr, zi


@functools.lru_cache(maxsize=None)
def _fused_tx_matrices(
    taps_bytes: bytes, k: int, dec: int, fft_len: int, scale_f: float
):
    """Precomputed (f64) constants for :func:`interp_fir_ifft` — the TX dual
    of :func:`_fused_rx_matrices`.

    With ``span = dec * fft_len``, zero-stuffing by ``dec`` replicates the
    ``fft_len``-point spectrum across the span (``Up[f] = X[f mod N]``), so
    per frame the circular (upsample ∘ FIR) output is

        y[dec*u + t] = (s/dec) * iFFT_N( spec ⊙ R[t] )[u]
        R[t, b] = e^{2πi t b / span} * sum_p Hs[b + N p] e^{2πi t p / dec}

    — ``dec`` diagonal multiplies + one batched N-point backward FFT, the
    span-point transform never happens. Returns ``(R [dec, N]`` (with the
    ``s/dec`` factor folded in), ``Mtail [N, ntail]`` (maps a frame's
    spectrum to its last ``ntail = ceil((K-1)/dec)`` time samples),
    ``T2 [K-1, ntail]`` (maps tail deltas to the circular-wrap error on the
    first ``K-1`` outputs)) complex64.
    """
    h = np.frombuffer(taps_bytes, dtype=np.complex64).astype(np.complex128)
    span = dec * fft_len
    n = fft_len
    hs = np.fft.fft(h, span)  # [span]
    b = np.arange(n, dtype=np.float64)
    t = np.arange(dec, dtype=np.float64)
    p = np.arange(dec, dtype=np.float64)
    # Q[t, b] = sum_p Hs[b + N p] e^{2πi t p / dec}
    hs_rep = hs.reshape(dec, n)  # [p, b]
    phase_tp = np.exp(2j * np.pi * np.outer(t, p) / dec)  # [t, p]
    q = phase_tp @ hs_rep  # [t, b]
    r = q * np.exp(2j * np.pi * np.outer(t, b) / span)
    r *= scale_f / dec

    ntail = -(-(k - 1) // dec) if k > 1 else 0
    if ntail:
        idx = n - ntail + np.arange(ntail, dtype=np.float64)
        mtail = scale_f * np.exp(2j * np.pi * np.outer(b, idx) / n)  # [b, i]
        t2 = np.zeros((k - 1, ntail), np.complex128)
        for m in range(k - 1):
            for i in range(ntail):
                kk = span + m - dec * (n - ntail + i)
                if m + 1 <= kk <= k - 1:
                    t2[m, i] = h[kk]
    else:
        mtail = np.zeros((n, 0), np.complex128)
        t2 = np.zeros((0, 0), np.complex128)
    return (
        r.astype(np.complex64),
        mtail.astype(np.complex64),
        t2.astype(np.complex64),
    )


def interp_fir_ifft(
    spec,
    taps: np.ndarray,
    dec: int,
    scale: Scale = Scale.NONE,
    history_spec=None,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """Fused TX frame op: spectrum frames -> (scaled backward FFT ->
    zero-stuff by ``dec`` -> causal FIR) -> full-rate samples, without ever
    materializing the zero-stuffed stream or running a span-point
    transform. Equivalent (to rounding) to::

        x = ifft(spec, scale)                       # per frame, length N
        up = zero_stuff(x, dec)                     # length span = dec*N
        y = fir_filter(up.reshape(-1), taps)        # causal, continuous

    The dual of :func:`fir_decimate_fft`: replication-in-frequency replaces
    the spectral fold, the tap spectrum rides ``dec`` precomputed diagonals
    (:func:`_fused_tx_matrices`), and causality across frame (and shard)
    boundaries is restored by the same tails-to-wrap-error correction —
    here the tails are the frame's last few *time* samples, obtained from
    the spectrum by a tiny ``[N, ntail]`` matmul.

    ``spec``: ``[..., nsym, N]`` frames. ``history_spec``: optional
    ``[..., N]`` spectrum of the frame *preceding* ``spec`` (zeros =
    causal start). Returns ``[..., nsym * dec * N]``.
    """
    spec = _as_c64(spec)
    taps = np.asarray(taps, dtype=np.complex64).ravel()
    k = taps.shape[-1]
    n = spec.shape[-1]
    nsym = spec.shape[-2]
    span = dec * n
    if k - 1 > span:
        raise ValueError(f"taps ({k}) longer than a frame ({span}) + 1")
    batch = spec.shape[:-2]
    s = scale.factor_for(n)
    r, mtail, t2 = _fused_tx_matrices(taps.tobytes(), k, dec, n, float(s))

    v = spec[..., None, :] * jnp.asarray(r)  # [.., nsym, dec, N]
    y_tu = _fft.plan(n, fft_backend).bwd(v, Scale.NONE)  # [.., nsym, t, u]
    # interleave j = dec*u + t: order (u, t)
    y = jnp.swapaxes(y_tu, -1, -2).reshape(batch + (nsym, span))

    if k > 1:
        tails = jnp.matmul(
            spec, jnp.asarray(mtail), precision=jax.lax.Precision.HIGHEST
        )  # [.., nsym, ntail]
        if history_spec is None:
            h0 = jnp.zeros(batch + (1, tails.shape[-1]), dtype=cf32)
        else:
            hs0 = _as_c64(history_spec)
            if hs0.shape[-1] != n:
                raise ValueError(f"history_spec must have N = {n} bins")
            h0 = jnp.matmul(
                jnp.broadcast_to(hs0, batch + (n,))[..., None, :],
                jnp.asarray(mtail),
                precision=jax.lax.Precision.HIGHEST,
            )
        prev = jnp.concatenate([h0, tails[..., :-1, :]], axis=-2)
        e = jnp.einsum(
            "...ni,mi->...nm", tails - prev, jnp.asarray(t2),
            precision=jax.lax.Precision.HIGHEST,
        )  # [.., nsym, K-1]
        head = y[..., : k - 1] - e
        y = jnp.concatenate([head, y[..., k - 1 :]], axis=-1)
    return y.reshape(batch + (nsym * span,))


def matched_filter(
    x,
    ref,
    block_len: Optional[int] = None,
    fft_backend: Optional[str] = None,
    history=None,
) -> jnp.ndarray:
    """Linear (sliding) correlation against ``ref`` via overlap-save.

    ``y[n] = sum_m x[n - m] conj(ref[M-1 - m])`` — i.e. an FIR whose taps
    are the conjugated, time-reversed reference, run through
    :func:`fir_filter_os`. ``|y|`` peaks at index ``n = offset + M - 1``
    when ``ref`` appears at ``offset`` (the causal end-of-pattern
    convention). Unlike :func:`correlate` this is linear, streams over
    blocks, and shards with a ``M-1`` halo — the production correlator for
    long captures.
    """
    if isinstance(ref, (np.ndarray, list, tuple)):
        # host references stay numpy so the taps embed as trace constants
        taps = np.conj(np.asarray(ref, dtype=np.complex64))[..., ::-1]
    else:
        taps = jnp.conj(jnp.asarray(ref, dtype=cf32))[..., ::-1]
    return fir_filter_os(
        x, taps, block_len=block_len, fft_backend=fft_backend, history=history
    )


def correlate(x, ref, fft_backend: Optional[str] = None) -> jnp.ndarray:
    """Circular correlation via the spectrum: ``ifft(fft(x) * conj(fft(ref)))``.

    ``ref`` shorter than ``x`` is zero-padded (as the reference bench pads
    its 4-sample signature, benches/benches.rs:395-400). Output peaks mark
    alignments of ``ref`` within ``x`` (peak value = energy of ref at lag 0).
    The backward transform uses ``Scale.N`` so the result is the true
    circular correlation ``sum_m x[m] conj(ref[m - n])`` (the reference
    bench ran unscaled, leaving a factor of N — we return the meaningful
    quantity; pass the spectra through :mod:`fft` manually for raw parity).
    """
    x = _as_c64(x)
    ref = _as_c64(ref)
    n = x.shape[-1]
    if ref.shape[-1] < n:
        ref = jnp.pad(ref, [(0, 0)] * (ref.ndim - 1) + [(0, n - ref.shape[-1])])
    elif ref.shape[-1] > n:
        raise ValueError("Reference longer than signal")
    b = fft_backend or _fft.default_backend()
    if b == "matmul":
        # chained composition: prefer the factored stage over a dense
        # table entry — the factored FFT fuses with the spectrum multiply
        # where the dense [n, n] matmul is a fusion barrier
        # (ops/fft.py:chained_factor)
        return _correlate_mm(n, _fft.chained_factor(n))(x, ref)
    plan = _fft.plan(n, fft_backend)
    spec = plan.fwd(x, Scale.NONE) * jnp.conj(plan.fwd(ref, Scale.NONE))
    return plan.bwd(spec, Scale.N)


@functools.lru_cache(maxsize=None)
def _correlate_mm(n: int, first_factor):
    """Cached jitted matmul-FFT correlator core (one dispatch per call,
    not one per op)."""

    @jax.jit
    def f(x, ref):
        spec = _fft.mm_fft(x, -1, first_factor=first_factor) * jnp.conj(
            _fft.mm_fft(ref, -1, first_factor=first_factor)
        )
        out = _fft.mm_fft(spec, +1, first_factor=first_factor)
        return out * jnp.float32(1.0 / n)

    return f
