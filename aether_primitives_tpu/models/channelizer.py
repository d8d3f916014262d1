"""Streaming waterfall channelizer and polyphase filterbank (PFB).

The compute core of the reference's ``plot::waterfall`` (reference
src/util/plot.rs:36-99): pad a long capture to a multiple of ``fft_len``,
transform each chunk (``Scale::SN``), fftshift (``vec_mirror``), take
per-bin magnitude (optionally dB). Here the per-chunk loop becomes one
batched FFT over a ``[rows, fft_len]`` block — embarrassingly parallel
across rows and the ideal first multi-chip workload (rows shard over the
mesh with no halo at all).

:func:`pfb_channelize` is the production generalization: the reference's
chunked FFT is a rectangular-window filterbank whose channel response is
a sinc with −13 dB sidelobes (adjacent-channel leakage); a critically
sampled polyphase filterbank replaces the implicit rectangle with a
``P·n_chan``-tap prototype lowpass folded across ``P`` frames, giving
each channel a real filter skirt at the cost of ``P`` fused multiply-adds
per sample before the same batched FFT. Shape: frames are a dense
``[T, n_chan]`` reshape (no strided gather), the branch weighting is
``P`` stride-1 slab multiplies down the frame axis, and the DFT across
branches is the batched matmul FFT — causal across frames, so it streams
and shards with a ``(P-1)``-frame left halo exactly like the RX chain.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import vecops as _vecops
from ..ops.fft import Scale, plan as fft_plan
from ..parallel.mesh import CHANNEL_AXIS
from ..types import cf32

P = jax.sharding.PartitionSpec


def _pad_rows(x: jnp.ndarray, fft_len: int) -> jnp.ndarray:
    n = x.shape[-1]
    rem = n % fft_len
    if rem:
        pad = fft_len - rem  # zero-pad like reference src/util/plot.rs:50-57
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return x.reshape(x.shape[:-1] + (x.shape[-1] // fft_len, fft_len))


def _frames_overlapped(x: jnp.ndarray, fft_len: int, hop: int) -> jnp.ndarray:
    """Overlapped analysis frames ``[..., n_frames, fft_len]`` with frame m
    starting at ``m*hop``; the capture is zero-padded so the last frame is
    complete.

    Construction: requires ``fft_len % hop == 0``; the capture
    reshapes into hop-sized slabs and each frame is a concat of ``q =
    fft_len/hop`` consecutive slabs — dense slices only, no strided
    gather.
    """
    if hop == fft_len:
        return _pad_rows(x, fft_len)
    q, rem = divmod(fft_len, hop)
    if rem:
        raise ValueError(f"fft_len {fft_len} must be a multiple of hop {hop}")
    n = x.shape[-1]
    n_frames = max(n - fft_len + hop - 1, 0) // hop + 1
    padded_len = (n_frames - 1) * hop + fft_len
    if padded_len > n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, padded_len - n)])
    slabs = x.reshape(x.shape[:-1] + (padded_len // hop, hop))
    pieces = [slabs[..., i : i + n_frames, :] for i in range(q)]
    return jnp.concatenate(pieces, axis=-1)


def _resolve_window(window, fft_len: int):
    if window is None:
        return None
    if isinstance(window, str):
        if window == "hann":
            w = np.hanning(fft_len)
        elif window == "hamming":
            w = np.hamming(fft_len)
        elif window == "blackman":
            w = np.blackman(fft_len)
        else:
            raise ValueError(f"unknown window {window!r}")
        return w.astype(np.float32)
    w = np.asarray(window, dtype=np.float32)
    if w.shape[-1] != fft_len:
        raise ValueError("window length must equal fft_len")
    return w


def waterfall_spectra(
    samples,
    fft_len: int,
    use_db: bool = False,
    fft_backend: Optional[str] = None,
    window=None,
    hop: Optional[int] = None,
) -> jnp.ndarray:
    """``[rows, fft_len]`` magnitude (or dB) waterfall of a capture.

    Per row: forward FFT with ``Scale.SN``, fftshift, ``|.|`` — exactly the
    reference's per-chunk ``vec_rfft(SN).vec_mirror()`` + norm
    (src/util/plot.rs:59-68). dB conversion is ``10*log10(mag)`` matching
    ``DB::from`` applied to the amplitude (reference behavior, not a power
    dB — see src/util/plot.rs:65-68).

    Beyond the reference: optional analysis ``window`` ("hann"/"hamming"/
    "blackman" or an explicit ``[fft_len]`` array) and overlapped frames via
    ``hop < fft_len`` (must divide ``fft_len``) — the windowed-overlap
    streaming channelizer configuration.
    """
    x = jnp.asarray(samples, dtype=cf32)
    rows = _frames_overlapped(x, fft_len, hop or fft_len)
    w = _resolve_window(window, fft_len)
    if w is not None:
        rows = rows * jnp.asarray(w)
    spec = fft_plan(fft_len, fft_backend).fwd(rows, Scale.SN)
    spec = _vecops.mirror(spec)
    mag = jnp.abs(spec)
    if use_db:
        mag = 10.0 * jnp.log10(mag)
    return mag


def welch_psd(
    samples,
    fft_len: int,
    hop: Optional[int] = None,
    window="hann",
    fs: float = 1.0,
    fft_backend: Optional[str] = None,
    shift: bool = False,
):
    """Welch power-spectral-density estimate: windowed overlapped frames,
    per-frame periodogram, averaged — the statistical companion to
    :func:`waterfall_spectra` (same framing: dense slab concat, one
    batched FFT, one mean; no gathers).

    Conventions match ``scipy.signal.welch(..., detrend=False,
    return_onesided=False, scaling="density")``: density scaling
    ``Pxx[k] = E[|FFT(w*frame)[k]|^2] / (fs * sum(w^2))`` with frames every
    ``hop`` samples (default ``fft_len // 2``, scipy's 50% overlap;
    ``fft_len % hop == 0`` required). Only complete frames enter the
    average (trailing remainder dropped, like scipy). Returns
    ``(freqs f64 numpy, psd f32 jnp [..., fft_len])``, bins in FFT order —
    pass ``shift=True`` for monotonic frequencies (fftshift applied to
    both). Batched over leading axes.
    """
    x = jnp.asarray(samples, dtype=cf32)
    hop = int(hop) if hop is not None else fft_len // 2
    n = x.shape[-1]
    if n < fft_len:
        raise ValueError(f"capture shorter than one frame ({n} < {fft_len})")
    # complete frames only: trim so the zero-padded tail frame never forms
    n_frames = (n - fft_len) // hop + 1
    x = x[..., : (n_frames - 1) * hop + fft_len]
    rows = _frames_overlapped(x, fft_len, hop)
    if isinstance(window, str):
        # periodic (DFT-even) windows for spectral estimation — the scipy
        # convention; the symmetric np.* forms are for filter design
        w = _resolve_window(window, fft_len + 1)[:-1].copy()
    else:
        w = _resolve_window(window, fft_len)
    if w is None:
        w = np.ones(fft_len, np.float32)
    spec = fft_plan(fft_len, fft_backend).fwd(rows * jnp.asarray(w), Scale.NONE)
    p = jnp.mean(jnp.real(spec) ** 2 + jnp.imag(spec) ** 2, axis=-2)
    scale = 1.0 / (float(fs) * float(np.sum(w.astype(np.float64) ** 2)))
    psd = (p * jnp.float32(scale)).astype(jnp.float32)
    freqs = np.fft.fftfreq(fft_len, d=1.0 / fs)
    if shift:
        freqs = np.fft.fftshift(freqs)
        psd = jnp.fft.fftshift(psd, axes=-1)
    return freqs, psd


class Channelizer:
    """Streaming waterfall channelizer stage (pipeline-ready).

    Wraps :func:`waterfall_spectra` with fixed configuration so it drops
    straight into :class:`aether_primitives_tpu.parallel.streaming.Pipeline`
    as a jitted stage; carries no state (frames never straddle block
    boundaries when ``block % fft_len == 0`` and ``hop == fft_len``; for
    overlapped streaming feed blocks with ``fft_len - hop`` samples of
    overlap from the previous block).
    """

    def __init__(
        self,
        fft_len: int,
        use_db: bool = False,
        window=None,
        hop: Optional[int] = None,
        fft_backend: Optional[str] = None,
    ):
        self.fft_len = int(fft_len)
        self.use_db = use_db
        self.window = window
        self.hop = hop
        self.fft_backend = fft_backend

    def step(self, block) -> jnp.ndarray:
        return waterfall_spectra(
            block,
            self.fft_len,
            use_db=self.use_db,
            fft_backend=self.fft_backend,
            window=self.window,
            hop=self.hop,
        )

    __call__ = step


def pfb_prototype(n_chan: int, taps_per_branch: int = 8) -> np.ndarray:
    """Hamming-windowed-sinc prototype lowpass for a critically sampled
    ``n_chan``-channel PFB: ``P * n_chan`` real taps, cutoff at half the
    channel spacing (``1/(2*n_chan)`` cycles/sample), unit DC gain.

    ``taps_per_branch`` (``P``) trades skirt steepness against compute:
    P=1 degenerates to the rectangular window (== plain chunked FFT).
    """
    if taps_per_branch < 1:
        raise ValueError("taps_per_branch must be >= 1")
    ntaps = taps_per_branch * n_chan
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    c = 1.0 / (2.0 * n_chan)
    h = 2 * c * np.sinc(2 * c * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def pfb_channelize(
    samples,
    n_chan: int,
    taps: Optional[np.ndarray] = None,
    taps_per_branch: int = 8,
    scale: Scale = Scale.NONE,
    fft_backend: Optional[str] = None,
    history=None,
) -> jnp.ndarray:
    """Critically sampled polyphase analysis filterbank:
    ``[..., n]`` samples -> ``[..., T, n_chan]`` complex channel series,
    one output frame per ``n_chan`` input samples (``T = ceil(n/n_chan)``;
    the capture zero-pads to a whole frame like the reference waterfall,
    src/util/plot.rs:50-57).

    Causal weighted-overlap-add form: with ``M = n_chan``, prototype
    ``h[0..P*M)`` and frames ``F[t, r] = x[t*M + r]``,

        u[t, r]   = sum_p  h[p*M + r] * F[t - p, r]      (zeros for t < p)
        y[t, c]   = sum_r  u[t, r] * e^{-2 pi i c r / M}  (forward DFT)

    so channel ``c`` of frame ``t`` filters the last ``P`` frames through
    the prototype shifted to bin ``c``. ``P = 1`` with unit taps is
    bit-identical to the plain chunked FFT (:func:`waterfall_spectra`'s
    core). ``taps``: optional explicit prototype (length ``<= P*M``,
    zero-padded); default :func:`pfb_prototype`. ``history``: optional
    ``[..., (P-1)*M]`` samples preceding the capture (the sharded path
    passes the left-neighbor halo; zeros = cold start).

    Layout: frames are a dense reshape, the ``p``-shifts are stride-1
    slices of a ``[T+P-1, M]`` extended frame stack (no strided gather,
    no ``lax.conv``), and the branch DFT is one batched FFT over ``M``.
    """
    x = jnp.asarray(samples, dtype=cf32)
    m = int(n_chan)
    if taps is None:
        taps = pfb_prototype(m, taps_per_branch)
    h = np.asarray(taps, dtype=np.complex64).ravel()
    p = max(1, -(-h.shape[-1] // m))
    if h.shape[-1] < p * m:
        h = np.pad(h, (0, p * m - h.shape[-1]))
    hb = h.reshape(p, m)  # branch view: hb[p_idx, r]

    fr = _pad_rows(x, m)  # [..., T, M]
    t_frames = fr.shape[-2]
    batch = fr.shape[:-2]
    if p > 1:
        if history is None:
            h0 = jnp.zeros(batch + (p - 1, m), dtype=cf32)
        else:
            h0 = jnp.asarray(history, dtype=cf32)
            if h0.shape[-1] != (p - 1) * m:
                raise ValueError(
                    f"history must have (P-1)*n_chan = {(p - 1) * m} samples"
                )
            h0 = jnp.broadcast_to(h0, batch + ((p - 1) * m,)).reshape(
                batch + (p - 1, m)
            )
        ext = jnp.concatenate([h0, fr], axis=-2)  # [..., T+P-1, M]
    else:
        ext = fr
    u = None
    for pi in range(p):
        # frame t - pi lives at extended row (P-1-pi) + t
        start = p - 1 - pi
        slab = jax.lax.slice_in_dim(ext, start, start + t_frames, axis=-2)
        term = slab * jnp.asarray(hb[pi])
        u = term if u is None else u + term
    return fft_plan(m, fft_backend).fwd(u, scale)


def pfb_spectra(
    samples,
    n_chan: int,
    use_db: bool = False,
    taps: Optional[np.ndarray] = None,
    taps_per_branch: int = 8,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """PFB waterfall: like :func:`waterfall_spectra` (``Scale.SN``,
    fftshift, magnitude / amplitude-dB) but with the polyphase prototype
    suppressing adjacent-channel leakage instead of the rectangle's
    −13 dB sinc sidelobes."""
    spec = pfb_channelize(
        samples, n_chan, taps=taps, taps_per_branch=taps_per_branch,
        scale=Scale.SN, fft_backend=fft_backend,
    )
    spec = _vecops.mirror(spec)
    mag = jnp.abs(spec)
    if use_db:
        mag = 10.0 * jnp.log10(mag)
    return mag


class PfbChannelizer:
    """Streaming PFB stage (pipeline-ready): carries the prototype and the
    ``(P-1)*n_chan``-sample tail state between blocks so a long capture fed
    block-by-block produces exactly the single-shot output."""

    def __init__(
        self,
        n_chan: int,
        taps: Optional[np.ndarray] = None,
        taps_per_branch: int = 8,
        scale: Scale = Scale.NONE,
        fft_backend: Optional[str] = None,
    ):
        self.n_chan = int(n_chan)
        self.taps = (
            np.asarray(taps, np.complex64).ravel()
            if taps is not None
            else pfb_prototype(self.n_chan, taps_per_branch).astype(np.complex64)
        )
        self.p = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.fft_backend = fft_backend
        self._tail = None

    def step(self, block) -> jnp.ndarray:
        """One block (length divisible by ``n_chan``) -> channel frames;
        stateful across calls (reset by constructing a new instance)."""
        x = jnp.asarray(block, dtype=cf32)
        if x.shape[-1] % self.n_chan:
            raise ValueError("block length must be divisible by n_chan")
        out = pfb_channelize(
            x, self.n_chan, taps=self.taps, scale=self.scale,
            fft_backend=self.fft_backend, history=self._tail,
        )
        keep = (self.p - 1) * self.n_chan
        if keep:
            self._tail = x[..., -keep:]
        return out

    __call__ = step


def sharded_pfb(
    samples,
    n_chan: int,
    mesh: jax.sharding.Mesh,
    taps: Optional[np.ndarray] = None,
    taps_per_branch: int = 8,
    scale: Scale = Scale.NONE,
    axis_name: str = "time",
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """PFB with contiguous time spans sharded across the mesh: each shard
    pulls its ``(P-1)*n_chan``-sample left halo from its neighbor
    (:func:`~aether_primitives_tpu.parallel.halo.left_tail`), so the output
    equals the single-device :func:`pfb_channelize` bit-for-bit. Each
    device span must be divisible by ``n_chan``."""
    from ..parallel.halo import left_tail

    x = jnp.asarray(samples, dtype=cf32)
    m = int(n_chan)
    if taps is None:
        taps = pfb_prototype(m, taps_per_branch)
    h = np.asarray(taps, dtype=np.complex64).ravel()
    p = max(1, -(-h.shape[-1] // m))

    def shard_fn(xl):
        halo = left_tail(xl, (p - 1) * m, axis_name) if p > 1 else None
        return pfb_channelize(
            xl, m, taps=h, scale=scale, fft_backend=fft_backend, history=halo
        )

    nd = jnp.ndim(x)
    spec_in = P(*([None] * (nd - 1) + [axis_name]))
    spec_out = P(*([None] * (nd - 1) + [axis_name, None]))
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in, out_specs=spec_out)
    return fn(x)


def pfb_synthesis_taps(
    analysis_taps,
    n_chan: int,
    taps_per_branch: Optional[int] = None,
) -> np.ndarray:
    """Least-squares near-perfect-reconstruction synthesis prototype for
    :func:`pfb_synthesize`, given the analysis prototype.

    Per polyphase branch ``r`` the analysis/synthesis cascade is the frame-
    domain FIR convolution ``h_r ⊛ g_r`` (``h_r[p] = h[p*M + r]``); perfect
    reconstruction requires it to be a pure ``d``-frame delay for every
    branch. Each ``g_r`` is the length-``Q`` least-squares FIR inverse of
    ``h_r`` targeting the common delay ``d = (P + Q - 2) // 2`` (a delay
    scan confirms the midpoint is optimal) — solved in f64 at design time
    (``M`` independent ``[P+Q-1, Q]`` lstsq problems).

    Returns ``[Q * n_chan]`` taps (branch view ``g[p*M + r]``); the
    round-trip ``pfb_synthesize(pfb_channelize(x, h), g)`` reproduces ``x``
    delayed by ``d`` frames. Exactness is structurally bounded: a
    critically sampled DFT bank has exact FIR PR only for trivial (pure
    delay+gain) polyphase branches, and the default prototype's branches
    carry zeros near the unit circle (worst |z| ≈ 1.16), so the LS
    residual decays only geometrically in ``Q``. Default ``Q = 8 P``
    measures ≈ −35 dB RMS reconstruction for the default prototype
    (−25 dB at ``Q = 4 P``); push ``taps_per_branch`` higher for more.
    """
    h = np.asarray(analysis_taps).ravel()
    m = int(n_chan)
    p = max(1, -(-h.shape[-1] // m))
    if h.shape[-1] < p * m:
        h = np.pad(h, (0, p * m - h.shape[-1]))
    hb = h.reshape(p, m).astype(np.complex128)
    q = int(taps_per_branch) if taps_per_branch else 8 * p
    d = (p + q - 2) // 2
    gb = np.zeros((q, m), np.complex128)
    for r in range(m):
        c = np.zeros((p + q - 1, q), np.complex128)
        for i in range(q):
            c[i : i + p, i] = hb[:, r]
        e = np.zeros(p + q - 1, np.complex128)
        e[d] = 1.0
        gr, *_ = np.linalg.lstsq(c, e, rcond=None)
        gb[:, r] = gr
    g = gb.reshape(-1)
    if np.abs(g.imag).max() < 1e-12 * max(np.abs(g.real).max(), 1e-30):
        return g.real.astype(np.float32)
    return g.astype(np.complex64)


def pfb_synthesize(
    frames,
    n_chan: Optional[int] = None,
    taps: Optional[np.ndarray] = None,
    scale: Scale = Scale.N,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """Critically sampled polyphase synthesis filterbank (the dual of
    :func:`pfb_channelize`): ``[..., T, n_chan]`` channel frames ->
    ``[..., (T + Q - 1) * n_chan]`` samples.

    Weighted overlap-add form: with ``M = n_chan`` and synthesis prototype
    ``g[0..Q*M)`` (branch view ``gb[p, r] = g[p*M + r]``),

        v[t, r]          = backward DFT of y[t, :] at point r
        x[(t+p)*M + r]  += gb[p, r] * v[t, r]        for p in [0, Q)

    The default ``scale=Scale.N`` makes the channel DFT/iDFT pair the exact
    identity, so analysis->synthesis reduces to the per-branch cascade
    ``h_r ⊛ g_r`` (see :func:`pfb_synthesis_taps`). ``Q = 1`` unit taps
    inverts the plain chunked FFT exactly. The trailing ``(Q-1)*M`` samples
    are the partial overlap-add tail — keep them when stitching blocks
    (:class:`PfbSynthesizer` does) or trim for a one-shot call.

    Layout: the channel iDFT is one batched FFT; the overlap-add sums
    ``Q`` stride-1 SLICES of one padded tensor (``vp[q-1-p : +S]``),
    which XLA can fuse into a single output pass.
    """
    y = jnp.asarray(frames, dtype=cf32)
    m = int(n_chan) if n_chan is not None else y.shape[-1]
    if y.shape[-1] != m:
        raise ValueError(f"frames minor dim {y.shape[-1]} != n_chan {m}")
    if taps is None:
        taps = np.ones(m, np.float32)  # rectangle: inverse of chunked FFT
    g = np.asarray(taps, dtype=np.complex64).ravel()
    q = max(1, -(-g.shape[-1] // m))
    if g.shape[-1] < q * m:
        g = np.pad(g, (0, q * m - g.shape[-1]))
    gb = g.reshape(q, m)

    v = fft_plan(m, fft_backend).bwd(y, scale)  # [..., T, M]
    t_frames = v.shape[-2]
    nb = v.ndim
    if q == 1:  # pure per-channel gain — exact, no filtering
        out = v * jnp.asarray(gb[0])
        return out.reshape(out.shape[:-2] + (t_frames * m,))
    s_len = t_frames + q - 1

    vp = jnp.pad(v, [(0, 0)] * (nb - 2) + [(q - 1, q - 1), (0, 0)])
    acc = None
    for pi in range(q):
        sl = jax.lax.slice_in_dim(vp, q - 1 - pi, q - 1 - pi + s_len, axis=-2)
        term = sl * jnp.asarray(gb[pi])
        acc = term if acc is None else acc + term
    return acc.reshape(acc.shape[:-2] + (s_len * m,))


class PfbSynthesizer:
    """Streaming synthesis stage: carries the ``(Q-1)``-frame overlap-add
    tail between blocks so block-by-block synthesis concatenates to exactly
    the single-shot :func:`pfb_synthesize` output (minus the final tail,
    which :meth:`flush` returns)."""

    def __init__(
        self,
        n_chan: int,
        taps: Optional[np.ndarray] = None,
        scale: Scale = Scale.N,
        fft_backend: Optional[str] = None,
    ):
        self.n_chan = int(n_chan)
        if taps is None:
            taps = np.ones(self.n_chan, np.float32)
        self.taps = np.asarray(taps, np.complex64).ravel()
        self.q = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.fft_backend = fft_backend
        self._tail = None  # [..., (Q-1)*M] partial overlap-add carry

    def step(self, frames) -> jnp.ndarray:
        """``[..., T, n_chan]`` frames -> ``[..., T*n_chan]`` samples."""
        full = pfb_synthesize(
            frames, self.n_chan, taps=self.taps, scale=self.scale,
            fft_backend=self.fft_backend,
        )
        keep = (self.q - 1) * self.n_chan
        if not keep:
            return full
        body, tail = full[..., :-keep], full[..., -keep:]
        if body.shape[-1] < keep:
            raise ValueError(
                f"block must carry at least Q-1 = {self.q - 1} frames"
            )
        if self._tail is not None:
            pad = body.shape[-1] - keep
            carry = jnp.pad(
                self._tail, [(0, 0)] * (body.ndim - 1) + [(0, pad)]
            )
            body = body + carry
        self._tail = tail
        return body

    def flush(self) -> Optional[jnp.ndarray]:
        """The final ``(Q-1)*n_chan`` overlap-add tail (None when Q == 1)."""
        t = self._tail
        self._tail = None
        return t

    __call__ = step


def sharded_waterfall(
    samples,
    fft_len: int,
    mesh: jax.sharding.Mesh,
    use_db: bool = False,
    axis_name: str = CHANNEL_AXIS,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """Waterfall with rows sharded across the mesh (no cross-shard data
    dependence — pure scale-out). The capture length must split evenly into
    ``fft_len``-rows across devices."""
    x = jnp.asarray(samples, dtype=cf32)
    rows = _pad_rows(x, fft_len)

    def shard_fn(r):
        spec = fft_plan(fft_len, fft_backend).fwd(r, Scale.SN)
        spec = _vecops.mirror(spec)
        mag = jnp.abs(spec)
        return 10.0 * jnp.log10(mag) if use_db else mag

    nb = rows.ndim
    spec_in = P(*([None] * (nb - 2) + [axis_name, None]))
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in, out_specs=spec_in)
    return fn(rows)


# --------------------------------------------------------------- STFT / iSTFT


def _stft_window(window, fft_len: int) -> np.ndarray:
    """PERIODIC windows (the COLA-correct kind; the symmetric variants in
    :func:`_resolve_window` match the reference's plotting conventions,
    these match reconstruction)."""
    if isinstance(window, str):
        n = np.arange(fft_len, dtype=np.float64)
        if window == "hann":
            w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_len)
        elif window == "sqrt_hann":
            w = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_len))
        elif window == "rect":
            w = np.ones(fft_len)
        else:
            raise ValueError(f"unknown stft window {window!r}")
        return w.astype(np.float32)
    w = np.asarray(window, dtype=np.float32).ravel()
    if w.shape[-1] != fft_len:
        raise ValueError("window length must equal fft_len")
    return w


def stft(
    x,
    fft_len: int,
    hop: Optional[int] = None,
    window="sqrt_hann",
    scale: Scale = Scale.SN,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """Short-time Fourier transform: ``[..., n]`` -> ``[..., T, fft_len]``
    complex spectra of windowed frames starting at ``t*hop`` (default hop
    ``fft_len // 2``; ``fft_len % hop == 0`` — the slab framing of
    :func:`_frames_overlapped`, no strided gathers).

    The oversampled (hop < fft_len) generalization of the waterfall's
    chunked FFT — the spectral-domain processing workhorse: mask/filter
    the frames, then :func:`istft` back. With the default periodic
    ``sqrt_hann`` at 50% overlap the pair reconstructs exactly (WOLA +
    NOLA normalization; tested at -120 dB), and any window/hop satisfying
    the nonzero-overlap-add condition works.
    """
    fft_len = int(fft_len)
    hop = fft_len // 2 if hop is None else int(hop)
    w = _stft_window(window, fft_len)
    xc = jnp.asarray(x, dtype=cf32)
    # boundary zeros (scipy-style): every REAL sample gets the full
    # periodic overlap-add weight, so tapered windows (w[0] = 0) still
    # reconstruct the edges exactly; istft drops the padding again
    lead = fft_len - hop
    xc = jnp.pad(xc, [(0, 0)] * (xc.ndim - 1) + [(lead, lead)])
    frames = _frames_overlapped(xc, fft_len, hop) * jnp.asarray(w)
    return fft_plan(fft_len, fft_backend).fwd(frames, scale)


def istft(
    frames,
    hop: Optional[int] = None,
    window="sqrt_hann",
    scale: Scale = Scale.SN,
    fft_backend: Optional[str] = None,
    length: Optional[int] = None,
) -> jnp.ndarray:
    """Inverse STFT: ``[..., T, fft_len]`` spectra -> ``[..., n]`` samples
    by windowed overlap-add with exact NOLA normalization (the per-sample
    ``sum_t w^2(n - t*hop)`` divisor, so edges reconstruct exactly too).

    ``scale`` must match the analysis call (default ``Scale.SN`` both ways
    makes the FFT pair the identity). ``length`` trims the synthesis
    output (default ``(T-1)*hop + fft_len``, the full span). Overlap-add
    uses the slice-sum form (one padded tensor, ``fft_len/hop`` stride-1
    slices — the same fusion win as :func:`pfb_synthesize`).
    """
    y = jnp.asarray(frames, dtype=cf32)
    fft_len = int(y.shape[-1])
    hop = fft_len // 2 if hop is None else int(hop)
    q, rem = divmod(fft_len, hop)
    if rem:
        raise ValueError(f"fft_len {fft_len} must be a multiple of hop {hop}")
    w = _stft_window(window, fft_len)
    v = fft_plan(fft_len, fft_backend).bwd(y, scale) * jnp.asarray(w)
    t_frames = int(v.shape[-2])
    full = (t_frames - 1) * hop + fft_len
    # NOLA divisor, exact for the actual frame count (host f64, static)
    denom = np.zeros(full, np.float64)
    w2 = (w.astype(np.float64)) ** 2
    for t in range(t_frames):
        denom[t * hop : t * hop + fft_len] += w2
    lead = fft_len - hop  # stft's boundary padding, dropped below
    core = denom[lead : full - lead if lead else full]
    if core.size and core.min() <= 1e-10 * max(denom.max(), 1e-30):
        raise ValueError("window/hop violate NOLA: zero overlap-add weight")
    denom = np.where(denom <= 1e-10 * max(denom.max(), 1e-30), 1.0, denom)
    nb = v.ndim
    # overlap-add: slab view [.., T, q, hop]; out slab s = sum_j vs[s-j, j]
    vs = v.reshape(v.shape[:-1] + (q, hop))
    n_slabs = t_frames + q - 1
    vp = jnp.pad(vs, [(0, 0)] * (nb - 2) + [(q - 1, q - 1), (0, 0), (0, 0)])
    acc = None
    for j in range(q):
        sl = jax.lax.slice_in_dim(vp, q - 1 - j, q - 1 - j + n_slabs, axis=-3)
        term = sl[..., j, :]
        acc = term if acc is None else acc + term
    out = acc.reshape(acc.shape[:-2] + (n_slabs * hop,))
    out = out / jnp.asarray(denom.astype(np.float32))
    out = out[..., lead:]  # drop the analysis boundary padding
    if length is not None:
        out = out[..., : int(length)]
    return out.astype(cf32)


# ------------------------------------------------------- oversampled PFB


def pfb_prototype_nyquist(
    n_chan: int, taps_per_branch: int = 16, beta: float = 0.5
) -> np.ndarray:
    """Root-Nyquist (square-root raised-cosine) prototype for the
    OVERSAMPLED filterbank — the power-complementary kind the matched
    analysis/synthesis cascade needs: ``sum_k |H(f - k/M)|^2`` is flat by
    the Nyquist criterion on ``|H|^2``, so :func:`pfb_synthesize_os` with
    the same prototype reconstructs to the truncation floor.

    Returns the FULL symmetric ``2*taps_per_branch*n_chan + 1`` tap vector
    — ``taps_per_branch`` SYMBOLS EACH SIDE (the :func:`~.fir.rrc_taps`
    convention), i.e. ``2*taps_per_branch + 1`` polyphase branches
    (odd length — do NOT trim it to a branch multiple: dropping the last
    tap of the symmetric filter half-sample-shifts the autocorrelation and
    destroys complementarity, measured -8 dB vs -76 dB roundtrip). The
    filterbank zero-pads to whole branches itself.

    The critically sampled default (:func:`pfb_prototype`, windowed sinc)
    deliberately is NOT power-complementary — it optimizes channel
    isolation instead; with ``os = 1`` reconstruction is structurally
    limited anyway (see :func:`pfb_synthesis_taps`).
    """
    from ..ops.fir import rrc_taps

    return np.asarray(
        rrc_taps(int(n_chan), span=int(taps_per_branch), beta=float(beta))
    ).real.astype(np.float32)


def pfb_channelize_os(
    samples,
    n_chan: int,
    os: int = 2,
    taps: Optional[np.ndarray] = None,
    taps_per_branch: int = 16,
    scale: Scale = Scale.NONE,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """OVERSAMPLED polyphase analysis filterbank: channel frames advance by
    ``hop = n_chan/os`` input samples (``os``-times oversampled channels),
    ``[..., n]`` -> ``[..., T, n_chan]`` with
    ``y[t, k] = sum_m h[m] x[t*hop + m] e^{-2 pi i k (t*hop + m)/M}`` —
    each channel is the input filtered by the prototype shifted to bin
    ``k`` AND downconverted to baseband with an absolute time reference
    (the ``t*hop`` phase), sampled every ``hop`` samples.

    ``os = 1`` is the critically sampled bank in the forward (WOLA)
    convention: it equals :func:`pfb_channelize` with the branch-reversed
    prototype after that function's ``P-1``-frame causal delay (forward
    window = correlation along frames; the causal form convolves — tested
    equivalence). Oversampling
    is what breaks the critically sampled bank's structural reconstruction
    limit (see :func:`pfb_synthesis_taps`): with ``os >= 2`` the matched
    WOLA inverse (:func:`pfb_synthesize_os`) reconstructs to the
    prototype's stopband floor instead of -35 dB.

    Layout: an ``os``-oversampled bank is ``os`` INTERLEAVED
    critically sampled banks — class ``j`` is the plain ``M``-stride WOLA
    fold of ``x[j*hop:]`` (frame ``t = i*os + j`` starts at
    ``i*M + j*hop``), and its absolute-time reference roll is the
    CONSTANT ``j*hop`` (since ``t*hop mod M = j*hop``). Each class folds
    with ``P`` stride-1 slice-multiply-adds on full-``M``-wide ``[T/os,
    M]`` tiles — the exact fold :func:`pfb_channelize` runs — then
    classes interleave by a stack-reshape, never materializing the
    overlapped ``[T, P*M]`` segments.
    """
    x = jnp.asarray(samples, dtype=cf32)
    m = int(n_chan)
    os = int(os)
    if os < 1 or m % os:
        raise ValueError(f"os must divide n_chan ({m} % {os})")
    hop = m // os
    if taps is None:
        taps = pfb_prototype_nyquist(m, taps_per_branch)
    h = np.asarray(taps, dtype=np.complex64).ravel()
    p = max(1, -(-h.shape[-1] // m))
    if h.shape[-1] < p * m:
        h = np.pad(h, (0, p * m - h.shape[-1]))
    hb = h.reshape(p, m)

    n = x.shape[-1]
    t_frames = max(n - p * m + hop - 1, 0) // hop + 1 if n >= p * m else 1
    t_cls = -(-t_frames // os)  # frames per class (classes padded equal)
    need = ((t_cls - 1) * os + (os - 1)) * hop + p * m  # last class frame end
    if need > n:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, need - n)])

    classes = []
    for j in range(os):
        xj = x[..., j * hop : j * hop + (t_cls - 1) * m + p * m]
        fr = xj.reshape(xj.shape[:-1] + (t_cls - 1 + p, m))
        acc = None
        for pi in range(p):
            sl = jax.lax.slice_in_dim(fr, pi, pi + t_cls, axis=-2)
            term = sl * jnp.asarray(hb[pi])
            acc = term if acc is None else acc + term
        a = (j * hop) % m  # constant reference roll for the whole class
        if a:
            acc = jnp.concatenate([acc[..., m - a:], acc[..., : m - a]], axis=-1)
        classes.append(acc)
    u = jnp.stack(classes, axis=-2)  # [..., T/os, os, M]
    u = u.reshape(u.shape[:-3] + (t_cls * os, m))[..., :t_frames, :]
    return fft_plan(m, fft_backend).fwd(u, scale)


def pfb_synthesize_os(
    frames,
    n_chan: Optional[int] = None,
    os: int = 2,
    taps: Optional[np.ndarray] = None,
    taps_per_branch: int = 16,
    scale: Scale = Scale.N,
    fft_backend: Optional[str] = None,
    length: Optional[int] = None,
    normalize: bool = True,
) -> jnp.ndarray:
    """Matched-WOLA inverse of :func:`pfb_channelize_os`:
    ``[..., T, n_chan]`` oversampled channel frames -> samples.

    Synthesis prototype = the analysis prototype (matched filterbank),
    spread back at hop ``n_chan/os`` with exact per-sample normalization
    by the overlap-add of ``h*g`` (computed for the actual frame count, so
    edges reconstruct too). Reconstruction error is the ALIAS residual of
    the oversampled cascade — set by the prototype's stopband, not by the
    critically-sampled bank's structural limit: the default prototype at
    ``os = 2`` measures about -58 dB RMS (test), vs -35 dB for the best
    critically-sampled LS inverse at Q = 8P.

    ``scale`` must pair with the analysis call (defaults pair:
    ``Scale.NONE`` forward, ``Scale.N`` backward). ``length`` trims the
    output (default the full ``(T-1)*hop + len(h)`` span).
    """
    y = jnp.asarray(frames, dtype=cf32)
    m = int(n_chan) if n_chan is not None else int(y.shape[-1])
    if y.shape[-1] != m:
        raise ValueError(f"frames minor dim {y.shape[-1]} != n_chan {m}")
    os = int(os)
    if os < 1 or m % os:
        raise ValueError(f"os must divide n_chan ({m} % {os})")
    hop = m // os
    if taps is None:
        taps = pfb_prototype_nyquist(m, taps_per_branch)
    h = np.asarray(taps, dtype=np.complex64).ravel()
    p = max(1, -(-h.shape[-1] // m))
    if h.shape[-1] < p * m:
        h = np.pad(h, (0, p * m - h.shape[-1]))

    t_frames = int(y.shape[-2])
    t_cls = -(-t_frames // os)
    nb = y.ndim
    w = fft_plan(m, fft_backend).bwd(y, scale)  # [..., T, M]
    pad_t = t_cls * os - t_frames
    if pad_t:
        w = jnp.pad(w, [(0, 0)] * (nb - 2) + [(0, pad_t), (0, 0)])
    # the dual of the interleaved-class analysis: class j (frames t =
    # i*os + j) spreads as a plain critically sampled WOLA stream —
    # P slice-mul-adds on full-M-wide tiles — then lands at the constant
    # hop offset j*hop in the combined output
    wg = w.reshape(w.shape[:-2] + (t_cls, os, m))
    hb = h.reshape(p, m)
    m_slabs = t_cls + p - 1  # M-slabs per class stream
    n_slabs = m_slabs * os + (os - 1)  # hop-slabs of the combined output

    acc = None
    for j in range(os):
        wj = wg[..., j, :]  # [..., t_cls, M]
        a = (j * hop) % m  # undo the class's constant reference roll
        if a:
            wj = jnp.concatenate([wj[..., a:], wj[..., :a]], axis=-1)
        wp = jnp.pad(wj, [(0, 0)] * (nb - 2) + [(p - 1, p - 1), (0, 0)])
        oj = None
        for pi in range(p):
            sl = jax.lax.slice_in_dim(
                wp, p - 1 - pi, p - 1 - pi + m_slabs, axis=-2
            )
            term = sl * jnp.asarray(hb[pi])
            oj = term if oj is None else oj + term
        oh = oj.reshape(oj.shape[:-2] + (m_slabs * os, hop))
        oh = jnp.pad(
            oh,
            [(0, 0)] * (nb - 2) + [(j, n_slabs - m_slabs * os - j), (0, 0)],
        )
        acc = oh if acc is None else acc + oh
    out = acc.reshape(acc.shape[:-2] + (n_slabs * hop,))
    if normalize:
        # exact normalization: overlap-add of h*g (= h^2, matched) tiles
        full = n_slabs * hop
        denom = np.zeros(full, np.float64)
        hg = np.abs(h.astype(np.complex128)) ** 2
        for t in range(t_frames):
            denom[t * hop : t * hop + p * m] += hg.real
        denom = np.where(denom <= 1e-10 * max(denom.max(), 1e-30), 1.0, denom)
        out = out / jnp.asarray(denom.astype(np.float32))
    # ``normalize=False`` returns the raw weighted overlap-add (the
    # streaming stage overlap-adds block tails first, then divides by the
    # PERIODIC interior divisor)
    if length is not None:
        out = out[..., : int(length)]
    return out.astype(cf32)


class PfbChannelizerOs:
    """Streaming oversampled-PFB analysis stage: carries the
    ``P*M - hop`` sample tail between blocks and emits only frames whose
    full window fits — block-by-block output equals the one-shot
    :func:`pfb_channelize_os` frame-for-frame (tested). Emitted frame
    counts are kept multiples of ``os`` so the reference-phase classes
    stay aligned across blocks."""

    def __init__(
        self,
        n_chan: int,
        os: int = 2,
        taps: Optional[np.ndarray] = None,
        taps_per_branch: int = 16,
        scale: Scale = Scale.NONE,
        fft_backend: Optional[str] = None,
    ):
        self.n_chan = int(n_chan)
        self.os = int(os)
        if self.os < 1 or self.n_chan % self.os:
            raise ValueError(f"os must divide n_chan ({n_chan} % {os})")
        self.hop = self.n_chan // self.os
        self.taps = (
            np.asarray(taps).ravel()
            if taps is not None
            else pfb_prototype_nyquist(self.n_chan, taps_per_branch)
        )
        self.p = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.fft_backend = fft_backend
        self._tail = None

    def step(self, block) -> jnp.ndarray:
        x = jnp.asarray(block, dtype=cf32)
        if self._tail is not None:
            x = jnp.concatenate([self._tail, x], axis=-1)
        n = int(x.shape[-1])
        pm = self.p * self.n_chan
        t1 = (n - pm) // self.hop + 1 if n >= pm else 0
        t1 -= t1 % self.os
        if t1 <= 0:
            raise ValueError(
                f"block too short: need >= {pm + (self.os - 1) * self.hop} "
                f"buffered samples for one os-aligned frame group, have {n}"
            )
        span = (t1 - 1) * self.hop + pm
        y = pfb_channelize_os(
            x[..., :span], self.n_chan, os=self.os, taps=self.taps,
            scale=self.scale, fft_backend=self.fft_backend,
        )
        self._tail = x[..., t1 * self.hop :]
        return y

    __call__ = step


class PfbSynthesizerOs:
    """Streaming oversampled-PFB synthesis stage: raw weighted
    overlap-add per block, the ``P*M - hop`` output tail carried and
    added into the next block, division by the PERIODIC interior
    divisor at emission — block-by-block output equals the one-shot
    interior exactly (the one-shot's edge-aware normalization differs
    only inside the first/last ``P*M`` cold-start samples)."""

    def __init__(
        self,
        n_chan: int,
        os: int = 2,
        taps: Optional[np.ndarray] = None,
        taps_per_branch: int = 16,
        scale: Scale = Scale.N,
        fft_backend: Optional[str] = None,
    ):
        self.n_chan = int(n_chan)
        self.os = int(os)
        if self.os < 1 or self.n_chan % self.os:
            raise ValueError(f"os must divide n_chan ({n_chan} % {os})")
        self.hop = self.n_chan // self.os
        self.taps = (
            np.asarray(taps).ravel()
            if taps is not None
            else pfb_prototype_nyquist(self.n_chan, taps_per_branch)
        )
        self.p = max(1, -(-self.taps.shape[-1] // self.n_chan))
        self.scale = scale
        self.fft_backend = fft_backend
        # periodic interior divisor: full-overlap sum of |h|^2 hop-tiles
        pm = self.p * self.n_chan
        h = np.asarray(self.taps, np.complex128).ravel()
        h = np.pad(h, (0, pm - h.shape[-1]))
        hg = np.abs(h) ** 2
        dper = np.zeros(self.hop, np.float64)
        for t in range(pm // self.hop):
            dper += hg[t * self.hop : (t + 1) * self.hop]
        self._dper = dper.astype(np.float32)
        self._tail = None

    def step(self, frames) -> jnp.ndarray:
        y = jnp.asarray(frames, dtype=cf32)
        t = int(y.shape[-2])
        if t % self.os:
            raise ValueError(f"frame count {t} must be a multiple of os={self.os}")
        pm = self.p * self.n_chan
        span = (t - 1) * self.hop + pm
        raw = pfb_synthesize_os(
            y, self.n_chan, os=self.os, taps=self.taps, scale=self.scale,
            fft_backend=self.fft_backend, length=span, normalize=False,
        )
        if self._tail is not None:
            raw = raw.at[..., : pm - self.hop].add(self._tail)
        emit_n = t * self.hop
        denom = jnp.asarray(np.tile(self._dper, t))
        out = raw[..., :emit_n] / denom
        self._tail = raw[..., emit_n:]
        return out

    def flush(self) -> jnp.ndarray:
        """Remaining partial overlap-add tail (periodically normalized)."""
        if self._tail is None:
            return jnp.zeros(0, cf32)
        n = int(self._tail.shape[-1])
        reps = -(-n // self.hop)
        denom = jnp.asarray(np.tile(self._dper, reps)[:n])
        out = self._tail / denom
        self._tail = None
        return out

    __call__ = step


def sharded_pfb_os(
    samples,
    n_chan: int,
    mesh: jax.sharding.Mesh,
    os: int = 2,
    taps: Optional[np.ndarray] = None,
    taps_per_branch: int = 16,
    scale: Scale = Scale.NONE,
    axis_name: str = "time",
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """Oversampled PFB with contiguous time spans sharded over the mesh:
    frames are FORWARD-looking, so each shard pulls a ``P*M - hop`` RIGHT
    halo from its neighbor (:func:`~aether_primitives_tpu.parallel.halo.right_head`
    — the dual of the causal chains' left halo) and emits the
    ``span/hop`` frames that start inside its span. Equals the
    single-device :func:`pfb_channelize_os` frame-for-frame (the last
    shard's zero halo reproduces the one-shot's zero-padded tail). Each
    device span must be divisible by ``n_chan`` so the ``os``
    reference-phase classes align per shard.
    """
    from ..parallel.halo import right_head

    x = jnp.asarray(samples, dtype=cf32)
    m = int(n_chan)
    os = int(os)
    if os < 1 or m % os:
        raise ValueError(f"os must divide n_chan ({m} % {os})")
    hop = m // os
    if taps is None:
        taps = pfb_prototype_nyquist(m, taps_per_branch)
    h = np.asarray(taps).ravel()
    p = max(1, -(-h.shape[-1] // m))
    overlap = p * m - hop

    def shard_fn(xl):
        span = xl.shape[-1]
        if span % m:
            raise ValueError("per-device span must be divisible by n_chan")
        if span < overlap:
            raise ValueError(
                f"per-device span {span} < halo P*M - hop = {overlap}: the "
                "right halo only reaches ONE neighbor (like the causal "
                "chains' left halo) — use fewer shards or a longer capture"
            )
        halo = right_head(xl, overlap, axis_name)
        ext = jnp.concatenate([xl, halo], axis=-1)
        # ext = span + P*M - hop samples -> exactly span/hop full frames
        return pfb_channelize_os(
            ext, m, os=os, taps=h, scale=scale, fft_backend=fft_backend
        )

    nd = jnp.ndim(x)
    spec_in = P(*([None] * (nd - 1) + [axis_name]))
    spec_out = P(*([None] * (nd - 1) + [axis_name, None]))
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in, out_specs=spec_out)
    return fn(x)
