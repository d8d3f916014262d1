"""Digital down/up-converters: the channel-extraction front of every SDR
receive chain, and its transmit dual.

The reference stops at primitives (mix/filter/decimate all exist separately
by SURVEY.md §2 — but its fir.rs is a stub and there is no mixer at all);
a deployed receiver composes them constantly: tune to a channel, filter it,
and drop the rate. These models provide that composition as one streaming,
jittable stage built on the framework's kernels:

- :class:`Ddc` — ``y = decimate(lowpass(x * e^{-j 2 pi f n}))``. The mixer
  is the exact-mod NCO (:func:`..ops.frontend.nco_mix`); filter+decimate is
  the fused overlap-save spectral fold
  (:func:`..ops.fir.fir_filter_os_decimate`) whose inverse transform is
  ``1/decimation`` the size — no strided op anywhere, everything batched
  FFT + elementwise.
- :class:`Duc` — the dual: polyphase interpolation (``dec`` low-rate
  overlap-save branch filters, interleaved by a layout swap — the
  zero-stuffed stream never exists) followed by the NCO mix up to the
  carrier.

Both carry streaming state (oscillator phase + filter history) so a long
capture fed block-by-block is bit-equal to the single-shot computation
(tested), and both are plain functions of ``(block, state)`` under the
hood — jit/scan/shard_map-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

import jax

from ..types import cf32
from ..ops import fir as _fir
from ..ops import frontend as _fe


def _design_lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Hamming-windowed sinc, unit DC gain (the chain's house design)."""
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.complex64)


@dataclass(frozen=True)
class DdcConfig:
    """Digital down-converter parameters.

    ``freq``: channel center, cycles/sample at the INPUT rate.
    ``decimation``: output rate = input rate / decimation.
    ``taps``: channel-select lowpass (None = auto: Hamming-windowed sinc,
    cutoff ``1/(2*decimation)``, ``16*decimation + 1`` taps — the same
    design rule as :class:`~aether_primitives_tpu.models.RxChainConfig`).
    """

    freq: float = 0.0
    decimation: int = 4
    taps: Optional[np.ndarray] = None
    block_len: Optional[int] = None
    fft_backend: Optional[str] = None

    def resolved_taps(self) -> np.ndarray:
        if self.taps is not None:
            return np.asarray(self.taps, np.complex64).ravel()
        if self.decimation == 1:
            return np.asarray([1.0 + 0j], np.complex64)
        return _design_lowpass(
            16 * self.decimation + 1, 1.0 / (2 * self.decimation)
        )


class Ddc:
    """Streaming digital down-converter (see module docstring).

    ``step(block)`` consumes ``[n]`` complex64 samples at the input rate
    and returns ``ceil(n / decimation)`` baseband samples; oscillator phase
    and the ``K-1``-sample filter history carry across calls, so feeding a
    capture block-by-block equals the single-shot result exactly (tested).
    Reset by constructing a new instance. For independent channels, run one
    ``Ddc`` per channel center over the same block (streaming) or
    :func:`ddc_bank` (one-shot batched extraction).

    A tone at the channel center comes out at DC at the low rate:

    >>> import numpy as np
    >>> t = np.arange(4096)
    >>> x = np.exp(2j * np.pi * 0.2 * t).astype(np.complex64)
    >>> y = np.asarray(Ddc(DdcConfig(freq=0.2, decimation=4)).step(x))
    >>> y.shape
    (1024,)
    >>> bool(np.abs(np.fft.fft(y[256:768])).argmax() == 0)
    True
    """

    def __init__(self, config: DdcConfig = DdcConfig()):
        self.config = config
        self.taps = config.resolved_taps()
        self._phase = 0.0
        self._history: Optional[jnp.ndarray] = None

    def step(self, block) -> jnp.ndarray:
        x = jnp.asarray(block, dtype=cf32)
        n = x.shape[-1]
        mixed = _fe.nco_mix(x, -self.config.freq, self._phase)
        y = _fir.fir_filter_os_decimate(
            mixed,
            self.taps,
            self.config.decimation,
            block_len=self.config.block_len,
            fft_backend=self.config.fft_backend,
            history=self._history,
        )
        k = self.taps.shape[-1]
        if k > 1:
            hist = mixed[..., -(k - 1):] if n >= k - 1 else jnp.concatenate(
                [
                    (self._history if self._history is not None
                     else jnp.zeros(x.shape[:-1] + (k - 1,), cf32))[..., n:],
                    mixed,
                ],
                axis=-1,
            )
            self._history = hist
        self._phase = float(_fe.next_phase(n, -self.config.freq, self._phase))
        return y

    __call__ = step


def ddc_bank(x, freqs, decimation: int, taps=None, fft_backend=None) -> jnp.ndarray:
    """Extract ``C`` arbitrarily-placed channels at once: one batched
    mix + fold over a ``[C, n]`` broadcast of the capture.

    The non-uniform counterpart of the PFB channelizer
    (:func:`~aether_primitives_tpu.models.channelizer.pfb_channelize`,
    which needs uniformly spaced channels): each row mixes by its own
    f64-exact NCO tables (``nco_mix`` broadcasts per-row frequencies) and
    all rows share one batched decimating overlap-save — XLA sees a single
    ``[C, ...]`` FFT workload. Returns ``[C, ceil(n/decimation)]``.
    One-shot (phase starts at 0); for streaming state use one
    :class:`Ddc` per channel.
    """
    x = jnp.asarray(x, dtype=cf32)
    if x.ndim != 1:
        raise ValueError("ddc_bank takes a 1-D capture")
    f = np.asarray(freqs, np.float64).ravel()
    if taps is None:
        taps = DdcConfig(decimation=decimation).resolved_taps()
    mixed = _fe.nco_mix(jnp.broadcast_to(x, (f.shape[0], x.shape[-1])), -f)
    return _fir.fir_filter_os_decimate(
        mixed, taps, decimation, fft_backend=fft_backend
    )


def sharded_ddc(
    x,
    config: DdcConfig,
    mesh: jax.sharding.Mesh,
    axis_name: str = "time",
) -> jnp.ndarray:
    """DDC over a time-sharded capture: bit-close to single-device
    ``Ddc(config).step`` on the gathered signal, scaled over the mesh.

    Each shard holds a contiguous span of the capture. Two pieces make the
    result exactly continuous across shards:

    - **global oscillator phase**: shard ``i`` starts at global sample
      ``i * n_local``, so its local mix is the phase-0 mix rotated by the
      per-shard constant ``e^{-j 2 pi f i n_local}``. The rotators are
      f64-exact host constants indexed by ``axis_index`` (a
      ``[mesh_size]`` table — no long in-shard ramps, same precision as
      the exact-mod NCO).
    - **filter halo**: the left neighbor's last ``K-1`` *mixed* samples
      arrive from the neighbor device (:func:`~aether_primitives_tpu.parallel.halo.left_tail`)
      as the decimating overlap-save history.

    ``n_local`` must be divisible by ``decimation`` so the decimated
    streams concatenate on the global grid (asserted).
    """
    from ..parallel.halo import left_tail

    pspec = jax.sharding.PartitionSpec
    size = mesh.shape[axis_name]
    n = x.shape[-1]
    if n % size:
        raise ValueError(f"capture length {n} must divide over {size} shards")
    n_local = n // size
    if n_local % config.decimation:
        raise ValueError(
            f"local shard length {n_local} must be divisible by the "
            f"decimation {config.decimation}"
        )
    taps = config.resolved_taps()
    # f64-exact per-shard phase rotators: e^{-j 2 pi f * i * n_local}
    cyc = np.mod(-np.float64(config.freq) * n_local * np.arange(size), 1.0)
    rotators = np.exp(2j * np.pi * cyc).astype(np.complex64)

    def shard_fn(x_local):
        i = jax.lax.axis_index(axis_name)
        rot = jnp.asarray(rotators)[i]
        mixed = rot * _fe.nco_mix(x_local, -config.freq)
        k = taps.shape[-1]
        h = left_tail(mixed, k - 1, axis_name) if k > 1 else None
        return _fir.fir_filter_os_decimate(
            mixed,
            taps,
            config.decimation,
            block_len=config.block_len,
            fft_backend=config.fft_backend,
            history=h,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=pspec(*([None] * (x.ndim - 1) + [axis_name])),
        out_specs=pspec(*([None] * (x.ndim - 1) + [axis_name])),
    )
    return fn(x)


@dataclass(frozen=True)
class DucConfig:
    """Digital up-converter parameters.

    ``freq``: carrier, cycles/sample at the OUTPUT rate.
    ``interpolation``: output rate = input rate * interpolation.
    ``taps``: interpolation lowpass at the output rate (None = auto:
    cutoff ``1/(2*interpolation)``, ``16*interpolation + 1`` taps, gain
    ``interpolation`` so a passband tone keeps its amplitude through
    zero-stuffing).
    """

    freq: float = 0.0
    interpolation: int = 4
    taps: Optional[np.ndarray] = None
    block_len: Optional[int] = None
    fft_backend: Optional[str] = None

    def resolved_taps(self) -> np.ndarray:
        if self.taps is not None:
            return np.asarray(self.taps, np.complex64).ravel()
        if self.interpolation == 1:
            return np.asarray([1.0 + 0j], np.complex64)
        h = _design_lowpass(
            16 * self.interpolation + 1, 1.0 / (2 * self.interpolation)
        )
        return (h * self.interpolation).astype(np.complex64)


def _polyphase_branches(taps: np.ndarray, ell: int) -> np.ndarray:
    """``[L, kb]`` polyphase decomposition: branch ``t`` holds
    ``h[t], h[t+L], h[t+2L], ...`` (zero-padded to equal length)."""
    k = taps.shape[-1]
    kb = -(-k // ell)
    padded = np.zeros(kb * ell, np.complex64)
    padded[:k] = taps
    return padded.reshape(kb, ell).T.copy()


class Duc:
    """Streaming digital up-converter: polyphase interpolation + NCO mix.

    The zero-stuffed stream is never materialized: with ``L`` branches
    (``L = interpolation``) the interpolated signal is

        y[L*u + t] = sum_m h[t + L*m] * x[u - m]

    — ``L`` low-rate overlap-save FIRs (one per output phase ``t``) whose
    outputs interleave by a ``[t, u] -> [u, t]`` layout swap, exactly the
    structure of the fused TX frame op (ops/fir.py:interp_fir_ifft). FIR
    work stays at the LOW rate; cost scales with input samples, not output.
    """

    def __init__(self, config: DucConfig = DucConfig()):
        self.config = config
        self.taps = config.resolved_taps()
        self._branches = _polyphase_branches(
            self.taps, int(config.interpolation)
        )
        self._phase = 0.0
        self._history: Optional[jnp.ndarray] = None

    def step(self, block) -> jnp.ndarray:
        x = jnp.asarray(block, dtype=cf32)
        n = x.shape[-1]
        ell = int(self.config.interpolation)
        kb = self._branches.shape[-1]
        outs = [
            _fir.fir_filter_os(
                x,
                self._branches[t],
                block_len=self.config.block_len,
                fft_backend=self.config.fft_backend,
                history=(
                    None if self._history is None or kb == 1
                    else self._history[..., -(kb - 1):]
                ),
            )
            for t in range(ell)
        ]
        y_tu = jnp.stack(outs, axis=-2)  # [..., L, n]
        y = jnp.swapaxes(y_tu, -1, -2).reshape(x.shape[:-1] + (n * ell,))
        if kb > 1:
            self._history = x[..., -(kb - 1):] if n >= kb - 1 else (
                jnp.concatenate(
                    [
                        (self._history if self._history is not None
                         else jnp.zeros(x.shape[:-1] + (kb - 1,), cf32))[..., n:],
                        x,
                    ],
                    axis=-1,
                )
            )
        y = _fe.nco_mix(y, self.config.freq, self._phase)
        self._phase = float(_fe.next_phase(n * ell, self.config.freq, self._phase))
        return y

    __call__ = step


def sharded_duc(
    x,
    config: DucConfig,
    mesh: jax.sharding.Mesh,
    axis_name: str = "time",
) -> jnp.ndarray:
    """DUC over a time-sharded baseband: bit-close to single-device
    ``Duc(config).step`` on the gathered signal.

    The mirror of :func:`sharded_ddc`: each shard runs the polyphase
    branch filters with the left neighbor's ``kb-1`` input samples as
    overlap-save history (halo exchange), interleaves locally (a shard's
    ``n_local`` inputs produce exactly its ``n_local * L`` contiguous
    outputs — the interleave never crosses shards), and mixes up with a
    per-shard f64-exact oscillator rotator at the OUTPUT rate.
    """
    from ..parallel.halo import left_tail

    pspec = jax.sharding.PartitionSpec
    size = mesh.shape[axis_name]
    n = x.shape[-1]
    if n % size:
        raise ValueError(f"baseband length {n} must divide over {size} shards")
    n_local = n // size
    ell = int(config.interpolation)
    taps = config.resolved_taps()
    branches = _polyphase_branches(taps, ell)
    kb = branches.shape[-1]
    cyc = np.mod(
        np.float64(config.freq) * (n_local * ell) * np.arange(size), 1.0
    )
    rotators = np.exp(2j * np.pi * cyc).astype(np.complex64)

    def shard_fn(x_local):
        i = jax.lax.axis_index(axis_name)
        halo = left_tail(x_local, kb - 1, axis_name) if kb > 1 else None
        outs = [
            _fir.fir_filter_os(
                x_local, branches[t], block_len=config.block_len,
                fft_backend=config.fft_backend, history=halo,
            )
            for t in range(ell)
        ]
        y_tu = jnp.stack(outs, axis=-2)
        y = jnp.swapaxes(y_tu, -1, -2).reshape(
            x_local.shape[:-1] + (x_local.shape[-1] * ell,)
        )
        rot = jnp.asarray(rotators)[i]
        return rot * _fe.nco_mix(y, config.freq)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=pspec(*([None] * (x.ndim - 1) + [axis_name])),
        out_specs=pspec(*([None] * (x.ndim - 1) + [axis_name])),
    )
    return fn(jnp.asarray(x, dtype=cf32))
