"""End-to-end modem chains — the framework's flagship models.

Two tiers:

- :class:`Modem` — the reference's QPSK loopback (reference
  examples/modem.rs: bits → QPSK → AWGN → hard demod → bit-exact assert),
  fully batched and jittable; the PR1 acceptance path.
- :class:`RxChain` — the production receive chain: FIR (channel-select) → decimate → blocked FFT →
  demod, as one fused jitted step over sample blocks; shards over a time
  axis with halo exchange via
  :func:`aether_primitives_tpu.parallel.halo.sharded_fir`-style wrapping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fir as _fir
from ..ops import modulation as _mod
from ..ops import noise as _noise
from ..ops.fft import (
    Scale,
    default_backend as _fft_default_backend,
    fft_of_decimated,
    plan as fft_plan,
)
from ..parallel import halo as _halo
from ..parallel.mesh import TIME_AXIS
from ..types import cf32

P = jax.sharding.PartitionSpec


@dataclass
class ModemConfig:
    modulation: str = "qpsk"  # "bpsk" | "qpsk" | "qam16"
    noise_power: float = 0.01  # reference examples/modem.rs:25
    seed: int = 815


class Modem:
    """QPSK/BPSK loopback modem (reference examples/modem.rs equivalent).

    ``tx`` maps {0,1} bits to symbols; ``rx`` hard-demods symbols back to
    bits; ``loopback`` runs tx → AWGN → rx in one jitted step and is
    bit-exact at the reference's noise power.
    """

    def __init__(self, config: ModemConfig = ModemConfig()):
        self.config = config
        self.modulation = _modulation_by_name(config.modulation)

    def tx(self, bits) -> jnp.ndarray:
        return self.modulation.modulate(bits)

    def rx(self, symbols) -> jnp.ndarray:
        return self.modulation.demod(symbols)

    def loopback(self, bits, key=None) -> jnp.ndarray:
        """bits -> modulate -> AWGN -> demod -> bits, one fused step."""
        if key is None:
            key = jax.random.key(self.config.seed)
        symbols = self.tx(bits)
        noisy = _noise.apply(key, symbols, self.config.noise_power)
        return self.rx(noisy)


@dataclass
class RxChainConfig:
    """FIR → decimate → blocked FFT → demod receive chain parameters."""

    # None = auto-design a proper anti-aliasing lowpass for the configured
    # decimation: Hamming-windowed sinc, cutoff 1/(2*decimation),
    # 16*decimation+1 taps (identity for decimation 1). A wider filter
    # (e.g. cutoff 1/decimation) lets decimation images alias into the
    # band — QPSK's sign decisions survive that, QAM's amplitude levels
    # do not.
    fir_taps: Optional[np.ndarray] = None
    decimation: int = 4
    fft_len: int = 2048
    modulation: str = "qpsk"  # "bpsk" | "qpsk" | "qam16"
    fft_backend: Optional[str] = None
    # OFDM-style occupied-subcarrier count (even; None = all bins). The
    # active bins are the center of the band: FFT indices [0, a/2) and
    # [fft_len - a/2, fft_len) — guard bands keep symbols inside the
    # pulse-shaping filters' flat region so a TxChain->RxChain loopback is
    # bit-exact.
    active_bins: Optional[int] = None
    # FIR realization: "shift_add" (exact time domain; None selects it),
    # "fused" (FIR + decimation + frame FFT collapse into ONE span-point
    # forward FFT per frame via spectral folding,
    # ops/fir.py:fir_decimate_fft) or "os" (overlap-save: FFT -> H ->
    # iFFT, then a separate decimating FFT). All three produce identical
    # demod bits (tested).
    fir_mode: Optional[str] = None
    # Einsum precision of the fused frame op: "highest" (full f32, the
    # default when None) or "high" (bf16x3). DEFAULT is rejected: it
    # fails the reference's -80 dB assert_evm contract.
    precision: Optional[str] = None
    # First-stage size of the fused op's two-einsum path (must divide
    # fft_len). None = heuristic (largest divisor <= 128).
    stage_n1: Optional[int] = None
    # Emit PACKED bits: uint8 bytes holding 8 bits each, LSB-first
    # (np.unpackbits(..., bitorder="little") restores the flat stream) —
    # the format a production modem hands to the MAC layer, with 8x less
    # downstream memory and host traffic. Off by default: the
    # reference's demod contract is one byte per bit
    # (reference src/modulation.rs:133-144).
    packed_bits: bool = False



def _modulation_by_name(name: str):
    if name == "qpsk":
        return _mod.qpsk()
    if name == "bpsk":
        return _mod.bpsk()
    if name == "qam16":
        return _mod.qam16()
    if name.startswith("qam") and name[3:].isdigit():
        return _mod.qam(int(name[3:]))  # any Gray square QAM: qam64, qam256, ...
    if name.startswith("psk") and name[3:].isdigit():
        return _mod.psk(int(name[3:]))  # any Gray M-PSK: psk8, psk16, ...
    raise ValueError(
        f"unknown modulation {name!r} (expected 'bpsk', 'qpsk', 'qamN' or 'pskN')"
    )


def _resolve_chain(config: "RxChainConfig"):
    """Shared RxChain/TxChain init: (modulation, taps, fft plan, fir_mode)."""
    modulation = _modulation_by_name(config.modulation)
    # taps stay host-side numpy: eager complex device arrays cannot be
    # embedded as jit constants on backends without complex transfer
    if config.fir_taps is None:
        if config.decimation > 1:
            taps = _default_lowpass(16 * config.decimation + 1,
                                    1.0 / (2 * config.decimation))
        else:
            taps = np.asarray([1.0 + 0j], dtype=np.complex64)
    else:
        taps = np.asarray(config.fir_taps, dtype=np.complex64)
    plan = fft_plan(config.fft_len, config.fft_backend)
    mode = config.fir_mode or "shift_add"
    if mode not in ("fused", "os", "shift_add"):
        raise ValueError(f"unknown fir_mode {mode!r}")
    return modulation, taps, plan, mode


def _default_lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.hamming(ntaps)
    return (h / h.sum()).astype(np.complex64)


class RxChain:
    """The flagship receive chain: one fused jitted block step.

    A block is ``[..., n]`` complex64 samples with
    ``n % (decimation * fft_len) == 0``. The step:

      1. causal FIR channel-select filter,
      2. integer decimation,
      3. blocked forward FFT (``Scale.SN``) — the OFDM-style symbol
         transform (rows = time, cols = bins, like the reference's
         waterfall channelizer, src/util/plot.rs:59-62),
      4. hard demod of every bin to bits.

    ``samples_per_block -> samples_per_block / decimation * bits_per_symbol``
    bits out.
    """

    def __init__(self, config: RxChainConfig = RxChainConfig()):
        self.config = config
        self.modulation, self.taps, self._plan, self.fir_mode = _resolve_chain(config)
        if config.packed_bits:
            bpf = self.modulation.bits_per_symbol * (
                config.active_bins or config.fft_len
            )
            if bpf % 8:
                raise ValueError(
                    "packed_bits needs bits-per-frame divisible by 8, "
                    f"got {bpf}"
                )

    def _fir(self, x, history=None):
        taps = jnp.asarray(self.taps)
        if self.fir_mode in ("os", "fused"):
            # ~4k blocks: FFT work per sample grows with block size and
            # per-block overhead dominates below ~2k. fir_filter_os pads
            # the tail block, so no divisibility constraint applies.
            k = taps.shape[-1]
            block_len = max(min(4096, x.shape[-1]), k - 1 if k > 1 else 1)
            return _fir.fir_filter_os(
                x, taps, block_len=block_len,
                fft_backend=self.config.fft_backend, history=history,
            )
        if history is not None:
            ext = jnp.concatenate([history, x], axis=-1)
            return _fir.fir_filter_decimate(ext, taps, 1, padding="valid")
        return _fir.fir_filter(x, taps)

    def _frames_spectra(self, x, history=None) -> jnp.ndarray:
        """Full-rate block -> per-frame full-bin spectra [..., nsym, fft_len].

        The chain's hot path. ``fir_mode="fused"`` collapses FIR + decimate +
        frame FFT into one span-point forward FFT per frame
        (:func:`~aether_primitives_tpu.ops.fir.fir_decimate_fft`); the other
        modes filter first and run the decimating frame FFT separately.
        """
        cfg = self.config
        if self.fir_mode == "fused":
            return _fir.fir_decimate_fft(
                x, self.taps, cfg.decimation, cfg.fft_len, Scale.SN,
                history=history, fft_backend=cfg.fft_backend,
                precision=self._einsum_precision(), stage_n1=cfg.stage_n1,
            )
        y = self._fir(x, history=history)
        span = cfg.fft_len * cfg.decimation
        nsym = y.shape[-1] // span
        frames = y.reshape(y.shape[:-1] + (nsym, span))
        return fft_of_decimated(frames, cfg.decimation, Scale.SN, cfg.fft_backend)

    def _einsum_precision(self):
        name = self.config.precision or "highest"
        try:
            return {
                "highest": jax.lax.Precision.HIGHEST,
                "high": jax.lax.Precision.HIGH,
            }[name]
        except KeyError:
            raise ValueError(
                f"precision {name!r} not allowed (expected 'highest' or "
                "'high'; DEFAULT fails the -80 dB EVM contract)"
            ) from None

    def _active(self, spec) -> jnp.ndarray:
        """Slice the occupied (center-band) subcarriers out of full frames."""
        a = self.config.active_bins
        if a:
            half = a // 2
            n = spec.shape[-1]
            spec = jnp.concatenate(
                [spec[..., :half], spec[..., n - (a - half):]], axis=-1
            )
        return spec

    @staticmethod
    def _pack_flat(bits) -> jnp.ndarray:
        """Flat per-bit u8 -> packed bytes (LSB-first). The portable
        fallback packer; the fast path packs inside its epilogue."""
        n = bits.shape[-1]
        w = bits.reshape(bits.shape[:-1] + (n // 8, 8)).astype(jnp.uint32)
        byte = w[..., 0]
        for m in range(1, 8):
            byte = byte | (w[..., m] << m)
        return byte.astype(jnp.uint8)

    def _emit(self, flat_bits) -> jnp.ndarray:
        return (
            self._pack_flat(flat_bits)
            if self.config.packed_bits else flat_bits
        )

    def _demod_frames(self, spec) -> jnp.ndarray:
        bits = self.modulation.demod(self._active(spec))
        return self._emit(bits.reshape(bits.shape[:-2] + (-1,)))

    def spectra(self, block) -> jnp.ndarray:
        """Front half of the chain: block -> per-frame active-bin spectra
        ``[..., n_frames, active_bins]`` — the hook for channel estimation /
        equalization (see :mod:`.sync`) before :meth:`demod_spectra`."""
        x = jnp.asarray(block, dtype=cf32)
        return self._active(self._frames_spectra(x))

    def demod_spectra(self, active_spec) -> jnp.ndarray:
        """Back half: (possibly equalized) active-bin spectra -> bits
        (packed bytes when ``config.packed_bits``)."""
        bits = self.modulation.demod(jnp.asarray(active_spec, dtype=cf32))
        return self._emit(bits.reshape(bits.shape[:-2] + (-1,)))

    def _sign_fast_path_ok(self) -> bool:
        """True when the staged-layout sign-demod fast path applies: fused
        mode on the two-einsum matmul path, all bins active, and a
        modulation whose hard decisions are sign tests."""
        cfg = self.config
        if self.fir_mode != "fused" or cfg.active_bins:
            return False
        if self.config.modulation not in ("bpsk", "qpsk"):
            return False
        backend = cfg.fft_backend or _fft_default_backend()
        return (
            backend == "matmul"
            and _fir._fused_stage_n1(cfg.decimation, cfg.fft_len, cfg.stage_n1)
            is not None
        )

    def _bits_fast(self, x, history=None) -> jnp.ndarray:
        """block -> bits via the staged-layout sign demod.

        Demods straight off the fused op's pre-transpose ``(k1, d)`` einsum
        layout: sign tests ignore the positive ``Scale`` factor (skipped),
        the wrap correction is applied in-layout, the two bits pack into a
        uint16 word per symbol, and the natural-order transpose happens on
        those 2-byte words instead of the 8-byte complex spectra (4x less
        transpose traffic). Bit-exact vs ``demod_spectra(spectra(x))``:
        identical float values feed the same strict comparisons, and a
        positive scale never flips an IEEE sign.
        """
        cfg = self.config
        zk = _fir.fir_decimate_fft(
            x, self.taps, cfg.decimation, cfg.fft_len, Scale.NONE,
            history=history, fft_backend=cfg.fft_backend,
            precision=self._einsum_precision(), stage_n1=cfg.stage_n1,
            _staged_layout=True,
        )  # [n1, ..., nsym, r] — k1 leading
        re, im = jnp.real(zk), jnp.imag(zk)
        n1 = re.shape[0]
        if cfg.modulation == "bpsk":
            if cfg.packed_bits and n1 % 8 == 0:
                # pack 8 adjacent k1 symbols per byte while k1 still
                # leads: group slicing is free on the leading axis
                b = (re + im < 0).astype(jnp.uint32)
                g = b.reshape((n1 // 8, 8) + b.shape[1:])
                byte = g[:, 0]
                for m in range(1, 8):
                    byte = byte | (g[:, m] << m)
                byte = jnp.moveaxis(byte, 0, -1)  # [..., nsym, r, n1/8]
                byte = byte.reshape(byte.shape[:-2] + (-1,)).astype(jnp.uint8)
                return byte.reshape(byte.shape[:-2] + (-1,))
            b = (re + im < 0).astype(jnp.uint8)
            b = jnp.moveaxis(b, 0, -1)  # natural symbol order (d, k1)
            return self._emit(b.reshape(b.shape[:-3] + (-1,)))
        if cfg.packed_bits and n1 % 4 == 0:
            # QPSK: 4 adjacent k1 symbols (8 bits) per byte, LSB-first
            s2 = (re < 0).astype(jnp.uint32) | (
                (im < 0).astype(jnp.uint32) << 1
            )
            g = s2.reshape((n1 // 4, 4) + s2.shape[1:])
            byte = g[:, 0] | (g[:, 1] << 2) | (g[:, 2] << 4) | (g[:, 3] << 6)
            byte = jnp.moveaxis(byte, 0, -1)  # [..., nsym, r, n1/4]
            byte = byte.reshape(byte.shape[:-2] + (-1,)).astype(jnp.uint8)
            return byte.reshape(byte.shape[:-2] + (-1,))
        v = (re < 0).astype(jnp.uint16) | ((im < 0).astype(jnp.uint16) << 8)
        v = jnp.moveaxis(v, 0, -1)  # [..., nsym, r, n1]
        bits = jax.lax.bitcast_convert_type(v, jnp.uint8)  # [..., r, n1, 2]
        return self._emit(bits.reshape(bits.shape[:-4] + (-1,)))

    @property
    def frame_span(self) -> int:
        """Full-rate samples consumed per demodulated frame
        (``decimation * fft_len``)."""
        return self.config.decimation * self.config.fft_len

    def step(self, block) -> jnp.ndarray:
        """The jittable single-device forward step (block -> bits).

        The block length must divide by :attr:`frame_span` — the
        reference's contract (reference src/sampling.rs:32-36 asserts
        divisibility). For ragged captures pick a policy explicitly:
        :meth:`step_ragged` (drop-free: whole frames now, remainder
        returned) or :meth:`step_padded` (zero-pad the tail frame, the
        reference waterfall convention, reference src/util/plot.rs:50-57).
        """
        x = jnp.asarray(block, dtype=cf32)
        self._check_span(x.shape[-1])
        if self._sign_fast_path_ok():
            return self._bits_fast(x)
        return self.demod_spectra(self.spectra(x))

    def _check_span(self, n: int, shards: int = 1) -> None:
        span = self.frame_span
        if shards > 1:
            if n % shards:
                raise ValueError(
                    f"capture length {n} must divide over {shards} "
                    f"time shards; pad with pad_to_frames(x, "
                    f"{shards * span})"
                )
            n //= shards
            what = f"per-shard span {n}"
        else:
            what = f"block length {n}"
        if n % span:
            raise ValueError(
                f"{what} is not a multiple of frame_span "
                f"{span} (= decimation {self.config.decimation} x "
                f"fft_len {self.config.fft_len}); use step_ragged (keep "
                "the remainder) or step_padded (zero-pad the tail frame)"
            )

    def step_ragged(self, block):
        """Drop-free ragged-capture policy: demodulate every COMPLETE
        frame and hand back the remainder — ``(bits, tail)`` with
        ``tail = block[..., -(n % frame_span):]`` (length is static at
        trace time, so this stays jittable). ``bits`` equals
        :meth:`step` on the trimmed prefix; feed ``tail`` in front of the
        next capture to lose nothing."""
        x = jnp.asarray(block, dtype=cf32)
        n = x.shape[-1]
        r = n % self.frame_span
        whole = n - r
        if whole == 0:
            bits = jnp.zeros(x.shape[:-1] + (0,), jnp.uint8)
            return bits, x
        return self.step(x[..., :whole]), x[..., whole:]

    def step_padded(self, block) -> jnp.ndarray:
        """Zero-pad ragged-capture policy (the reference waterfall's,
        reference src/util/plot.rs:50-57): the tail frame is completed
        with zeros and demodulated — output covers ``ceil(n /
        frame_span)`` frames; tail bits past the real samples are the
        demod of the filter ring-down into zeros."""
        x = jnp.asarray(block, dtype=cf32)
        n = x.shape[-1]
        r = n % self.frame_span
        if r:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, self.frame_span - r)]
            x = jnp.pad(x, pad)
        return self.step(x)

    # -------------------------------------------------- streaming state

    def init_state(self, batch_shape=()) -> jnp.ndarray:
        """Zero FIR history ``[..., K-1]``: feeding a capture's FIRST block
        with this state makes :meth:`streaming_step` equal the causal
        :meth:`step` (which zero-pads before sample 0)."""
        k = self.taps.shape[-1]
        return jnp.zeros(tuple(batch_shape) + (max(k - 1, 0),), cf32)

    def streaming_step(self, block, state):
        """``(block, state) -> (bits, new_state)`` — :meth:`step` with the
        FIR history threaded block-to-block.

        :meth:`step` restarts the filter at every call, so successive
        blocks of ONE contiguous capture get ``K-1`` corrupted samples per
        boundary; this is the continuous form (the reference's pipeline
        contract, reference src/pipeline.rs:70-79): ``state`` is the
        previous block's last ``K-1`` full-rate samples
        (:meth:`init_state` before the first block), and N successive
        calls are bit-exact to one contiguous :meth:`step`
        (tests/test_models.py). Same compute graph as :meth:`step` — the
        history enters the fused op's existing wrap-correction matmul
        (ops/fir.py:600-627), so streaming costs nothing.

        Blocks must keep one static shape (one compile); state stays on
        device between calls, serializing nothing on the host.
        """
        x = jnp.asarray(block, dtype=cf32)
        self._check_span(x.shape[-1])
        k = self.taps.shape[-1]
        h = jnp.asarray(state, dtype=cf32) if k > 1 else None
        if self._sign_fast_path_ok():
            bits = self._bits_fast(x, history=h)
        else:
            bits = self._demod_frames(self._frames_spectra(x, history=h))
        if k > 1:
            if x.shape[-1] >= k - 1:
                new_state = x[..., x.shape[-1] - (k - 1):]
            else:
                # block shorter than the filter memory: the carried
                # history must keep the tail of the PREVIOUS state too —
                # a bare slice of x would silently shrink the state and
                # break the jitted shape contract / drop history
                # (review finding r4)
                new_state = jnp.concatenate([h, x], axis=-1)[..., -(k - 1):]
        else:
            new_state = jnp.asarray(state, dtype=cf32)
        return bits, new_state

    def streaming_step_split(self, block_split, state_split):
        """:meth:`streaming_step` over f32 :class:`~aether_primitives_tpu.
        boundary.Split` block AND state — the boundary-safe streaming
        signature (state crosses call boundaries as two f32 planes)."""
        from ..boundary import Split

        if not isinstance(block_split, Split) or not isinstance(
            state_split, Split
        ):
            raise TypeError("streaming_step_split expects Split block/state")
        bits, ns = self.streaming_step(
            block_split.to_complex(), state_split.to_complex()
        )
        return bits, Split(jnp.real(ns), jnp.imag(ns))

    def init_state_split(self, batch_shape=()):
        """:meth:`init_state` as a :class:`~aether_primitives_tpu.boundary.
        Split` (for :meth:`streaming_step_split`)."""
        from ..boundary import Split

        k = self.taps.shape[-1]
        z = np.zeros(tuple(batch_shape) + (max(k - 1, 0),), np.float32)
        return Split(z, z.copy())

    def jitted_streaming(self, donate_state: bool = True,
                         split_boundary: bool = False):
        """Compile :meth:`streaming_step` (optionally donating the state
        buffer — safe because each call consumes the previous call's
        state exactly once)."""
        fn = (
            self.streaming_step_split if split_boundary
            else self.streaming_step
        )
        return jax.jit(fn, donate_argnums=(1,) if donate_state else ())

    def _shard_bits(self, x, axis_name):
        """Per-shard block -> bits (halo + fast path when applicable)."""
        k = self.taps.shape[-1]
        h = _halo.left_tail(x, k - 1, axis_name) if k > 1 else None
        if self._sign_fast_path_ok():
            return self._bits_fast(x, history=h)
        return self._demod_frames(self._frames_spectra(x, history=h))

    def _sharded_step(self, block, mesh, axis_name):
        def shard_fn(x):
            return self._shard_bits(x, axis_name)

        spec_in = P(*([None] * (jnp.ndim(block) - 1) + [axis_name]))
        fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in, out_specs=spec_in)
        return fn(block)

    def sharded_step(self, block, mesh, axis_name: str = TIME_AXIS):
        """Time-sharded step: the capture's last axis splits into contiguous
        per-device spans; the FIR history crosses shard boundaries via an
        halo exchange, so the output is identical to :meth:`step`.

        Each device span must be divisible by ``decimation * fft_len``
        (:attr:`frame_span`); ragged captures must pick a tail policy
        BEFORE sharding (:meth:`step_padded` semantics via
        ``pad_to_frames(x, shards * frame_span)``, or trim the
        :meth:`step_ragged` remainder off) — a precise error names the
        required multiple otherwise.
        """
        x = jnp.asarray(block, dtype=cf32)
        self._check_span(x.shape[-1], shards=int(mesh.shape[axis_name]))
        return self._sharded_step(x, mesh, axis_name)

    def sharded_step_2d(
        self,
        block,
        mesh,
        channel_axis: str = "channel",
        time_axis: str = TIME_AXIS,
    ):
        """Two-axis sharding: independent channels (leading axis, pure data
        parallel) x contiguous time spans (last axis, halo exchange) — the
        full production layout for a multi-stream capture.
        """
        def shard_fn(x):
            return self._shard_bits(x, time_axis)

        block = jnp.asarray(block, dtype=cf32)
        self._check_span(block.shape[-1], shards=int(mesh.shape[time_axis]))
        nd = jnp.ndim(block)
        spec_in = P(*([channel_axis] + [None] * (nd - 2) + [time_axis]))
        fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=spec_in, out_specs=spec_in)
        return fn(block)

    def _shard_streaming_bits(self, x, s, time_axis):
        """Per-shard streaming body (inside ``shard_map``): the carried
        block-to-block state enters the FIRST time shard's halo slot; all
        other shards take their left neighbor's tail via the halo exchange as usual.
        Returns ``(bits, new_state)`` with ``new_state`` replicated over the
        time axis (psum-broadcast of the LAST shard's full-rate tail)."""
        k = self.taps.shape[-1]
        if k <= 1:
            if self._sign_fast_path_ok():
                return self._bits_fast(x), s
            return self._demod_frames(self._frames_spectra(x)), s
        # left_tail already rejects per-shard spans < k-1 (halo would need
        # to reach beyond one neighbor); the same bound makes the carried
        # state a plain slice of the local block below.
        halo = _halo.left_tail(x, k - 1, time_axis)
        first = jax.lax.axis_index(time_axis) == 0
        h = jnp.where(first, s, halo)
        if self._sign_fast_path_ok():
            bits = self._bits_fast(x, history=h)
        else:
            bits = self._demod_frames(self._frames_spectra(x, history=h))
        last = jax.lax.axis_index(time_axis) == jax.lax.axis_size(time_axis) - 1
        tail = x[..., x.shape[-1] - (k - 1):]
        new_state = jax.lax.psum(
            jnp.where(last, tail, jnp.zeros_like(tail)), time_axis
        )
        return bits, new_state

    def sharded_streaming_step_2d(
        self,
        block,
        state,
        mesh,
        channel_axis: str = "channel",
        time_axis: str = TIME_AXIS,
    ):
        """:meth:`streaming_step` on the ``(channel, time)`` mesh — the
        flagship composition: a CONTINUOUS capture processed block-by-block
        (the reference's pipeline contract, reference src/pipeline.rs:70-79)
        where each block is itself sharded into contiguous per-device time
        spans (with halo exchange) across independent channels.

        ``(block, state) -> (bits, new_state)``: ``block`` is
        ``[channels, n]`` sharded ``P(channel, time)``; ``state`` is the
        carried FIR history ``[channels, K-1]`` sharded ``P(channel, None)``
        (:meth:`init_state` with ``batch_shape=(channels,)`` before the first
        block). The state hand-off and the intra-block halo compose: shard 0
        of the time axis consumes the carried state where its halo would be,
        and the new state (the block's last ``K-1`` full-rate samples, i.e.
        the LAST time shard's tail) comes back replicated over time so the
        next call can feed it straight in. N successive calls are bit-exact
        to one contiguous :meth:`step` / :meth:`sharded_step_2d` of the
        concatenated capture (tests/test_parallel.py; driver
        ``dryrun_multichip``).
        """
        def shard_fn(x, s):
            return self._shard_streaming_bits(x, s, time_axis)

        self._check_span(
            jnp.shape(block)[-1], shards=int(mesh.shape[time_axis])
        )
        nd = jnp.ndim(block)
        mid = [None] * (nd - 2)
        spec_blk = P(*([channel_axis] + mid + [time_axis]))
        spec_state = P(*([channel_axis] + mid + [None]))
        fn = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(spec_blk, spec_state),
            out_specs=(spec_blk, spec_state),
        )
        return fn(
            jnp.asarray(block, dtype=cf32), jnp.asarray(state, dtype=cf32)
        )

    def _bits_from_planes(self, zr, zi) -> jnp.ndarray:
        """Sign demod + natural-order bit pack of k1-leading (zr, zi) planes."""
        cfg = self.config
        if cfg.modulation == "bpsk":
            b = (zr + zi < 0).astype(jnp.uint8)
            b = jnp.moveaxis(b, 0, -1)
            return self._emit(b.reshape(b.shape[:-3] + (-1,)))
        v = (zr < 0).astype(jnp.uint16) | ((zi < 0).astype(jnp.uint16) << 8)
        v = jnp.moveaxis(v, 0, -1)
        bits = jax.lax.bitcast_convert_type(v, jnp.uint8)
        return self._emit(bits.reshape(bits.shape[:-4] + (-1,)))

    def step_split(self, block_split):
        """:meth:`step` with an f32 :class:`~aether_primitives_tpu.boundary.Split`
        input — the boundary-safe signature for backends that cannot transfer
        complex arrays (bits out are uint8, already real).

        Merges the planes and takes the complex path (the all-real
        alternative is :func:`~aether_primitives_tpu.ops.fir.
        fir_decimate_fft_planes` + :meth:`_bits_from_planes`).
        """
        from ..boundary import Split

        if not isinstance(block_split, Split):
            raise TypeError("step_split expects a boundary.Split block")
        return self.step(block_split.to_complex())

    def jitted(self, donate: bool = True, split_boundary: bool = False):
        """Compile the step (optionally donating the input block's HBM).

        ``split_boundary=True`` compiles :meth:`step_split` instead, for
        callers that hold samples as interleaved or split f32 planes.
        """
        fn = self.step_split if split_boundary else self.step
        return jax.jit(fn, donate_argnums=(0,) if donate else ())


class TxChain:
    """The transmit chain: bits -> OFDM-style frames -> upsample + pulse
    shape -> complex samples; the exact inverse structure of :class:`RxChain`
    (share one :class:`RxChainConfig` for a matched pair).

    Per step: modulate bits onto the active subcarriers of each
    ``fft_len``-bin frame (guard bands zero), inverse-transform
    (``Scale.SN`` so the RX forward ``Scale.SN`` round-trips to identity),
    zero-stuff by ``decimation`` (a dense reshape, no strided scatter) and
    interpolate with the shared pulse-shaping FIR (gain ``decimation`` to
    preserve amplitude).

    Group delay: each symmetric length-K filter delays by ``(K-1)/2``
    full-rate samples; a TX->RX loopback therefore sees a total shift of
    ``(K_tx - 1)/2 + (K_rx - 1)/2`` that the receiver must skip before
    framing (see :func:`loopback_delay` and the loopback test).
    """

    def __init__(self, config: RxChainConfig = RxChainConfig()):
        self.config = config
        self.modulation, self.taps, self._plan, self.fir_mode = _resolve_chain(config)

    def bits_per_frame(self) -> int:
        a = self.config.active_bins or self.config.fft_len
        return a * self.modulation.bits_per_symbol

    def step(self, bits) -> jnp.ndarray:
        """[..., n_bits] {0,1} -> [..., n_frames * fft_len * decimation]
        complex samples (``n_bits`` divisible by :meth:`bits_per_frame`)."""
        cfg = self.config
        a = cfg.active_bins or cfg.fft_len
        bits = jnp.asarray(bits)
        bpf = self.bits_per_frame()
        if bits.shape[-1] % bpf:
            raise ValueError(
                f"bit count {bits.shape[-1]} not divisible by bits/frame {bpf}"
            )
        nframes = bits.shape[-1] // bpf
        syms = self.modulation.modulate(bits)
        syms = syms.reshape(syms.shape[:-1] + (nframes, a))
        if a != cfg.fft_len:
            half = a // 2
            guard = jnp.zeros(
                syms.shape[:-1] + (cfg.fft_len - a,), dtype=cf32
            )
            spec = jnp.concatenate(
                [syms[..., :half], guard, syms[..., half:]], axis=-1
            )
        else:
            spec = syms
        if cfg.decimation > 1 and self.fir_mode == "fused":
            # fused TX frame op: diag-multiplied batched backward FFTs — the
            # zero-stuffed stream and the span-point transform never exist
            # (ops/fir.py:interp_fir_ifft, the dual of the RX fusion)
            taps_host = self.taps * np.complex64(cfg.decimation)
            return _fir.interp_fir_ifft(
                spec, taps_host, cfg.decimation, Scale.SN,
                fft_backend=cfg.fft_backend,
            )
        tf = self._plan.bwd(spec, Scale.SN)
        x = tf.reshape(tf.shape[:-2] + (nframes * cfg.fft_len,))
        if cfg.decimation > 1:
            # zero-stuff via dense reshape: [..., n] -> [..., n, dec] -> flat
            z = jnp.zeros(x.shape + (cfg.decimation - 1,), dtype=cf32)
            up = jnp.concatenate([x[..., None], z], axis=-1)
            up = up.reshape(x.shape[:-1] + (x.shape[-1] * cfg.decimation,))
            taps = jnp.asarray(self.taps) * jnp.float32(cfg.decimation)
            if self.fir_mode == "os":
                x = _fir.fir_filter_os(up, taps, fft_backend=cfg.fft_backend)
            else:
                x = _fir.fir_filter(up, taps)
        return x

    def jitted(self, donate: bool = False):
        return jax.jit(self.step, donate_argnums=(0,) if donate else ())


def pad_to_frames(block, multiple: int) -> jnp.ndarray:
    """Zero-pad the last axis up to the next multiple of ``multiple`` —
    the explicit ragged-tail policy for the SHARDED paths (pass
    ``n_time_shards * chain.frame_span``): identical semantics to
    :meth:`RxChain.step_padded`, applied before the mesh split so every
    device span stays whole (the reference's zero-pad convention,
    reference src/util/plot.rs:50-57)."""
    x = jnp.asarray(block)
    r = x.shape[-1] % int(multiple)
    if not r:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, int(multiple) - r)]
    return jnp.pad(x, pad)


def loopback_delay(tx: "TxChain", rx: RxChain) -> int:
    """Full-rate sample delay of a TX->RX cascade (sum of the two symmetric
    filters' group delays); skip this many samples before RX framing."""
    d = 0
    if tx.config.decimation > 1:
        d += (tx.taps.shape[-1] - 1) // 2
    d += (rx.taps.shape[-1] - 1) // 2
    return d
