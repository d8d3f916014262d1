"""Packet transceiver: the full burst-link composition.

Everything below exists as an independently tested layer; this model
wires the complete TX / RX stack the way a deployed packet radio does —
the framework-level equivalent of the reference's modem example
(reference examples/modem.rs) grown into an actual link protocol:

TX: payload -> CRC (:func:`~..ops.fec.crc_append`)
            -> self-sync scramble (:func:`~..ops.sequence.scramble_multiplicative`)
            -> FEC (:func:`~..ops.fec.conv_encode`, :mod:`~..ops.ldpc`,
               or :mod:`~..ops.rs` Reed-Solomon for burst-error channels)
            -> block interleave -> modulate -> [preamble | symbols]

RX: capture -> preamble acquisition (:func:`~.sync.detect_preamble`)
            -> CFO from the preamble's repeated halves (:func:`~.sync.estimate_cfo`)
            -> complex-gain / noise-variance estimate off the known preamble
            -> soft demod -> deinterleave -> soft decode -> descramble
            -> CRC verdict

The RX graph is ONE jittable function: acquisition (argmax), correction,
demod, and the Viterbi/min-sum scan all run on device; nothing returns
to the host between the raw capture and the decoded bits. Frame sizes
are static (config-derived), so XLA sees fixed shapes end-to-end.

Preamble: Gold-sequence QPSK with two identical halves — one matched
filter finds it, the half-lag autocorrelation yields the CFO
unambiguously for ``|f| < 1/(2*half_len)`` cycles/sample.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bch as _bch
from ..ops import fec as _fec
from ..ops import ldpc as _ldpc
from ..ops import polar as _polar
from ..ops import modulation as _mod
from ..ops import rs as _rs
from ..ops import sequence as _seq
from ..ops import tpc as _tpc
from ..ops import turbo as _turbo
from ..types import cf32
from . import sync as _sync


def _modulation_by_name(name: str):
    named = {"bpsk": _mod.bpsk, "qpsk": _mod.qpsk, "qam16": _mod.qam16}
    if name in named:
        return named[name]()
    if name.startswith("apsk"):
        return _mod.apsk(int(name[4:]))
    if name.startswith("psk"):
        return _mod.psk(int(name[3:]))
    return _mod.qam(int(name[3:]))


@dataclass(frozen=True)
class PacketConfig:
    payload_bits: int = 960
    modulation: str = "qpsk"
    fec: str = "viterbi"  # "viterbi" | "ldpc" | "ldpc11n" | "nr_ldpc" | "rs" | "bch" | "tpc" | "ccsds" | "turbo" | "polar" | "none"
    crc: str = "crc32"
    scrambler: Tuple[int, ...] = (14, 15)
    interleave_rows: int = 0  # 0 = none; coded bits padded to a multiple
    preamble_half: int = 64  # symbols per identical half
    preamble_cinit: int = 0x1234
    ldpc_seed: int = 7
    # fec="ldpc" with a FILE-loaded code table (ops/code_io.py): path to
    # a MacKay .alist parity-check matrix or a QC .npz (base shifts + z,
    # save_qc_npz convention). The table is validated (rank, degrees,
    # girth report) and replaces the built-in Gallager ensemble; a QC
    # .npz additionally engages the fast QC edge-message decoder. The
    # drop-in slot for published standard tables.
    ldpc_file: Optional[str] = None
    # fec="nr_ldpc" with a file-loaded base graph (same .npz convention)
    # — the TS 38.212 shift-table drop-in path for NrLdpc(base_graph=)
    nr_base_graph_file: Optional[str] = None
    rs_n: int = 255  # Reed-Solomon codeword/message symbols (fec="rs")
    rs_k: int = 223
    # flag low-confidence GF(2^8) symbols as erasures before RS decoding:
    # a symbol is erased when its weakest bit |LLR| falls below
    # rs_erasure_threshold x the codeword's median — doubles the
    # correctable fade depth (2*errors + erasures <= n - k)
    rs_erasures: bool = False
    rs_erasure_threshold: float = 0.25
    # binary BCH (fec="bch", ops/bch.py): length-bch_n codewords, t
    # correctable bit errors each; the message length k falls out of
    # the generator construction (255/8 -> BCH(255, 191)). bch_chase > 0
    # switches hard decoding to Chase-2 soft decoding over 2^bch_chase
    # test patterns (~1.5-2 dB gain, one wider batched decode)
    bch_n: int = 255
    bch_t: int = 8
    bch_chase: int = 0
    # turbo product code (fec="tpc", ops/tpc.py): (2^tpc_m, k)^2
    # extended-BCH squares, Chase-Pyndiah iterative soft decoding;
    # tpc_t=1 -> extended Hamming components, 2 -> the stronger
    # 802.16-class extended BCH-2 squares
    tpc_m: int = 5
    tpc_p: int = 4
    tpc_iters: int = 4
    tpc_t: int = 1
    # concatenated CCSDS-style telemetry coding (fec="ccsds"): RS(rs_n,
    # rs_k) outer + K=7 (171, 133) convolutional inner, with a bit
    # block-interleaver between them so the Viterbi decoder's
    # characteristic burst errors scatter across RS codeword symbols
    ccsds_interleave_rows: int = 8
    # inner interleaver realization: "block" (rows x cols matrix) or
    # "conv" (circular Forney permutation, ops/fec.conv_interleave_block
    # with branches = ccsds_interleave_rows and the cell size below —
    # the deployed-telemetry delay-line structure, zero added latency in
    # its circular framed form)
    ccsds_interleaver: str = "block"
    ccsds_interleave_cell: int = 17
    # polar (fec="polar"): rate-1/2 codewords of length polar_n; list > 1
    # switches SC -> CA-SCL with a per-codeword inner CRC-8 (the 5G
    # decoder; the outer packet CRC stays the end-to-end verdict)
    polar_n: int = 512
    polar_list: int = 8
    polar_design_snr_db: float = 1.0
    # polar decoder realization: "scl" = CA-SCL (best BLER, serial over
    # bit indices — the latency/quality path) or "bp" = flooding belief
    # propagation (full-plane min-sum sweeps, batches like LDPC — the
    # throughput path, ~0.5-1 dB weaker at short N; ops/polar.py)
    polar_decoder: str = "scl"
    # NR-style QC-LDPC (fec="nr_ldpc", ops/nr_ldpc.py): base graph 1 or 2,
    # code rate realized by the spec's circular-buffer rate matching
    # (puncture/shorten/repeat); the lifting size is auto-picked as the
    # smallest with kb*Z >= frame bits (fillers absorb the slack), the
    # standard selection rule
    nr_bg: int = 2
    nr_rate: float = 0.5
    nr_rv: int = 0

    @property
    def crc_width(self) -> int:
        return _fec.CRC_PARAMS[self.crc][1]


class PacketModem:
    """Config-driven burst packet transceiver (see module docstring).

    ``tx(payload)`` -> complex burst; ``rx(capture)`` -> ``(payload,
    crc_ok, diag)`` where ``diag`` carries offset / CFO / gain /
    noise-variance / preamble-metric estimates. ``capture`` may place
    the burst at any offset the preamble search can cover.
    """

    def _ccsds_ilv(self, bits):
        """Inner interleaver. "conv" permutes GF(2^8) SYMBOLS (8-bit
        groups), the deployed-telemetry convention: a bit-level Forney
        permutation would scatter an L-bit burst into ~L distinct RS
        symbols (1 hit each — the WORST case for a symbol-correcting
        outer code; measured: a 96-bit burst touched 96 symbols at bit
        level vs ~12 at symbol level), while symbol-level spreading
        keeps each burst hit inside the symbol it already corrupted."""
        c = self.config
        if c.ccsds_interleaver == "conv":
            syms = bits.reshape(-1, 8).T  # [8, n_sym]
            out = _fec.conv_interleave_block(
                syms, c.ccsds_interleave_rows, c.ccsds_interleave_cell
            )
            return out.T.reshape(-1)
        return _fec.interleave(bits, c.ccsds_interleave_rows)

    def _ccsds_dilv(self, x):
        c = self.config
        if c.ccsds_interleaver == "conv":
            # batched over leading axes: bit planes of each GF(2^8)
            # symbol move to axis -2, the circular Forney permutation
            # acts on the symbol (last) axis
            syms = jnp.swapaxes(x.reshape(x.shape[:-1] + (-1, 8)), -1, -2)
            out = _fec.conv_deinterleave_block(
                syms, c.ccsds_interleave_rows, c.ccsds_interleave_cell
            )
            return jnp.swapaxes(out, -1, -2).reshape(x.shape)
        return _fec.deinterleave(x, c.ccsds_interleave_rows)

    def __init__(self, config: PacketConfig = PacketConfig()):
        self.config = c = config
        if config.ccsds_interleaver not in ("block", "conv"):
            raise ValueError(
                f"unknown ccsds_interleaver {config.ccsds_interleaver!r}"
            )
        if config.ccsds_interleaver == "conv" and config.ccsds_interleave_rows < 1:
            # the block path clamps rows with max(1, ...) but the Forney
            # path uses the raw value as the branch count — 0 would surface
            # as an n % 0 ZeroDivisionError deep in conv_interleave_block
            # (advisor finding r4)
            raise ValueError(
                "ccsds_interleaver='conv' needs ccsds_interleave_rows >= 1, "
                f"got {config.ccsds_interleave_rows}"
            )
        if config.polar_decoder not in ("scl", "bp"):
            # a typo ("BP", "scl ") would otherwise silently select SCL
            # and invalidate any throughput comparison (review finding r4)
            raise ValueError(
                f"unknown polar_decoder {config.polar_decoder!r} "
                "(expected 'scl' or 'bp')"
            )
        # fec="ccsds" + rs_erasures engages the SOFT-OUTPUT inner decoder
        # (ops/fec.conv_decode_soft max-log BCJR): the outer RS then sees
        # genuine per-bit reliabilities, so the erasure heuristic can flag
        # the inner decoder's characteristic burst errors. (The r3 advisor
        # finding — hard Viterbi bits give every symbol identical |LLR|,
        # silently disabling erasures — was first fixed by rejecting the
        # combination; round 4 made it functional instead.)
        self.modulation = _modulation_by_name(c.modulation)
        bps = self.modulation.bits_per_symbol
        # ---- static frame arithmetic
        self.frame_bits = c.payload_bits + c.crc_width
        if c.fec == "viterbi":
            self.coded_bits = 2 * (self.frame_bits + _fec.DEFAULT_K - 1)
        elif c.fec in ("ldpc", "ldpc11n"):
            # "ldpc" = Gallager random-regular ensemble; "ldpc11n" = the
            # IEEE 802.11n n=648 Z=27 rate-1/2 QC-LDPC standard code
            # (codeword-level interoperable with compliant receivers)
            if c.fec == "ldpc11n":
                h, g, info = _ldpc.wifi_ldpc()
                # QC edge-message decoder: bit-identical to the dense
                # plane
                self._ldpc_qc = (_ldpc._WIFI_648_R12, 27)
            elif c.ldpc_file is not None:
                from ..ops import code_io as _cio

                h, g, info = _cio.ldpc_from_file(c.ldpc_file)
                if str(c.ldpc_file).endswith(".npz"):
                    # QC tables keep the fast edge-message decoder
                    self._ldpc_qc = _cio.load_qc_npz(c.ldpc_file)
                else:
                    self._ldpc_qc = None
            else:
                h, g, info = _ldpc.make_regular_ldpc(seed=c.ldpc_seed)
                self._ldpc_qc = None
            self._ldpc = (h, g, info)
            k = g.shape[0]
            self.ldpc_frames = -(-self.frame_bits // k)
            self.ldpc_pad = self.ldpc_frames * k - self.frame_bits
            self.coded_bits = self.ldpc_frames * h.shape[1]
        elif c.fec in ("rs", "ccsds"):
            # byte-oriented: frame bits pad to whole GF(2^8) symbols, then
            # to whole RS(rs_n, rs_k) codewords
            self._rs = _rs.ReedSolomon(c.rs_n, c.rs_k)
            frame_bytes = -(-self.frame_bits // 8)
            self.rs_frames = -(-frame_bytes // c.rs_k)
            self.rs_pad_bits = self.rs_frames * c.rs_k * 8 - self.frame_bits
            rs_bits = self.rs_frames * c.rs_n * 8
            if c.fec == "ccsds":
                # inner interleave (pad to whole rows) + conv rate 1/2
                rows = max(1, c.ccsds_interleave_rows)
                if c.ccsds_interleaver == "conv":
                    # symbol-level Forney: whole 8-bit symbols, count
                    # divisible by the branch count
                    self.ccsds_pad = (-rs_bits) % (8 * rows)
                else:
                    self.ccsds_pad = (-rs_bits) % rows
                self.coded_bits = 2 * (
                    rs_bits + self.ccsds_pad + _fec.DEFAULT_K - 1
                )
            else:
                self.coded_bits = rs_bits
        elif c.fec == "bch":
            self._bch = _bch.BCH(c.bch_n, c.bch_t)
            kb = self._bch.k
            self.bch_frames = -(-self.frame_bits // kb)
            self.bch_pad = self.bch_frames * kb - self.frame_bits
            self.coded_bits = self.bch_frames * c.bch_n
        elif c.fec == "tpc":
            self._tpc = _tpc.TPC(m=c.tpc_m, p=c.tpc_p, iters=c.tpc_iters,
                                 t_component=c.tpc_t)
            kb = self._tpc.k * self._tpc.k
            self.tpc_frames = -(-self.frame_bits // kb)
            self.tpc_pad = self.tpc_frames * kb - self.frame_bits
            self.coded_bits = self.tpc_frames * self._tpc.n * self._tpc.n
        elif c.fec == "nr_ldpc":
            from ..ops.nr_ldpc import LIFTING_SIZES, NrLdpc, _BG_DIMS

            kb = _BG_DIMS[c.nr_bg][2]
            fits = [s for s in LIFTING_SIZES if kb * s >= self.frame_bits]
            if not fits:
                raise ValueError(
                    f"frame of {self.frame_bits} bits exceeds one BG"
                    f"{c.nr_bg} codeword (max {kb * max(LIFTING_SIZES)}); "
                    "segment the transport block first"
                )
            nr_base = None
            if c.nr_base_graph_file is not None:
                from ..ops import code_io as _cio

                nr_base = _cio.nr_base_graph_from_file(c.nr_base_graph_file)
            self._nr = NrLdpc(z=min(fits), bg=c.nr_bg, k=self.frame_bits,
                              base_graph=nr_base)
            self.coded_bits = int(round(self.frame_bits / c.nr_rate))
        elif c.fec == "turbo":
            # [sys n | par1 n | par2 n | tail_sys 3 | tail_par 3]
            self.coded_bits = 3 * self.frame_bits + 6
        elif c.fec == "polar":
            self._polar = _polar.PolarCode(
                n=c.polar_n,
                k=c.polar_n // 2,
                design_snr_db=c.polar_design_snr_db,
                crc="crc8" if c.polar_list > 1 else "",
                list_size=c.polar_list,
            )
            bpf = self._polar.payload_bits
            self.polar_frames = -(-self.frame_bits // bpf)
            self.polar_pad = self.polar_frames * bpf - self.frame_bits
            self.coded_bits = self.polar_frames * c.polar_n
        elif c.fec == "none":
            self.coded_bits = self.frame_bits
        else:
            raise ValueError(f"unknown fec {c.fec!r}")
        rows = c.interleave_rows
        self.inter_pad = 0 if rows <= 1 else (-self.coded_bits) % rows
        line_bits = self.coded_bits + self.inter_pad
        self.mod_pad = (-line_bits) % bps
        self.n_data_symbols = (line_bits + self.mod_pad) // bps
        # ---- preamble: Gold QPSK, two identical halves. Constructed in
        # HOST numpy: the preamble is a trace-time constant, so building
        # it costs no device dispatch at construction.
        pre_bits = np.asarray(
            _seq.lte_gold(c.preamble_cinit, 2 * c.preamble_half)
        )
        qtab = np.asarray(_mod.qpsk().table, dtype=np.complex64)
        grouped = pre_bits.reshape(-1, 2).astype(np.int64)
        idx = grouped[:, 0] + 2 * grouped[:, 1]  # LSB-first packing
        half = qtab[idx]
        self.preamble = np.concatenate([half, half])
        self.burst_len = self.preamble.size + self.n_data_symbols

    # ------------------------------------------------------------ TX

    def tx(self, payload) -> jnp.ndarray:
        c = self.config
        bits = jnp.asarray(payload).astype(jnp.uint8) % 2
        if bits.shape[-1] != c.payload_bits:
            raise ValueError(
                f"payload must be {c.payload_bits} bits, got {bits.shape[-1]}"
            )
        frame = _fec.crc_append(bits, c.crc)
        line = _seq.scramble_multiplicative(frame, c.scrambler)
        if c.fec == "viterbi":
            coded = _fec.conv_encode(line)
        elif c.fec in ("ldpc", "ldpc11n"):
            h, g, info = self._ldpc
            padded = jnp.concatenate(
                [line, jnp.zeros(self.ldpc_pad, jnp.uint8)]
            ).reshape(self.ldpc_frames, -1)
            coded = _ldpc.ldpc_encode(padded, g).reshape(-1)
        elif c.fec in ("rs", "ccsds"):
            padded = jnp.concatenate(
                [line, jnp.zeros(self.rs_pad_bits, jnp.uint8)]
            )
            syms = _rs.bits_to_symbols(padded).reshape(self.rs_frames, c.rs_k)
            coded = _rs.symbols_to_bits(self._rs.encode(syms)).reshape(-1)
            if c.fec == "ccsds":
                inner = jnp.concatenate(
                    [coded, jnp.zeros(self.ccsds_pad, jnp.uint8)]
                )
                inner = self._ccsds_ilv(inner)
                coded = _fec.conv_encode(inner)
        elif c.fec == "bch":
            padded = jnp.concatenate(
                [line, jnp.zeros(self.bch_pad, jnp.uint8)]
            ).reshape(self.bch_frames, -1)
            coded = self._bch.encode(padded).reshape(-1)
        elif c.fec == "tpc":
            kk = self._tpc.k
            padded = jnp.concatenate(
                [line, jnp.zeros(self.tpc_pad, jnp.uint8)]
            ).reshape(self.tpc_frames, kk, kk)
            coded = self._tpc.encode(padded).reshape(-1)
        elif c.fec == "nr_ldpc":
            coded = self._nr.encode(line, self.coded_bits, rv=c.nr_rv)
        elif c.fec == "turbo":
            sys_b, p1, p2, ts_b, tp_b = _turbo.turbo_encode(line)
            coded = jnp.concatenate([sys_b, p1, p2, ts_b, tp_b])
        elif c.fec == "polar":
            padded = jnp.concatenate(
                [line, jnp.zeros(self.polar_pad, jnp.uint8)]
            ).reshape(self.polar_frames, -1)
            coded = self._polar.encode(padded).reshape(-1)
        else:
            coded = line
        if self.inter_pad or c.interleave_rows > 1:
            coded = jnp.concatenate(
                [coded, jnp.zeros(self.inter_pad, jnp.uint8)]
            )
            coded = _fec.interleave(coded, c.interleave_rows)
        if self.mod_pad:
            coded = jnp.concatenate([coded, jnp.zeros(self.mod_pad, jnp.uint8)])
        symbols = self.modulation.modulate(coded)
        return jnp.concatenate([jnp.asarray(self.preamble), symbols]).astype(cf32)

    # ------------------------------------------------------------ RX

    def rx(self, capture):
        """Decode a capture containing one burst. Returns ``(payload,
        crc_ok, diag)``; ``diag`` is a dict of device scalars."""
        llr, diag = self._rx_front(capture)
        line = self._decode_llr(llr)
        payload, ok = self._rx_tail(line)
        return payload, ok, diag

    def _rx_front(self, capture):
        """Acquisition → CFO → equalize → soft demod → deinterleave: one
        capture to coded-bit LLRs ``[coded_bits]`` plus the diag dict."""
        c = self.config
        x = jnp.asarray(capture, dtype=cf32)
        npre = self.preamble.size
        offset, metric = _sync.detect_preamble(x, self.preamble)
        offset = jnp.clip(offset, 0, x.shape[-1] - self.burst_len)
        burst = jax.lax.dynamic_slice(x, (offset,), (self.burst_len,))
        # CFO off the repeated preamble halves, then correct the burst
        cfo = _sync.estimate_cfo(burst, c.preamble_half)
        burst = _sync.apply_freq_shift(burst, cfo)
        # complex gain + noise variance off the (now derotated) preamble
        pre = jnp.asarray(self.preamble)
        rx_pre = burst[:npre]
        gain = jnp.sum(rx_pre * jnp.conj(pre)) / jnp.sum(jnp.abs(pre) ** 2)
        eq = burst[npre:] / gain
        resid = rx_pre / gain - pre
        noise_var = jnp.maximum(jnp.mean(jnp.abs(resid) ** 2), 1e-6)
        # Fine carrier polish (blind, M-PSK payloads): the preamble-only
        # CFO estimate has std ~1e-4 cycles/sample, which winds a large
        # fraction of a radian over a ~1000-symbol burst and erodes the
        # tail LLRs. estimate_cfo_blind reads the residual off the
        # periodogram of eq^M (full coherent integration — the lag-1
        # variant is too noisy at link SNRs), and estimate_phase_mpsk
        # fixes the leftover constant phase. Safe against the 2*pi/M
        # ambiguity because the coarse stage leaves well under pi/M of
        # accumulated error near the preamble anchor.
        fine = jnp.float32(0.0)
        if self.modulation.bits_per_symbol <= 2:
            m_fold = 2 ** self.modulation.bits_per_symbol
            fine = _sync.estimate_cfo_blind(eq, m_fold)
            eq = _sync.apply_freq_shift(eq, fine)
            phi = _sync.estimate_phase_mpsk(eq, m_fold)
            rot = jax.lax.complex(jnp.cos(-phi), jnp.sin(-phi))
            eq = eq * rot
        # soft demod -> de-interleave -> decode -> descramble -> CRC
        llr = self.modulation.demod_soft(eq, noise_var)
        if self.mod_pad:
            llr = llr[: llr.shape[-1] - self.mod_pad]
        if self.inter_pad or c.interleave_rows > 1:
            llr = _fec.deinterleave(llr, c.interleave_rows)
            llr = llr[: self.coded_bits]
        diag = {
            "offset": offset,
            "metric": metric,
            "cfo": cfo + fine,
            "gain": gain,
            "noise_var": noise_var,
        }
        return llr, diag

    def _decode_llr(self, llr):
        """Coded-bit LLRs → descramble-ready line bits. The ``viterbi``,
        ``turbo``, ``rs`` and ``ccsds`` branches accept LEADING BATCH
        AXES (their serial-trellis decoders batch natively with the
        batch on the minor axis — :meth:`rx_batch` routes them around
        ``vmap``); the other branches are single-burst (``rx_batch``
        vmaps them: their decoders are plane-shaped and batch fine
        under vmap)."""
        c = self.config
        if c.fec == "viterbi":
            line = _fec.viterbi_decode(llr)
        elif c.fec in ("ldpc", "ldpc11n"):
            h, g, info = self._ldpc
            lead = llr.shape[:-1]
            frames = llr.reshape(lead + (self.ldpc_frames, -1))
            if self._ldpc_qc is not None:
                base, zf = self._ldpc_qc
                hard, _ok = _ldpc.qc_ldpc_decode(frames, base, zf, iters=30)
            else:
                hard, _ok = _ldpc.ldpc_decode(frames, h, iters=30)
            line = _ldpc.extract_info(hard, info).reshape(
                lead + (-1,)
            )[..., : self.frame_bits]
        elif c.fec in ("rs", "ccsds"):
            lead = llr.shape[:-1]
            if c.fec == "ccsds":
                # inner decode (soft in) -> deinterleave -> outer RS:
                # the deinterleaver scatters the inner decoder's burst
                # errors across RS codeword symbols. Inner decoders run
                # WINDOWED (round 5): batched throughput needs the scan
                # length bounded (T -> window + 2*guard with the windows
                # batched), and the
                # generous guards keep the survivor/metric merge exact on
                # the operating channels (sign-identical in tests; the
                # outer RS + CRC guard any window-seam residue either way)
                rs_len = self.rs_frames * c.rs_n * 8
                if c.rs_erasures:
                    # max-log BCJR: per-bit a-posteriori LLRs survive to
                    # the RS stage, so low-|LLR| symbols (the fade/burst
                    # footprint) can be flagged as erasures below
                    inner_llr = _fec.conv_decode_soft(
                        llr, window=96, guard=64
                    )
                    inner_llr = self._ccsds_dilv(inner_llr)
                    llr = inner_llr[..., :rs_len]
                    hard = (llr < 0).astype(jnp.uint8)
                else:
                    inner_bits = _fec.viterbi_decode(
                        llr, window=64, guard=48
                    )
                    inner_bits = self._ccsds_dilv(inner_bits)
                    hard = inner_bits[..., :rs_len]
                    llr = _fec.hard_to_llr(hard)
            else:
                hard = (llr < 0).astype(jnp.uint8)  # RS decodes hard symbols
            syms = _rs.bits_to_symbols(hard).reshape(
                lead + (self.rs_frames, c.rs_n)
            )
            if c.rs_erasures:
                rel = jnp.min(
                    jnp.abs(llr).reshape(
                        lead + (self.rs_frames, c.rs_n, 8)
                    ),
                    axis=-1,
                )
                med = jnp.median(rel, axis=-1, keepdims=True)
                erased = rel < c.rs_erasure_threshold * med
                dec, _rs_ok, _ = self._rs.decode_erasures(syms, erased)
            else:
                dec, _rs_ok, _ = self._rs.decode(syms)
            line = _rs.symbols_to_bits(dec).reshape(
                lead + (-1,)
            )[..., : self.frame_bits]
        elif c.fec == "bch":
            frames = llr.reshape(self.bch_frames, -1)
            if c.bch_chase > 0:
                dec, _bok = self._bch.decode_soft(frames, p=c.bch_chase)
            else:  # binary BCH decodes hard bits
                hard = (frames < 0).astype(jnp.uint8)
                dec, _bok, _ = self._bch.decode(hard)
            line = dec.reshape(-1)[: self.frame_bits]
        elif c.fec == "tpc":
            nn = self._tpc.n
            dec, _tok = self._tpc.decode(
                llr.reshape(self.tpc_frames, nn, nn)
            )
            line = dec.reshape(-1)[: self.frame_bits]
        elif c.fec == "nr_ldpc":
            dec, _nok = self._nr.decode(llr, rv=c.nr_rv, iters=30)
            line = dec[: self.frame_bits]
        elif c.fec == "polar":
            frames = llr.reshape(self.polar_frames, -1)
            if c.polar_decoder == "bp":
                dec, _pok = self._polar.decode_bp(frames)
            else:
                dec, _pok = self._polar.decode(frames)
            line = dec.reshape(-1)[: self.frame_bits]
        elif c.fec == "turbo":
            nb = self.frame_bits
            line, _l = _turbo.turbo_decode(
                llr[..., :nb],
                llr[..., nb : 2 * nb],
                llr[..., 2 * nb : 3 * nb],
                llr[..., 3 * nb : 3 * nb + 3],
                llr[..., 3 * nb + 3 :],
                iterations=8,
                window=64,  # parallel BCJR
                guard=16,
            )
        else:
            line = (llr < 0).astype(jnp.uint8)
        return line

    def _rx_tail(self, line):
        """Line bits → descramble → CRC verdict (one burst)."""
        c = self.config
        frame = _seq.descramble_multiplicative(line, c.scrambler)
        ok = _fec.crc_check(frame, c.crc)
        return frame[: c.payload_bits], ok

    def rx_batch(self, captures):
        """Batched burst RX: decode ``[B, window]`` captures in ONE jittable
        graph — returns ``(payloads [B, payload_bits], crc_ok [B],
        diag)`` with every diag entry a ``[B]`` vector.

        The throughput form of burst reception: the per-burst :meth:`rx`
        is a *latency* path (one acquisition + one decode per call) while
        every decoder underneath already batches over leading axes.
        ``vmap`` lifts the
        whole acquire -> CFO -> equalize -> demod -> decode graph onto the
        batch axis, so the Viterbi/BCJR/min-sum scans execute once over
        ``[B, ...]`` planes — per-burst *throughput* amortizes every
        serial trellis/BP step across the batch, which is exactly the
        reference's pipeline-throughput ethos
        (/root/reference/src/pipeline.rs:100-107) applied to the burst
        link. Bit-identical to calling :meth:`rx` per window (tested).
        """
        x = jnp.asarray(captures, dtype=cf32)
        if x.ndim != 2:
            raise ValueError(
                f"rx_batch takes [B, window] captures, got shape {x.shape}"
            )
        if self.config.fec in ("viterbi", "turbo", "rs", "ccsds",
                               "ldpc", "ldpc11n"):
            # serial-trellis FECs: route the decode AROUND vmap so it
            # runs natively batched (turbo: the batch-minor BCJR layout)
            # — vmap would pin the batch to axis 0. Bit-identical to the
            # per-burst path either way (tested).
            llr, diag = jax.vmap(self._rx_front)(x)
            line = self._decode_llr(llr)
            payload, ok = jax.vmap(self._rx_tail)(line)
            return payload, ok, diag
        return jax.vmap(self.rx)(x)

    def rx_batch_sharded(self, captures, mesh, axis_name: str = "channel"):
        """:meth:`rx_batch` with the BURST axis sharded over ``mesh`` —
        the multi-chip burst link: each device decodes its ``B / n_dev``
        captures (pure data parallel; bursts are independent), scaling
        the batched-throughput numbers linearly over the pod. ``B`` must
        divide by the mesh axis size. Identical results to
        :meth:`rx_batch` (tested)."""
        x = jnp.asarray(captures, dtype=cf32)
        if x.ndim != 2:
            raise ValueError(
                f"rx_batch_sharded takes [B, window] captures, got {x.shape}"
            )
        n_dev = mesh.shape[axis_name]
        if x.shape[0] % n_dev:
            raise ValueError(
                f"{x.shape[0]} bursts do not divide over {n_dev} devices"
            )
        p = jax.sharding.PartitionSpec
        # check_vma=False: the decoders' scan carries initialize from
        # trace constants (unvarying) and become device-varying through
        # the body — fine for a pure data-parallel region (no collectives
        # anywhere in the burst graph), but the varying-axis checker
        # would demand pcasts at every scan in every decoder
        fn = jax.shard_map(
            self.rx_batch,
            mesh=mesh,
            in_specs=p(axis_name, None),
            out_specs=(p(axis_name), p(axis_name), p(axis_name)),
            check_vma=False,
        )
        return fn(x)

    def loopback(self, payload):
        """tx -> rx with no channel (sanity path)."""
        return self.rx(self.tx(payload))
