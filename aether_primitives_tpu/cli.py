"""Console entry points: the headline chain bench and the criterion-equivalent
micro-benchmark suite (reference benches/benches.rs:1-424).

Installed as ``aether-bench`` / ``aether-microbench`` (pyproject.toml); the
repo-root ``bench.py`` and ``benches/microbench.py`` are thin shims over
these so both paths share one implementation.

Both measure a GPU and fail when ``jax.devices()[0]`` is not one, unless
``--cpu`` asks for the CPU explicitly. Timing methodology:

- device-resident input blocks;
- completion is forced by fetching a tiny jitted digest of the output to
  the host;
- the **marginal-cost** estimator ``(T(k2) - T(k1)) / (k2 - k1)`` cancels
  the fixed host-sync overhead;
- a ``t2 <= t1`` or sub-resolution span is a MEASUREMENT FAILURE, not a
  result: the harness escalates iteration counts until the span clears a
  noise floor, and ops that never clear it are reported as "below the
  dispatch floor" with an upper bound instead of a fabricated throughput.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

#: Published peak rates keyed by ``jax.Device.device_kind``. A device that
#: is not listed has no peak: :func:`device_peak` raises instead of guessing.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM5 part",
    },
}

#: The RX chain's correctness contract: demod bit agreement with the float64
#: reference, and the reference's assert_evm default on the block-2 spectrum.
GATE_BIT_AGREEMENT = 0.99999
GATE_EVM_DB = -80.0

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: a fixed path inside the checkout, because the path is part of the key.
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache():
    """Point JAX's persistent compile cache at a fixed directory.

    Respects ``JAX_COMPILATION_CACHE_DIR`` (JAX reads it itself, so nothing
    is set here and None is returned); otherwise uses
    :data:`DEFAULT_COMPILE_CACHE` and returns it."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_COMPILE_CACHE))
    return DEFAULT_COMPILE_CACHE


def device_peak(kind: str) -> dict:
    """The :data:`DEVICE_PEAKS` entry for a ``device_kind``; raises for an
    unknown device rather than assuming a peak."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peak for device kind {kind!r}; add it to "
            "DEVICE_PEAKS with its source"
        ) from None


def require_gpu(jax_mod, allow_cpu: bool):
    """The first device, which must be a GPU unless ``allow_cpu``."""
    dev = jax_mod.devices()[0]
    if dev.platform != "gpu" and not allow_cpu:
        raise SystemExit(
            f"no GPU found (jax.devices()[0] is {dev.platform!r}: "
            f"{dev.device_kind}); pass --cpu to measure the CPU"
        )
    return dev


class _Digest:
    """Per-output-structure jitted digests forcing completion via host fetch."""

    def __init__(self):
        self._cache = {}

    def __call__(self, out) -> float:
        import jax
        import jax.numpy as jnp

        leaves = jax.tree_util.tree_leaves(out)
        key = tuple((l.shape, str(l.dtype)) for l in leaves)
        f = self._cache.get(key)
        if f is None:
            def _d(x):
                ls = jax.tree_util.tree_leaves(x)
                return sum(jnp.sum(l.astype(jnp.float32).ravel()[:256]) for l in ls)
            f = jax.jit(_d)
            self._cache[key] = f
        return float(np.asarray(f(out)))


def marginal_cost(run, k1: int, k2: int, *, reps: int = 2,
                  max_escalations: int = 3, min_rel_span: float = 0.05):
    """Per-iteration cost via ``(T(k2)-T(k1))/(k2-k1)`` with noise guards.

    ``run(k)`` executes the op ``k`` times and returns wall seconds including
    one fixed sync. Escalates (k1, k2) up to ``max_escalations`` times when
    the span ``T(k2)-T(k1)`` is non-positive or below ``min_rel_span * T(k1)``
    (i.e. indistinguishable from sync jitter).

    Returns ``(dt_seconds | None, floor_seconds)``: ``dt_seconds`` is None
    when the op never cleared the noise floor, in which case
    ``floor_seconds`` is an upper bound on the per-call cost (the smallest
    resolvable span divided by the largest iteration delta tried).
    """
    floor = float("inf")
    for _ in range(max_escalations + 1):
        t1 = min(run(k1) for _ in range(reps))
        t2 = min(run(k2) for _ in range(reps))
        span = t2 - t1
        floor = min(floor, max(abs(span), 0.05 * t1, 1e-4) / (k2 - k1))
        if span > 0 and span >= min_rel_span * t1:
            return span / (k2 - k1), floor
        k1, k2 = k1 * 4, k2 * 4
    return None, floor


def _plausible(dt: float, samples: int, peak_bytes_per_s: float) -> bool:
    """False when ``samples`` in ``dt`` seconds implies more than twice the
    device's peak memory rate — a timing artifact, not a measurement.
    c64 in + out is 16 bytes/sample; the factor 2 leaves room for rows
    whose fused graphs move less than that."""
    return samples * 16.0 / dt <= 2.0 * peak_bytes_per_s


def microbench_main(argv=None):
    ap = argparse.ArgumentParser(prog="aether-microbench", description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=3,
                    help="marginal-cost rounds per row (best is kept)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    from aether_primitives_tpu.boundary import Split, f32_boundary
    from aether_primitives_tpu.ops import fir, modulation, sampling, vecops
    from aether_primitives_tpu.ops.fft import Scale, plan as fft_plan

    dev = require_gpu(jax, args.cpu)
    platform = dev.platform
    peak = None if args.cpu else device_peak(dev.device_kind)["hbm_bytes_per_s"]
    rng = np.random.default_rng(815)
    results = []
    digest = _Digest()

    def timed(name, fn, blk, samples, iters=args.iters):
        fn = jax.jit(fn)
        blk = jax.device_put(blk, dev)
        out = fn(blk)
        jax.block_until_ready(out)
        digest(out)

        def run(k):
            t0 = time.perf_counter()
            o = None
            for _ in range(k):
                o = fn(blk)
            digest(o)
            return time.perf_counter() - t0

        run(2)
        # best of N marginal-cost rounds; every round's estimate is
        # recorded so the artifact carries its own dispersion
        dt, floor, round_est = None, float("inf"), []
        for _ in range(max(1, args.rounds)):
            dt_i, floor_i = marginal_cost(run, max(2, iters // 5), iters)
            floor = min(floor, floor_i)
            if dt_i is not None:
                round_est.append(dt_i)
                dt = dt_i if dt is None else min(dt, dt_i)
        if dt is None or (peak is not None and not _plausible(dt, samples, peak)):
            results.append({
                "bench": name, "us_per_call": None, "msamples_per_s": None,
                "floor_us_per_call": floor * 1e6,
                "note": "below dispatch/timing floor; throughput not resolvable",
            })
            print(f"{name:42s} < {floor*1e6:8.1f} us/call (below dispatch floor)",
                  flush=True)
            return
        msps = samples / dt / 1e6
        spread = max(round_est) / min(round_est) if len(round_est) > 1 else 1.0
        row = {
            "bench": name, "us_per_call": dt * 1e6,
            "msamples_per_s": msps,
            "rounds_us_per_call": [r * 1e6 for r in round_est],
            "round_spread": spread,
        }
        results.append(row)
        print(f"{name:42s} {dt*1e6:10.1f} us/call {msps:12.0f} Msamples/s"
              + (f"  (spread {spread:.2f}x/{len(round_est)}r)"
                 if spread > 1.5 else ""),
              flush=True)

    def rsplit(shape):
        return Split(
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
        )

    B = args.batch

    # vecops @ N=2048 (reference benches/benches.rs:28-70)
    n = 2048
    two = rsplit((B, n))
    timed("vecops mul [batch x 2048]", f32_boundary(lambda x: vecops.mul(x, x)), two, B * n)
    timed("vecops scale [batch x 2048]", f32_boundary(lambda x: vecops.scale(x, 2.0)), two, B * n)
    timed("vecops conj+mirror [batch x 2048]", f32_boundary(lambda x: vecops.mirror(vecops.conj(x))), two, B * n)

    # interpolate / downsample (reference benches/benches.rs:72-133)
    timed(
        "interpolate (1024,4) [batch]",
        f32_boundary(lambda x: sampling.interpolate(x, 4)),
        rsplit((B, 1024)),
        B * 1024,
    )
    timed(
        "downsample 30720->1024 [batch]",
        f32_boundary(lambda x: sampling.downsample(x, 1024)),
        rsplit((B // 8 or 1, 30720)),
        (B // 8 or 1) * 30720,
    )

    # modulation (reference benches/benches.rs:192-281)
    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, (B, 8000)).astype(np.uint8)
    timed("qpsk modulate 8000 bits [batch]", lambda b: qpsk.modulate(b), bits, B * 8000)
    syms = rsplit((B, 4000))
    timed("qpsk demod 4000 syms [batch]", f32_boundary(lambda s: qpsk.demod(s)), syms, B * 4000)
    bpsk = modulation.bpsk()
    timed("bpsk modulate 8000 bits [batch]", lambda b: bpsk.modulate(b), bits, B * 8000)

    # FFT fwd/bwd (reference benches/benches.rs:288-380)
    for nfft in (512, 1024, 2048):
        p = fft_plan(nfft)
        blk = rsplit((B, nfft))
        timed(f"fft {nfft} fwd SN [batch]", f32_boundary(lambda x, p=p: p.fwd(x, Scale.SN)), blk, B * nfft)
        timed(f"fft {nfft} bwd SN [batch]", f32_boundary(lambda x, p=p: p.bwd(x, Scale.SN)), blk, B * nfft)

    # freq-domain correlator (reference benches/benches.rs:382-423)
    for nfft in (512, 1024, 2048):
        sig_c = rsplit((nfft,)).numpy()  # host numpy complex: trace constant
        blk = rsplit((B, nfft))
        timed(
            f"correlator {nfft} [batch]",
            f32_boundary(lambda x, s=sig_c: fir.correlate(x, s)),
            blk,
            B * nfft,
        )

    # framework extensions beyond the criterion surface: the front-end
    # mixer and the fused DDC core (mix -> lowpass -> /8)
    from aether_primitives_tpu.models.ddc import DdcConfig
    from aether_primitives_tpu.ops import frontend

    nddc = B * 2048
    ddc_taps = DdcConfig(decimation=8).resolved_taps()
    one = rsplit((nddc,))
    timed(
        "nco mix [flat]",
        f32_boundary(lambda x: frontend.nco_mix(x, 0.1375)),
        one, nddc,
    )
    timed(
        "ddc core: mix+fir129+/8 [flat]",
        f32_boundary(
            lambda x: fir.fir_filter_os_decimate(
                frontend.nco_mix(x, 0.1375), ddc_taps, 8
            )
        ),
        one, nddc,
    )

    # round-2 extensions: channel coding, acquisition, spread spectrum
    from aether_primitives_tpu.models.caf import ambiguity
    from aether_primitives_tpu.models.css import CssConfig, CssModem
    from aether_primitives_tpu.ops import fec as _fec
    from aether_primitives_tpu.ops import ldpc as _ldpc

    h_pc, _g, _info = _ldpc.make_regular_ldpc(648, 3, 6, seed=7)
    nfr = max(B // 16, 1)
    llr_blk = rng.normal(size=(nfr, 648)).astype(np.float32) * 4.0
    timed(
        f"ldpc min-sum 25 iters [{nfr} x 648]",
        lambda l: _ldpc.ldpc_decode(l, h_pc, iters=25)[0],
        llr_blk,
        nfr * 648,
    )
    h_11n, _g11, _i11 = _ldpc.wifi_ldpc()
    timed(
        f"ldpc 802.11n(648,R1/2) min-sum 25 it [{nfr} cw]",
        lambda l: _ldpc.ldpc_decode(l, h_11n, iters=25)[0],
        llr_blk,
        nfr * 648,
    )
    timed(
        f"ldpc 802.11n QC edge decoder 25 it [{nfr} cw]",
        lambda l: _ldpc.qc_ldpc_decode(l, _ldpc._WIFI_648_R12, 27, iters=25)[0],
        llr_blk,
        nfr * 648,
    )

    vb_bits = rng.integers(0, 2, (nfr, 1024)).astype(np.uint8)
    vb_coded = np.stack(
        [np.asarray(_fec.conv_encode(vb_bits[i])) for i in range(nfr)]
    )
    vb_llr = (4.0 * (1.0 - 2.0 * vb_coded.astype(np.float32))).astype(np.float32)
    timed(
        f"viterbi K=7 decode [{nfr} x 1024 bits]",
        _fec.viterbi_decode,  # natively batched
        vb_llr,
        nfr * 1024,
        iters=10,
    )

    css = CssModem(CssConfig(sf=10))
    n_css = B * 1024
    timed(
        "css demod SF10 [flat]",
        f32_boundary(lambda x: css.demod_symbols(x)[0]),
        rsplit((n_css,)),
        n_css,
    )

    ref_caf = rsplit((4096,)).numpy()
    dops = np.linspace(-1e-3, 1e-3, 64).astype(np.float32)
    timed(
        "caf 64 dopplers x 4096",
        f32_boundary(lambda x: ambiguity(x, ref_caf, dops)),
        rsplit((4096,)),
        64 * 4096,
    )

    crc_bits_in = rng.integers(0, 2, 1 << 20).astype(np.uint8)
    timed(
        "crc32 2^20 bits",
        lambda b: _fec.crc_compute(b, 0x04C11DB7, 32, 0xFFFFFFFF),
        crc_bits_in,
        1 << 20,
    )

    # Reed-Solomon (samples = GF(2^8) symbols = bytes)
    from aether_primitives_tpu.ops.rs import rs_255_223

    rs_code = rs_255_223()
    nrs = max(B // 4, 1)
    rs_msgs = rng.integers(0, 256, (nrs, 223)).astype(np.uint8)
    timed(
        f"rs(255,223) encode [{nrs} cw]",
        lambda m: rs_code.encode(m),
        rs_msgs,
        nrs * 223,
    )
    rs_cws = np.asarray(rs_code.encode(rs_msgs)).copy()
    for row in rs_cws:  # full-t error load
        row[rng.choice(255, 16, replace=False)] ^= rng.integers(1, 256, 16).astype(np.uint8)
    timed(
        f"rs(255,223) decode t=16 errs [{nrs} cw]",
        lambda c: rs_code.decode(c)[0],
        rs_cws,
        nrs * 255,
    )

    # turbo decode — BATCHED over codewords natively (turbo_decode takes
    # [..., n]; its BCJR layout puts the batch on the minor axis, which a
    # vmapped per-codeword call cannot)
    from aether_primitives_tpu.ops.turbo import turbo_decode, turbo_encode

    ntb, nblk = 1024, max(B // 16, 1)
    tb_bits = rng.integers(0, 2, (nblk, ntb)).astype(np.uint8)
    enc = [np.stack(x) for x in zip(*(
        [np.asarray(v) for v in turbo_encode(tb_bits[i])] for i in range(nblk)
    ))]

    def _tb_llr(b):
        return (8.0 * (1.0 - 2.0 * b.astype(np.float32))).astype(np.float32)

    tb_args = tuple(_tb_llr(v) for v in enc)
    timed(
        f"turbo decode 8 iters win64 [{nblk} x {ntb} bits]",
        lambda t: turbo_decode(*t, iterations=8, window=64, guard=16)[0],
        tb_args,
        nblk * ntb,
        iters=10,
    )

    # polar decode — batched, like turbo: SC is serial over bit indices,
    # so throughput comes from the codeword batch axis
    from aether_primitives_tpu.ops import polar as _polar

    def _np_polar_encode(u):
        x, step = u.copy(), 1
        while step < u.shape[-1]:
            b = x.reshape(x.shape[:-1] + (-1, 2, step))
            b[..., 0, :] ^= b[..., 1, :]
            x = b.reshape(x.shape)
            step *= 2
        return x

    npo, kpo, nblk_po = 1024, 512, max(B // 16, 1)
    po_mask = _polar.polar_construct(npo, kpo, design_snr_db=1.0)
    po_u = np.zeros((nblk_po, npo), np.uint8)
    po_u[:, np.where(po_mask)[0]] = rng.integers(0, 2, (nblk_po, kpo)).astype(np.uint8)
    po_llr = (8.0 * (1.0 - 2.0 * _np_polar_encode(po_u))).astype(np.float32)
    timed(
        f"polar SC decode (1024,512) [{nblk_po} cw]",
        lambda l: _polar.polar_decode(l, po_mask),
        po_llr,
        nblk_po * kpo,
        iters=10,
    )
    scl_code = _polar.PolarCode(n=256, k=128, crc="crc8", list_size=8)
    scl_bits = rng.integers(0, 2, (nblk_po, scl_code.payload_bits)).astype(np.uint8)
    scl_x = np.asarray(jax.jit(scl_code.encode)(scl_bits))
    scl_llr = (8.0 * (1.0 - 2.0 * scl_x)).astype(np.float32)
    timed(
        f"polar CA-SCL L=8 (256,128+crc8) [{nblk_po} cw]",
        lambda l: scl_code.decode(l)[0],
        scl_llr,
        nblk_po * scl_code.payload_bits,
        iters=10,
    )

    # spectral-processing pair and the truncated-IR IIR
    from aether_primitives_tpu.models.channelizer import istft, stft
    from aether_primitives_tpu.ops.iir import butter_sos, sosfilt

    nsp = B * 1024
    timed(
        "stft+istft 1024/512 [flat]",
        f32_boundary(lambda x: istft(stft(x, 1024), length=nsp)),
        rsplit((nsp,)),
        nsp,
    )
    sos4 = butter_sos(4, 0.1)
    timed(
        "iir sosfilt butter4 [flat]",
        f32_boundary(lambda x: sosfilt(sos4, x)),
        rsplit((nsp,)),
        nsp,
    )

    payload = {
        "platform": platform,
        "device_kind": dev.device_kind,
        "batch": B,
        "methodology": {
            "estimator": "marginal cost (T(k2)-T(k1))/(k2-k1), best of "
                         f"{max(1, args.rounds)} rounds per row; every "
                         "round's estimate committed in "
                         "rounds_us_per_call",
        },
        "results": results,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    # console-script protocol: setuptools passes the return value to
    # sys.exit(), so returning the payload dict would exit 1 — return None
    return None


def numpy_reference_spectra(x: np.ndarray, taps: np.ndarray, dec: int, fft_len: int):
    """float64 reference front half: causal FIR, decimate, fft(SN) frames."""
    y = np.convolve(x.astype(np.complex128), taps.astype(np.complex128))[: len(x)]
    y = y[::dec]
    frames = y.reshape(-1, fft_len)
    return np.fft.fft(frames, axis=-1) / np.sqrt(np.float32(fft_len))


def numpy_reference_bits(x: np.ndarray, taps: np.ndarray, dec: int, fft_len: int):
    """float64 reference chain: causal FIR, decimate, fft(SN), QPSK demod."""
    spec = numpy_reference_spectra(x, taps, dec, fft_len)
    b0 = (spec.real < 0).astype(np.uint8)
    b1 = (spec.imag < 0).astype(np.uint8)
    return np.stack([b0, b1], axis=-1).reshape(-1)


def rx_chain_gate(chain, step, x_full: np.ndarray):
    """The RX chain's correctness gate on two consecutive blocks.

    ``x_full`` is one contiguous complex64 capture of two blocks. Both go
    through the streaming ``step`` (``chain.jitted_streaming(...,
    split_boundary=True)`` or its compiled form) from a zero state, so the
    FIR history crosses the block boundary inside the check. Two
    conditions, tied to the reference's numeric contract
    (reference src/lib.rs:29-31):

      1. demod bits of BOTH blocks vs the float64 reference chain run on
         the whole capture: agreement >= :data:`GATE_BIT_AGREEMENT`;
      2. the PRE-DEMOD spectrum of block 2 (whose first K-1 samples depend
         on the threaded history) vs the float64 reference: RMS EVM <=
         :data:`GATE_EVM_DB` — a precision or boundary regression cannot
         hide behind sign-invariant bit agreement.

    Returns ``(ok, bit_agreement, evm_rms_db, state)`` with the streaming
    state after block 2.
    """
    import jax
    import jax.numpy as jnp

    from aether_primitives_tpu.boundary import Split

    n = x_full.shape[-1] // 2
    k = chain.taps.shape[-1]
    state = chain.init_state_split()
    got_blocks = []
    for i in range(2):
        xb = x_full[i * n : (i + 1) * n]
        bits, state = step(Split(xb.real.copy(), xb.imag.copy()), state)
        got_blocks.append(np.asarray(bits))
    got = np.concatenate(got_blocks)
    if chain.config.packed_bits:
        got = np.unpackbits(got, bitorder="little")
    ref_spec = numpy_reference_spectra(
        x_full, chain.taps, chain.config.decimation, chain.config.fft_len
    )
    ref_bits = np.stack(
        [(ref_spec.real < 0), (ref_spec.imag < 0)], axis=-1
    ).astype(np.uint8).reshape(-1)
    agree = float((got == ref_bits).mean())

    spec_fn = jax.jit(
        lambda blk, h: (lambda sp: (jnp.real(sp), jnp.imag(sp)))(
            chain._active(
                chain._frames_spectra(blk.to_complex(), history=h.to_complex())
            )
        )
    )
    x2 = x_full[n:]
    hist = x_full[n - (k - 1) : n]
    sr, si = (
        np.asarray(v)
        for v in spec_fn(
            Split(x2.real.copy(), x2.imag.copy()),
            Split(hist.real.copy(), hist.imag.copy()),
        )
    )
    ref_spec2 = ref_spec[ref_spec.shape[0] // 2 :]
    err2 = (sr - ref_spec2.real) ** 2 + (si - ref_spec2.imag) ** 2
    evm_rms_db = float(
        10.0 * np.log10(err2.mean() / (np.abs(ref_spec2) ** 2).mean())
    )
    ok = agree >= GATE_BIT_AGREEMENT and evm_rms_db <= GATE_EVM_DB
    return ok, agree, evm_rms_db, state


def bench_main(argv=None):
    """Headline benchmark: Msamples/s per device on the RX chain, ONE JSON
    line."""
    ap = argparse.ArgumentParser(prog="aether-bench")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    dev = require_gpu(jax, args.cpu)
    # packed_bits: the chain emits MAC-layer bytes (8 bits each,
    # LSB-first). Signal processing is identical; only the bit EMISSION
    # format changes. The gate unpacks and still requires bit-exactness
    # vs the f64 reference.
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4,
                                  packed_bits=True))
    # the headline is the STREAMING step (state = FIR history threaded
    # block-to-block, models/modem.py:streaming_step): the continuous-
    # capture production form, and the gate exercises the block boundary
    step = chain.jitted_streaming(donate_state=True, split_boundary=True)
    digest = jax.jit(lambda bits: jnp.sum(bits.astype(jnp.float32)))

    rng = np.random.default_rng(815)
    n = 1 << 22  # one shape for gate + timing: one jit compile total

    x_full = (rng.normal(size=2 * n)
              + 1j * rng.normal(size=2 * n)).astype(np.complex64)
    ok, agree, evm_rms_db, state = rx_chain_gate(chain, step, x_full)
    if not ok:
        print(json.dumps({
            "metric": "rx_chain_msamples_per_s_per_chip",
            "value": 0.0,
            "unit": "Msamples/s",
            "error": (
                f"correctness gate failed: bit agreement {agree} "
                f"(need >= {GATE_BIT_AGREEMENT}), spectrum EVM "
                f"{evm_rms_db:.1f} dB (need <= {GATE_EVM_DB})"
            ),
        }))
        sys.exit(1)

    # -- throughput ---------------------------------------------------------
    # streaming form: the FIR-history state threads call-to-call on device
    # (donated each step), exactly how a production continuous capture runs
    nblocks = 4
    blocks = [
        jax.device_put(
            Split(
                rng.normal(size=n).astype(np.float32),
                rng.normal(size=n).astype(np.float32),
            ),
            dev,
        )
        for _ in range(nblocks)
    ]
    state_box = [state]  # donated each call; always use the newest
    _bits = None
    for b in blocks:  # warm: compile + first executions
        _bits, state_box[0] = step(b, state_box[0])
    float(np.asarray(digest(_bits)))

    def run(iters: int) -> float:
        t0 = time.perf_counter()
        out = None
        for i in range(iters):
            out, state_box[0] = step(blocks[i % nblocks], state_box[0])
        float(np.asarray(digest(out)))
        return time.perf_counter() - t0

    run(3)  # settle
    # best of several marginal-cost rounds; every round is reported
    dt, floor, round_est = None, float("inf"), []
    for _ in range(5):
        dt_i, floor_i = marginal_cost(run, 10, 60)
        floor = min(floor, floor_i)
        if dt_i is not None:
            round_est.append(dt_i)
            dt = dt_i if dt is None else min(dt, dt_i)
    if dt is None:
        print(json.dumps({
            "metric": "rx_chain_msamples_per_s_per_chip",
            "value": 0.0,
            "unit": "Msamples/s",
            "error": f"timing did not resolve (floor {floor*1e6:.1f} us/block)",
        }))
        sys.exit(1)
    msps = n / dt / 1e6

    print(json.dumps({
        "metric": "rx_chain_msamples_per_s_per_chip",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "detail": {
            "chain": f"fir{chain.taps.shape[-1]}+dec4+fft2048+qpsk_demod (streaming, packed-bit emission)",
            "block_samples": n,
            "ms_per_block": round(dt * 1e3, 3),
            "correctness_bit_agreement": agree,
            "spectrum_evm_rms_db": round(evm_rms_db, 1),
            "gate": "2-consecutive-block streaming: bit_agreement>=0.99999 and block-2 evm_rms_db<=-80 (FIR boundary inside the check)",
            "device": str(dev),
            "device_kind": dev.device_kind,
            "rounds_ms_per_block": [round(r * 1e3, 3) for r in round_est],
        },
    }))
