"""Model tests: modem loopback (the reference's examples/modem.rs acceptance
path), RxChain shape/consistency, waterfall channelizer vs direct math."""

import jax
import numpy as np
import pytest

from aether_primitives_tpu import split
from aether_primitives_tpu.evm import evm_rms_db
from aether_primitives_tpu.models import Modem, ModemConfig, RxChain, RxChainConfig
from aether_primitives_tpu.models.channelizer import waterfall_spectra
from aether_primitives_tpu.ops.fft import Scale, fft as _fft


def test_modem_loopback_bit_exact():
    # reference examples/modem.rs: 100 random bits, QPSK, noise power 0.01,
    # demod must return the exact bits
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    m = Modem(ModemConfig(noise_power=0.01, seed=815))
    out = np.asarray(m.loopback(bits))
    assert (out == bits).all()


def test_modem_loopback_deterministic():
    bits = np.zeros(64, np.uint8)
    m1 = Modem()
    m2 = Modem()
    a = np.asarray(m1.loopback(bits))
    b = np.asarray(m2.loopback(bits))
    assert (a == b).all()


def test_modem_bpsk():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 128).astype(np.uint8)
    m = Modem(ModemConfig(modulation="bpsk", noise_power=0.01))
    assert (np.asarray(m.loopback(bits)) == bits).all()


def test_modem_jittable():
    bits = np.ones(64, np.uint8)
    m = Modem()
    out = jax.jit(m.loopback)(bits)
    assert (np.asarray(out) == bits).all()


@pytest.fixture(scope="module")
def chain():
    return RxChain(RxChainConfig(fft_len=256, decimation=4))


def test_rx_chain_shapes(chain):
    n = 4 * 256 * 4
    rng = np.random.default_rng(2)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    bits = np.asarray(chain.step(x))
    # n / decimation symbols * 2 bits/symbol
    assert bits.shape == (n // 4 * 2,)
    assert set(np.unique(bits)) <= {0, 1}


def test_rx_chain_split_boundary_equals_complex(chain):
    n = 4 * 256 * 2
    rng = np.random.default_rng(3)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    a = np.asarray(chain.step(x))
    b = np.asarray(chain.jitted(donate=False, split_boundary=True)(split(x)))
    assert (a == b).all()


def test_rx_chain_decodes_clean_signal():
    # Build a signal the chain inverts exactly: symbols -> ifft (SN) ->
    # upsample by zero-order hold x4 -> scaled so the chain's FIR+decimate
    # recovers the frames. Use an identity-ish config: 1-tap FIR, dec 1.
    cfg = RxChainConfig(
        fir_taps=np.array([1.0 + 0j], np.complex64), decimation=1, fft_len=256
    )
    ch = RxChain(cfg)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 256 * 2 * 4).astype(np.uint8)
    syms = np.asarray(ch.modulation.modulate(bits)).reshape(4, 256)
    # chain computes fft(frames, SN); send ifft(syms, SN) so it round-trips
    from aether_primitives_tpu.ops.fft import ifft

    time_sig = np.asarray(ifft(syms, Scale.SN)).reshape(-1)
    out = np.asarray(ch.step(time_sig))
    assert (out == bits).all()


def test_rx_chain_fir_modes_agree():
    # the overlap-save realization must produce the same bits as the
    # exact time-domain path (same filter, different factorization)
    rng = np.random.default_rng(7)
    n = 4 * 256 * 4
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    a = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode="shift_add"))
    bits_a = np.asarray(a.step(x))
    for mode in ("os", "fused"):
        b = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode=mode))
        bits_b = np.asarray(b.step(x))
        assert (bits_a == bits_b).mean() == 1.0, mode


@pytest.mark.parametrize("mode", ["os", "fused"])
def test_rx_chain_tpu_modes_sharded_match_single(eight_devices, mode):
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh({"time": 8})
    cfg = RxChainConfig(fft_len=256, decimation=4, fir_mode=mode)
    chain = RxChain(cfg)
    rng = np.random.default_rng(8)
    n = 8 * 4 * 256 * 2
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    single = np.asarray(chain.step(x))
    sharded = np.asarray(chain.sharded_step(x, mesh))
    assert (single == sharded).mean() == 1.0


def test_waterfall_matches_direct_math():
    rng = np.random.default_rng(5)
    cap = (rng.normal(size=1000) + 1j * rng.normal(size=1000)).astype(np.complex64)
    got = np.asarray(waterfall_spectra(cap, 256))
    # direct: pad to 1024, 4 rows, fft SN, fftshift, abs
    padded = np.zeros(1024, np.complex64)
    padded[:1000] = cap
    rows = padded.reshape(4, 256)
    spec = np.asarray(_fft(rows, Scale.SN))
    expect = np.abs(np.roll(spec, 128, axis=-1))
    assert np.allclose(got, expect, atol=1e-6)


def test_waterfall_db_mode():
    cap = np.ones(512, np.complex64)
    out = np.asarray(waterfall_spectra(cap, 256, use_db=True))
    assert out.shape == (2, 256)
    # DC bin of all-ones with SN scale: sqrt(256) = 16 -> 10*log10(16) dB
    assert abs(out[0, 128] - 10 * np.log10(16.0)) < 1e-3


def test_waterfall_windowed_overlap():
    from aether_primitives_tpu.models.channelizer import Channelizer, waterfall_spectra

    rng = np.random.default_rng(9)
    cap = (rng.normal(size=1024) + 1j * rng.normal(size=1024)).astype(np.complex64)
    # hop = fft_len/2 doubles the rows (minus edge padding effects)
    out = np.asarray(waterfall_spectra(cap, 256, window="hann", hop=128))
    assert out.shape[0] == (1024 - 256) // 128 + 1
    assert out.shape[1] == 256
    # frame content: frame m spans samples [m*hop, m*hop + fft_len) windowed
    w = np.hanning(256)
    frame3 = cap[3 * 128 : 3 * 128 + 256] * w
    spec = np.fft.fft(frame3.astype(np.complex128)) / np.sqrt(np.float32(256))
    expect = np.abs(np.roll(spec, 128))
    assert np.allclose(out[3], expect, atol=2e-5)


def test_waterfall_hop_must_divide():
    from aether_primitives_tpu.models.channelizer import waterfall_spectra

    with pytest.raises(ValueError, match="multiple of hop"):
        waterfall_spectra(np.zeros(512, np.complex64), 256, hop=100)


def test_channelizer_as_pipeline_stage():
    from aether_primitives_tpu.models.channelizer import Channelizer
    from aether_primitives_tpu.parallel import streaming

    ch = Channelizer(128, use_db=False, window="hamming")
    ex = streaming.new("chan", ch).finish(depth=2, donate=False, printer=None)
    rng = np.random.default_rng(10)
    blocks = [
        (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
        for _ in range(3)
    ]
    outs = ex.run(blocks)
    assert all(np.asarray(o).shape == (4, 128) for o in outs)


def test_tx_rx_chain_loopback_bit_exact():
    # full modem loopback THROUGH the pulse-shaping filters: TX (OFDM
    # frames on active bins, zero-stuff, interpolate) -> RX (filter,
    # decimate, FFT, demod). With guard bands inside the filters' flat
    # region and group-delay compensation, interior frames are bit-exact.
    from aether_primitives_tpu.models.modem import TxChain, loopback_delay

    cfg = RxChainConfig(fft_len=256, decimation=4, active_bins=128)
    tx = TxChain(cfg)
    rx = RxChain(cfg)
    rng = np.random.default_rng(21)
    nframes = 6
    bits = rng.integers(0, 2, nframes * tx.bits_per_frame()).astype(np.uint8)
    x = np.asarray(tx.step(bits))
    d = loopback_delay(tx, rx)
    rx_in = np.concatenate([x[d:], np.zeros(d, np.complex64)])
    out = np.asarray(rx.step(rx_in))
    bpf = tx.bits_per_frame()
    # skip the first and last frame (filter transients / zero-padding)
    assert (out[bpf : (nframes - 1) * bpf] == bits[bpf : (nframes - 1) * bpf]).all()


def test_tx_rx_chain_loopback_with_noise():
    from aether_primitives_tpu.models.modem import TxChain, loopback_delay
    from aether_primitives_tpu.ops import noise as _noise

    cfg = RxChainConfig(fft_len=256, decimation=4, active_bins=128)
    tx = TxChain(cfg)
    rx = RxChain(cfg)
    rng = np.random.default_rng(22)
    nframes = 6
    bits = rng.integers(0, 2, nframes * tx.bits_per_frame()).astype(np.uint8)
    x = np.asarray(tx.step(bits))
    x = np.asarray(_noise.new(1e-6, 815).apply(x))
    d = loopback_delay(tx, rx)
    rx_in = np.concatenate([x[d:], np.zeros(d, np.complex64)])
    out = np.asarray(rx.step(rx_in))
    bpf = tx.bits_per_frame()
    assert (out[bpf : (nframes - 1) * bpf] == bits[bpf : (nframes - 1) * bpf]).all()


def test_tx_chain_bad_bit_count():
    from aether_primitives_tpu.models.modem import TxChain

    tx = TxChain(RxChainConfig(fft_len=256, decimation=1, active_bins=64))
    with pytest.raises(ValueError, match="divisible"):
        tx.step(np.zeros(100, np.uint8))


def test_tx_rx_loopback_qam16_with_equalizer():
    # unlike QPSK (sign decisions, gain-invariant), 16-QAM needs amplitude
    # accuracy — the TX/RX filter cascade's per-bin gain ripple must be
    # equalized out (pilot frame), after which interior frames are exact
    from aether_primitives_tpu.models.modem import TxChain, loopback_delay
    from aether_primitives_tpu.models.sync import OfdmEqualizer

    cfg = RxChainConfig(
        fft_len=256, decimation=4, active_bins=128, modulation="qam16"
    )
    tx = TxChain(cfg)
    rx = RxChain(cfg)
    assert tx.bits_per_frame() == 128 * 4
    rng = np.random.default_rng(23)
    bpf = tx.bits_per_frame()
    # frame 0 absorbs the TX/RX filter ramp-in transient; the pilot goes in
    # frame 1 so the channel estimate sees steady state
    dummy_bits = rng.integers(0, 2, bpf).astype(np.uint8)
    pilot_bits = rng.integers(0, 2, bpf).astype(np.uint8)
    data_bits = rng.integers(0, 2, 3 * bpf).astype(np.uint8)
    x = np.asarray(tx.step(np.concatenate([dummy_bits, pilot_bits, data_bits])))
    d = loopback_delay(tx, rx)
    rx_in = np.concatenate([x[d:], np.zeros(d, np.complex64)])
    spec = np.asarray(rx.spectra(rx_in))  # [5, 128]
    pilot_syms = np.asarray(rx.modulation.modulate(pilot_bits))
    h = OfdmEqualizer.estimate(spec[1], pilot_syms)
    out = np.asarray(rx.demod_spectra(OfdmEqualizer.apply(spec[2:], h)))
    # skip the last (zero-padded tail) frame
    assert (out[: 2 * bpf] == data_bits[: 2 * bpf]).all()


def test_rx_chain_precision_config():
    import jax

    # explicit settings map to lax.Precision; invalid ones are rejected
    hi = RxChain(RxChainConfig(fft_len=256, decimation=4, precision="highest"))
    assert hi._einsum_precision() == jax.lax.Precision.HIGHEST
    h = RxChain(RxChainConfig(fft_len=256, decimation=4, precision="high"))
    assert h._einsum_precision() == jax.lax.Precision.HIGH
    bad = RxChain(RxChainConfig(fft_len=256, decimation=4, precision="default"))
    with pytest.raises(ValueError, match="not allowed"):
        bad._einsum_precision()
    # both allowed settings produce reference-exact bits (the CPU computes
    # f32 regardless)
    rng = np.random.default_rng(60)
    n = 4 * 256 * 4
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    for chain in (hi, h):
        cfused = RxChain(RxChainConfig(fft_len=256, decimation=4,
                                       fir_mode="fused",
                                       precision=chain.config.precision))
        ref = RxChain(RxChainConfig(fft_len=256, decimation=4,
                                    fir_mode="shift_add"))
        assert (np.asarray(cfused.step(x)) == np.asarray(ref.step(x))).all()


@pytest.mark.parametrize("modname", ["qpsk", "bpsk"])
def test_rx_chain_sign_fast_path_bit_exact(modname):
    # force the matmul backend on CPU so the staged-layout sign-demod fast
    # path activates; its bits must exactly equal the spectra->demod path
    # and the exact time-domain chain
    rng = np.random.default_rng(80)
    n = 4 * 256 * 6
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    fast = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode="fused",
                                 fft_backend="matmul", modulation=modname))
    assert fast._sign_fast_path_ok()
    ref = RxChain(RxChainConfig(fft_len=256, decimation=4,
                                fir_mode="shift_add", modulation=modname))
    a = np.asarray(fast.step(x))
    b = np.asarray(ref.step(x))
    assert a.shape == b.shape
    assert (a == b).all()
    # and via the explicit spectra path on the same chain config
    c = np.asarray(fast.demod_spectra(fast.spectra(x)))
    assert (a == c).all()


def test_rx_chain_sign_fast_path_sharded(eight_devices):
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh({"time": 8})
    cfg = RxChainConfig(fft_len=256, decimation=4, fir_mode="fused",
                        fft_backend="matmul")
    chain = RxChain(cfg)
    assert chain._sign_fast_path_ok()
    rng = np.random.default_rng(81)
    n = 8 * 4 * 256 * 2
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    single = np.asarray(chain.step(x))
    sharded = np.asarray(chain.sharded_step(x, mesh))
    assert (single == sharded).mean() == 1.0


def test_step_split_and_plane_op_match_reference():
    # step_split (merge + complex fast path) and the standalone all-real
    # plane op must both produce reference-exact bits
    from aether_primitives_tpu import split as _split
    from aether_primitives_tpu.cli import numpy_reference_bits
    from aether_primitives_tpu.ops import fir as fir_ops

    rng = np.random.default_rng(90)
    n = 4 * 256 * 6
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    fast = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode="fused",
                                 fft_backend="matmul"))
    assert fast._sign_fast_path_ok()
    via_split = np.asarray(fast.jitted(donate=False, split_boundary=True)(_split(x)))
    ref = numpy_reference_bits(x, fast.taps, 4, 256)
    assert (via_split == ref).mean() == 1.0
    zr, zi = fir_ops.fir_decimate_fft_planes(
        x.real.copy(), x.imag.copy(), fast.taps, 4, 256, fft_backend="matmul"
    )
    via_planes = np.asarray(fast._bits_from_planes(zr, zi))
    assert (via_planes == ref).mean() == 1.0
    # plane op with history stitches streams exactly like the complex op
    k = fast.taps.shape[-1]
    h = n // 2
    zr1, zi1 = fir_ops.fir_decimate_fft_planes(
        x.real[:h].copy(), x.imag[:h].copy(), fast.taps, 4, 256,
        fft_backend="matmul")
    zr2, zi2 = fir_ops.fir_decimate_fft_planes(
        x.real[h:].copy(), x.imag[h:].copy(), fast.taps, 4, 256,
        fft_backend="matmul",
        history=(x.real[h - (k - 1):h].copy(), x.imag[h - (k - 1):h].copy()))
    b1 = np.asarray(fast._bits_from_planes(zr1, zi1))
    b2 = np.asarray(fast._bits_from_planes(zr2, zi2))
    assert (np.concatenate([b1, b2]) == ref).mean() == 1.0


# ------------------------------------------------------- streaming state


@pytest.mark.parametrize("mode", ["fused", "os", "shift_add"])
def test_rx_chain_streaming_equals_contiguous(mode):
    # N successive streaming_step blocks of one
    # contiguous capture must be bit-exact to the single contiguous step
    # (the per-block `step` corrupts K-1 samples per boundary).
    rng = np.random.default_rng(21)
    nblk, nblocks = 2 * 256 * 4, 4
    x = (rng.normal(size=nblk * nblocks)
         + 1j * rng.normal(size=nblk * nblocks)).astype(np.complex64)
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4, fir_mode=mode))
    contiguous = np.asarray(chain.step(x))
    state = chain.init_state()
    outs = []
    step = jax.jit(chain.streaming_step)
    for i in range(nblocks):
        bits, state = step(x[i * nblk : (i + 1) * nblk], state)
        outs.append(np.asarray(bits))
    streamed = np.concatenate(outs)
    assert (streamed == contiguous).all()
    # and per-block restart really does differ at the boundaries (the
    # corruption streaming exists to fix): K>1 taps, random data
    per_block = np.concatenate(
        [np.asarray(chain.step(x[i * nblk : (i + 1) * nblk]))
         for i in range(nblocks)]
    )
    assert (per_block != contiguous).any()


def test_rx_chain_streaming_qam16_and_batched():
    # non-sign-fast-path modulation + leading batch axis
    rng = np.random.default_rng(22)
    nblk, nblocks, b = 4 * 128 * 2, 3, 2
    x = (rng.normal(size=(b, nblk * nblocks))
         + 1j * rng.normal(size=(b, nblk * nblocks))).astype(np.complex64)
    chain = RxChain(
        RxChainConfig(fft_len=128, decimation=4, modulation="qam16")
    )
    contiguous = np.asarray(chain.step(x))
    state = chain.init_state((b,))
    outs = []
    for i in range(nblocks):
        bits, state = chain.streaming_step(x[..., i * nblk : (i + 1) * nblk], state)
        outs.append(np.asarray(bits))
    streamed = np.concatenate(outs, axis=-1)
    assert (streamed == contiguous).all()


def test_rx_chain_streaming_split_boundary():
    rng = np.random.default_rng(23)
    nblk, nblocks = 2 * 256 * 4, 3
    x = (rng.normal(size=nblk * nblocks)
         + 1j * rng.normal(size=nblk * nblocks)).astype(np.complex64)
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4))
    contiguous = np.asarray(chain.step(x))
    state = chain.init_state_split()
    step = chain.jitted_streaming(split_boundary=True)
    outs = []
    for i in range(nblocks):
        blk = x[i * nblk : (i + 1) * nblk]
        bits, state = step(split(blk), state)
        outs.append(np.asarray(bits))
    assert (np.concatenate(outs) == contiguous).all()


def test_stateful_executor_contiguous_capture():
    from aether_primitives_tpu.parallel.streaming import StatefulExecutor

    rng = np.random.default_rng(24)
    nblk, nblocks = 2 * 256 * 4, 6
    x = (rng.normal(size=nblk * nblocks)
         + 1j * rng.normal(size=nblk * nblocks)).astype(np.complex64)
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4))
    ex = StatefulExecutor(
        chain.streaming_step, chain.init_state(), depth=2, printer=None
    )
    blocks = [x[i * nblk : (i + 1) * nblk] for i in range(nblocks)]
    outs = ex.run(blocks)
    ex.close()
    streamed = np.concatenate([np.asarray(o) for o in outs])
    assert (streamed == np.asarray(chain.step(x))).all()
    assert ex.chain_stats.total_n == nblocks


def test_stateful_executor_checkpoint_survives_donation():
    # the .state property must return a COPY: with donate_state=True the
    # live carry buffers are donated to XLA on the next send(), and a
    # held checkpoint used to come back as a deleted array (review
    # finding r4)
    from aether_primitives_tpu.parallel.streaming import StatefulExecutor

    rng = np.random.default_rng(25)
    nblk = 2 * 256 * 4
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4))
    ex = StatefulExecutor(
        chain.streaming_step, chain.init_state(), depth=2, printer=None
    )
    blocks = [
        (rng.normal(size=nblk) + 1j * rng.normal(size=nblk)).astype(
            np.complex64
        )
        for _ in range(3)
    ]
    ex.send(blocks[0])
    ex.recv()
    ckpt = ex.state  # checkpoint mid-stream
    ex.send(blocks[1])
    ex.recv()
    ckpt_np = jax.tree.map(np.asarray, ckpt)  # must NOT be deleted
    ex.close()
    # resuming from the checkpoint replays block 1 bit-exactly
    ex2 = StatefulExecutor(
        chain.streaming_step, ckpt_np, depth=2, printer=None
    )
    replay = ex2.run([blocks[1]])
    ex2.close()
    direct, _ = chain.streaming_step(blocks[1], ckpt_np)
    assert (np.asarray(replay[0]) == np.asarray(direct)).all()


def test_streaming_step_short_block_state():
    # a block shorter than the filter memory (possible only with taps
    # longer than one block) must carry history over from the previous
    # state, keeping the jitted state-shape contract (review finding r4:
    # a bare slice silently shrank the state)
    taps = np.hanning(1500).astype(np.float32)
    chain = RxChain(RxChainConfig(fft_len=256, decimation=4,
                                  fir_taps=taps))
    state = chain.init_state()
    assert np.shape(state)[-1] == 1499
    rng = np.random.default_rng(26)
    block = (rng.normal(size=1024) + 1j * rng.normal(size=1024)).astype(
        np.complex64
    )
    _bits, new_state = chain.streaming_step(block, state)
    assert np.shape(new_state) == np.shape(state)
    # and the carried history is [old tail | block], not a bare slice
    expect = np.concatenate([np.asarray(state), block])[-1499:]
    assert np.allclose(np.asarray(new_state), expect)


class TestRaggedTails:
    """Tail-block policy for captures that don't divide frame_span:
    strict by default with a precise error, and two explicit policies — step_ragged (drop-free remainder carry) and
    step_padded (the reference waterfall's zero-pad convention)."""

    def _chain(self, **kw):
        from aether_primitives_tpu.models import RxChain, RxChainConfig

        return RxChain(RxChainConfig(fft_len=128, decimation=4,
                                     fir_mode="os", **kw))

    def test_step_rejects_ragged_with_policy_error(self, rng):
        chain = self._chain()
        x = (rng.normal(size=1000) + 1j * rng.normal(size=1000)).astype(np.complex64)
        with pytest.raises(ValueError, match="step_ragged"):
            chain.step(x)
        with pytest.raises(ValueError, match="step_ragged"):
            chain.streaming_step(x, chain.init_state())

    def test_step_ragged_is_dropfree(self, rng):
        chain = self._chain()
        span = chain.frame_span
        n = 3 * span + 217
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        bits, tail = chain.step_ragged(x)
        assert np.array_equal(np.asarray(bits), np.asarray(chain.step(x[:3 * span])))
        assert np.array_equal(np.asarray(tail), x[3 * span:])
        # remainder-carry across captures loses nothing: tail + next == contiguous
        y = (rng.normal(size=2 * span - 217) + 1j * rng.normal(size=2 * span - 217)).astype(np.complex64)
        bits2 = chain.step(np.concatenate([np.asarray(tail), y]))
        # frames 4..5 of the contiguous capture match
        contiguous = np.asarray(chain.step_padded(np.concatenate([x, y])))
        per_frame = bits2.shape[-1] // 2
        # (state restarts at the tail boundary, so only the CONCATENATION
        # contract is asserted: no samples were dropped, shapes add up)
        assert np.asarray(bits).shape[-1] + np.asarray(bits2).shape[-1] == contiguous.shape[-1]
        del per_frame

    def test_step_ragged_shorter_than_frame(self, rng):
        chain = self._chain()
        x = (rng.normal(size=100) + 1j * rng.normal(size=100)).astype(np.complex64)
        bits, tail = chain.step_ragged(x)
        assert bits.shape[-1] == 0
        assert np.array_equal(np.asarray(tail), x)

    def test_step_padded_matches_manual_zero_pad(self, rng):
        chain = self._chain()
        span = chain.frame_span
        n = 2 * span + 100
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        got = np.asarray(chain.step_padded(x))
        manual = np.zeros(3 * span, np.complex64)
        manual[:n] = x
        assert np.array_equal(got, np.asarray(chain.step(manual)))

    def test_sharded_rejects_ragged_and_pad_to_frames_fixes(self, rng):
        import jax as _jax

        from aether_primitives_tpu.models import pad_to_frames
        from aether_primitives_tpu.parallel import mesh as mesh_mod

        if len(_jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        chain = self._chain()
        m = mesh_mod.make_mesh({"channel": 2, "time": 4})
        span = chain.frame_span
        n = 4 * span + 300  # divides neither shards nor per-shard span
        x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
        with pytest.raises(ValueError, match="pad_to_frames|frame_span"):
            chain.sharded_step_2d(x, m)
        xp = np.asarray(pad_to_frames(x, 4 * span))
        sharded = np.asarray(chain.sharded_step_2d(xp, m))
        single = np.asarray(chain.step(xp))
        # compare the frames that contain real samples: bits demodulated
        # from the pure-zero pad tail are sign tests on +-1e-12 filter
        # ring-down rounding, which legitimately differs between the
        # sharded (block_len=1024) and single (block_len=4096)
        # overlap-save realizations — meaningless bits by construction
        bits_per_frame = sharded.shape[-1] * span // xp.shape[-1]
        real_frames = -(-n // span)
        real = bits_per_frame * real_frames
        assert np.array_equal(sharded[..., :real], single[..., :real])


class TestPackedBits:
    """packed_bits emission: bytes hold 8 bits LSB-first
    (np.unpackbits(..., bitorder='little') restores the flat stream) —
    the production MAC-layer format."""

    @pytest.mark.parametrize("fir_mode,backend,modulation", [
        ("fused", "matmul", "qpsk"),  # packed fast-path epilogue
        ("fused", "matmul", "bpsk"),
        ("os", None, "qpsk"),         # generic _pack_flat fallback
        ("fused", None, "qam16"),     # non-sign path fallback
    ])
    def test_packed_equals_unpacked(self, rng, fir_mode, backend, modulation):
        from aether_primitives_tpu.models import RxChain, RxChainConfig

        kw = dict(fft_len=128, decimation=4, fir_mode=fir_mode,
                  fft_backend=backend, modulation=modulation)
        plain = RxChain(RxChainConfig(**kw))
        packed = RxChain(RxChainConfig(packed_bits=True, **kw))
        n = 4 * plain.frame_span
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        flat = np.asarray(plain.step(x))
        pk = np.asarray(packed.step(x))
        assert pk.shape[-1] == flat.shape[-1] // 8
        assert np.array_equal(
            np.unpackbits(pk, bitorder="little"), flat
        )

    def test_packed_streaming_matches_contiguous(self, rng):
        from aether_primitives_tpu.models import RxChain, RxChainConfig

        chain = RxChain(RxChainConfig(fft_len=128, decimation=4,
                                      fir_mode="os", packed_bits=True))
        n = 2 * chain.frame_span
        cap = (rng.normal(size=3 * n)
               + 1j * rng.normal(size=3 * n)).astype(np.complex64)
        state = chain.init_state()
        parts = []
        for i in range(3):
            b, state = chain.streaming_step(cap[i * n:(i + 1) * n], state)
            parts.append(np.asarray(b))
        assert np.array_equal(
            np.concatenate(parts), np.asarray(chain.step(cap))
        )

    def test_packed_rejects_indivisible_frame(self):
        from aether_primitives_tpu.models import RxChain, RxChainConfig

        with pytest.raises(ValueError, match="divisible by 8"):
            RxChain(RxChainConfig(fft_len=128, decimation=4,
                                  modulation="bpsk", active_bins=12,
                                  packed_bits=True))
