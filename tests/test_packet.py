"""PacketModem: loopback across configs, and full recovery through a
channel with delay, CFO, complex gain, and AWGN — plus CRC verdicts."""

import numpy as np
import pytest

from aether_primitives_tpu.models.packet import PacketConfig, PacketModem


def _channel(burst, rng, delay=300, cfo=1e-3, gain=0.4 * np.exp(1j * 1.1),
             snr_sigma=0.05, capture_len=4096):
    x = np.zeros(capture_len, np.complex64)
    x[delay : delay + burst.size] = np.asarray(burst)
    n = np.arange(capture_len)
    x = x * gain * np.exp(2j * np.pi * cfo * n)
    x += snr_sigma * (rng.normal(size=capture_len) + 1j * rng.normal(size=capture_len))
    return x.astype(np.complex64)


@pytest.mark.parametrize("fec", ["viterbi", "ldpc", "rs", "bch", "tpc", "turbo", "polar", "none"])
def test_loopback_all_fecs(rng, fec):
    cfg = PacketConfig(payload_bits=960, fec=fec)
    pm = PacketModem(cfg)
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    bits, ok, diag = pm.loopback(payload)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()
    assert int(diag["offset"]) == 0
    assert float(diag["metric"]) > 0.8


def test_packet_through_channel_viterbi(rng):
    pm = PacketModem(PacketConfig(payload_bits=960, fec="viterbi",
                                  interleave_rows=4))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=512, cfo=1.2e-3, snr_sigma=0.12)
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()
    assert int(diag["offset"]) == 512
    assert abs(float(diag["cfo"]) - 1.2e-3) < 5e-5
    g = complex(np.asarray(diag["gain"]))
    assert abs(abs(g) - 0.4) < 0.05


def test_packet_through_channel_ldpc(rng):
    pm = PacketModem(PacketConfig(payload_bits=960, fec="ldpc"))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=200, cfo=-8e-4, snr_sigma=0.15)
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()


def test_packet_through_channel_rs_burst_fade(rng):
    # Reed-Solomon's specialty: a contiguous fade. 40 QPSK symbols = 80
    # bits hit <= 11 consecutive GF(2^8) symbols of the single shortened
    # RS(156,124) codeword (t=16) -- corrected with NO interleaver.
    pm = PacketModem(PacketConfig(payload_bits=960, fec="rs",
                                  rs_n=156, rs_k=124))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=400, cfo=5e-4, snr_sigma=0.03)
    fade_start = 400 + pm.preamble.size + 200
    cap[fade_start : fade_start + 40] = 0.02 * (
        rng.normal(size=40) + 1j * rng.normal(size=40)
    )
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()
    assert int(diag["offset"]) == 400


def test_packet_through_channel_bch(rng):
    # scattered random bit errors: binary BCH's regime. Each of the
    # BCH(255,191,t=8) codewords corrects its share of the sparse hits.
    pm = PacketModem(PacketConfig(payload_bits=960, fec="bch", bch_t=8))
    assert pm._bch.k == 191
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=300, cfo=5e-4, snr_sigma=0.12)
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()
    assert int(diag["offset"]) == 300


def test_packet_through_channel_bch_chase(rng):
    # same burst at heavier noise than the hard-BCH test survives:
    # Chase-2 soft decoding buys the margin
    pm = PacketModem(PacketConfig(payload_bits=960, fec="bch", bch_t=8,
                                  bch_chase=4))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=250, cfo=5e-4, snr_sigma=0.17)
    bits, ok, _ = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()


def test_packet_through_channel_tpc(rng):
    # (32,26)^2 block-turbo link: two TPC blocks carry the 992-bit
    # frame; soft demod LLRs feed Chase-Pyndiah directly
    pm = PacketModem(PacketConfig(payload_bits=960, fec="tpc"))
    assert pm.tpc_frames == 2 and pm.coded_bits == 2048
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=180, cfo=5e-4, snr_sigma=0.22)
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()
    assert int(diag["offset"]) == 180


def test_packet_through_channel_turbo(rng):
    # heavier noise than the viterbi channel test: turbo's regime
    pm = PacketModem(PacketConfig(payload_bits=960, fec="turbo"))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=350, cfo=6e-4, snr_sigma=0.30)
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()


def test_packet_crc_flags_unrecoverable(rng):
    # noise far beyond the code's correction ability: CRC must say no
    pm = PacketModem(PacketConfig(payload_bits=960, fec="viterbi"))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=100, cfo=0.0, snr_sigma=1.5)
    _, ok, _ = pm.rx(cap)
    assert not bool(ok)


def test_uncoded_needs_cleaner_channel_than_coded(rng):
    # same channel: coded link survives, uncoded link corrupts
    # (0.22 with the 0.4 channel gain -> ~3.4% raw bit errors)
    noise = 0.22
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    coded = PacketModem(PacketConfig(payload_bits=960, fec="viterbi"))
    uncoded = PacketModem(PacketConfig(payload_bits=960, fec="none"))
    cap_c = _channel(np.asarray(coded.tx(payload)), rng, snr_sigma=noise)
    cap_u = _channel(np.asarray(uncoded.tx(payload)), rng, snr_sigma=noise)
    bits_c, ok_c, _ = coded.rx(cap_c)
    bits_u, ok_u, _ = uncoded.rx(cap_u)
    assert bool(ok_c) and (np.asarray(bits_c) == payload).all()
    assert (np.asarray(bits_u) != payload).any()
    assert not bool(ok_u)


def test_wrong_payload_size_raises(rng):
    pm = PacketModem(PacketConfig(payload_bits=960))
    with pytest.raises(ValueError, match="payload"):
        pm.tx(np.zeros(100, np.uint8))


def test_qam16_packet_loopback(rng):
    pm = PacketModem(PacketConfig(payload_bits=960, modulation="qam16",
                                  fec="viterbi"))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    bits, ok, _ = pm.loopback(payload)
    assert bool(ok) and (np.asarray(bits) == payload).all()


def test_rs_erasure_flagging_doubles_fade_depth(rng):
    # an 80-QPSK-symbol fade hits ~21 GF(2^8) symbols of the shortened
    # RS(156,124) codeword: beyond t=16 for plain RS, within the
    # 2*nu + rho <= 32 erasure budget once the demod confidence flags it
    cfg = dict(payload_bits=960, fec="rs", rs_n=156, rs_k=124)
    plain = PacketModem(PacketConfig(**cfg))
    eras = PacketModem(PacketConfig(**cfg, rs_erasures=True))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(plain.tx(payload))
    cap = _channel(burst, rng, delay=400, cfo=5e-4, snr_sigma=0.03)
    fade_start = 400 + plain.preamble.size + 230
    cap[fade_start : fade_start + 80] = 0.02 * (
        rng.normal(size=80) + 1j * rng.normal(size=80)
    )
    _, ok_plain, _ = plain.rx(cap)
    bits, ok_eras, _ = eras.rx(cap)
    assert not bool(ok_plain)  # 21 symbol errors > t = 16
    assert bool(ok_eras)
    assert (np.asarray(bits) == payload).all()


def test_packet_through_channel_polar(rng):
    """CA-SCL polar link (per-codeword CRC-8, list 8) survives the same
    heavy channel the turbo test uses."""
    pm = PacketModem(PacketConfig(payload_bits=960, fec="polar",
                                  polar_n=256, polar_list=8))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    burst = np.asarray(pm.tx(payload))
    cap = _channel(burst, rng, delay=300, cfo=8e-4, snr_sigma=0.30)
    bits, ok, diag = pm.rx(cap)
    assert bool(ok)
    assert (np.asarray(bits) == payload).all()
    assert int(diag["offset"]) == 300


def test_preamble_is_host_constant():
    """PacketModem.__init__ must not run eager device ops: the preamble
    is built in host numpy and must equal the modulated Gold halves
    exactly."""
    from aether_primitives_tpu.ops import modulation as _mod
    from aether_primitives_tpu.ops import sequence as _seq

    pm = PacketModem(PacketConfig(payload_bits=64))
    assert isinstance(pm.preamble, np.ndarray)
    pre_bits = np.asarray(
        _seq.lte_gold(pm.config.preamble_cinit, 2 * pm.config.preamble_half)
    )
    half = np.asarray(_mod.qpsk().modulate(pre_bits), dtype=np.complex64)
    assert (pm.preamble == np.concatenate([half, half])).all()


def test_ccsds_concatenated_fec(rng):
    """CCSDS-style telemetry coding: RS(255,223) outer + K=7 (171,133)
    convolutional inner with a bit interleaver between — the concatenated
    deep-space standard, composed from the framework's verified pieces.
    The interleaver scatters the Viterbi decoder's burst errors across RS
    symbols, so a deep fade that kills the conv-only link decodes clean."""
    pm = PacketModem(PacketConfig(payload_bits=960, fec="ccsds"))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    bits, ok, _ = pm.loopback(payload)
    assert bool(ok) and (np.asarray(bits) == payload).all()

    def faded(modem, fade_syms=60, sigma=0.25):
        x = np.asarray(modem.tx(payload), dtype=np.complex64).copy()
        lo = modem.preamble.size + 40
        x[lo : lo + fade_syms] *= 0.05
        x += (
            sigma * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
        ).astype(np.complex64)
        return x.astype(np.complex64)

    bits2, ok2, _ = pm.rx(faded(pm))
    assert bool(ok2) and (np.asarray(bits2) == payload).all()

    pmv = PacketModem(PacketConfig(payload_bits=960, fec="viterbi"))
    _bv, okv, _ = pmv.rx(faded(pmv))
    assert not bool(okv)  # the burst defeats the inner code alone


# ------------------------------------------------------- batched burst RX


@pytest.mark.parametrize("fec", ["viterbi", "ldpc11n", "rs", "ccsds"])
def test_rx_batch_bit_identical_to_per_burst(rng, fec):
    # rx_batch over [B, window] must be bit-identical
    # to per-window rx — different delay / CFO / payload per burst
    pm = PacketModem(PacketConfig(payload_bits=480, fec=fec))
    b = 4
    payloads = rng.integers(0, 2, (b, 480)).astype(np.uint8)
    caps = np.stack([
        _channel(
            np.asarray(pm.tx(payloads[i])), rng,
            delay=100 + 137 * i, cfo=(i - 1.5) * 4e-4, snr_sigma=0.08,
            capture_len=8192,
        )
        for i in range(b)
    ])
    bits_b, ok_b, diag_b = pm.rx_batch(caps)
    bits_b, ok_b = np.asarray(bits_b), np.asarray(ok_b)
    for i in range(b):
        bits_i, ok_i, diag_i = pm.rx(caps[i])
        assert (bits_b[i] == np.asarray(bits_i)).all(), fec
        assert bool(ok_b[i]) == bool(ok_i), fec
        assert int(diag_b["offset"][i]) == int(diag_i["offset"])
    assert ok_b.all()  # channel is clean enough that every burst decodes
    assert (bits_b == payloads).all()


def test_rx_batch_shape_check():
    pm = PacketModem(PacketConfig(payload_bits=480, fec="none"))
    with pytest.raises(ValueError, match="B, window"):
        pm.rx_batch(np.zeros(4096, np.complex64))


def test_ccsds_conv_interleaver(rng):
    # the circular Forney permutation as the inner interleaver: same
    # fade-burst recovery contract as the block form
    pm = PacketModem(PacketConfig(payload_bits=960, fec="ccsds",
                                  ccsds_interleaver="conv"))
    payload = rng.integers(0, 2, 960).astype(np.uint8)
    bits, ok, _ = pm.loopback(payload)
    assert bool(ok) and (np.asarray(bits) == payload).all()
    x = np.asarray(pm.tx(payload), dtype=np.complex64).copy()
    lo = pm.preamble.size + 40
    x[lo : lo + 60] *= 0.05
    x += (0.25 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
          ).astype(np.complex64)
    bits2, ok2, _ = pm.rx(x.astype(np.complex64))
    assert bool(ok2) and (np.asarray(bits2) == payload).all()


def test_ccsds_conv_interleaver_rejects_zero_rows():
    # rows=0 would reach conv_interleave_block as branches=0 and die with
    # ZeroDivisionError instead of a config error (advisor finding r4)
    with pytest.raises(ValueError, match="ccsds_interleave_rows"):
        PacketModem(PacketConfig(payload_bits=960, fec="ccsds",
                                 ccsds_interleaver="conv",
                                 ccsds_interleave_rows=0))


def test_ccsds_soft_erasures_extend_fade_budget():
    """fec="ccsds" + rs_erasures runs the max-log BCJR inner decoder
    (ops/fec.conv_decode_soft) so the outer RS sees genuine per-bit
    reliabilities and can erase the fade footprint. The r3 advisor
    finding (hard Viterbi bits -> uniform |LLR| -> erasures silently
    inert) was first fixed by rejecting the combination; this is the
    functional fix. Measured: plain ccsds dies at ~100-120 faded
    symbols, erasure mode survives 200 (2e + rho <= n - k roughly
    doubles the budget when errors become erasures)."""
    plain = PacketModem(PacketConfig(payload_bits=960, fec="ccsds"))
    eras = PacketModem(
        PacketConfig(payload_bits=960, fec="ccsds", rs_erasures=True)
    )
    seeded = np.random.default_rng(4242)
    payload = seeded.integers(0, 2, 960).astype(np.uint8)

    def faded(modem, fade_syms, seed):
        r = np.random.default_rng(seed)
        x = np.asarray(modem.tx(payload), dtype=np.complex64).copy()
        lo = modem.preamble.size + 40
        x[lo : lo + fade_syms] *= 0.05
        x += (
            0.25 * (r.normal(size=x.shape) + 1j * r.normal(size=x.shape))
        ).astype(np.complex64)
        return x.astype(np.complex64)

    for seed in (1, 2):
        cap = faded(plain, 140, seed)
        _, ok_plain, _ = plain.rx(cap)
        assert not bool(ok_plain)  # beyond the hard-decision chain
        bits, ok_eras, _ = eras.rx(cap)
        assert bool(ok_eras)
        assert (np.asarray(bits) == payload).all()


def test_rx_batch_sharded_matches_unsharded(rng, eight_devices):
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh({"channel": 8})
    pm = PacketModem(PacketConfig(payload_bits=480, fec="viterbi"))
    b = 8
    payloads = rng.integers(0, 2, (b, 480)).astype(np.uint8)
    caps = np.stack([
        _channel(np.asarray(pm.tx(payloads[i])), rng,
                 delay=150 + 31 * i, cfo=(i - 3.5) * 3e-4, snr_sigma=0.08,
                 capture_len=8192)
        for i in range(b)
    ])
    bits_s, ok_s, diag_s = pm.rx_batch_sharded(caps, mesh)
    bits_u, ok_u, diag_u = pm.rx_batch(caps)
    assert (np.asarray(bits_s) == np.asarray(bits_u)).all()
    assert (np.asarray(ok_s) == np.asarray(ok_u)).all()
    assert (np.asarray(diag_s["offset"]) == np.asarray(diag_u["offset"])).all()
    assert np.asarray(ok_s).all() and (np.asarray(bits_s) == payloads).all()
    with pytest.raises(ValueError, match="divide"):
        pm.rx_batch_sharded(caps[:6], mesh)
