"""FEC tests: convolutional encoder vs an independent bit-serial reference,
Viterbi hard/soft decode roundtrips, error correction, and coded-vs-uncoded
gain through the modulation stack."""

import numpy as np
import pytest

from aether_primitives_tpu.ops import fec


def _encode_ref(bits, polys, k):
    """Independent bit-serial reference encoder (shift register)."""
    state = [0] * (k - 1)  # newest first
    out = []
    for b in list(bits) + [0] * (k - 1):
        reg = [b] + state
        for p in polys:
            taps = [(p >> (k - 1 - j)) & 1 for j in range(k)]
            out.append(sum(t * r for t, r in zip(taps, reg)) % 2)
        state = [b] + state[:-1]
    return np.array(out, np.uint8)


@pytest.mark.parametrize("polys,k", [((0o7, 0o5), 3), ((0o171, 0o133), 7)])
def test_conv_encode_matches_bit_serial_reference(rng, polys, k):
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    got = np.asarray(fec.conv_encode(bits, polys, k))
    ref = _encode_ref(bits, polys, k)
    assert (got == ref).all()


def test_conv_encode_k3_known_vector():
    # classic (7,5) K=3 example: input 1 0 1 1 -> 11 10 00 01, then flush
    got = np.asarray(
        fec.conv_encode(np.array([1, 0, 1, 1], np.uint8), (0o7, 0o5), 3)
    )
    assert (got[:8] == np.array([1, 1, 1, 0, 0, 0, 0, 1], np.uint8)).all()


@pytest.mark.parametrize("polys,k", [((0o7, 0o5), 3), ((0o171, 0o133), 7)])
def test_viterbi_clean_roundtrip(rng, polys, k):
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits, polys, k))
    out = np.asarray(fec.viterbi_decode(fec.hard_to_llr(coded), polys, k))
    assert out.shape == bits.shape
    assert (out == bits).all()


def test_viterbi_corrects_bit_errors(rng):
    bits = rng.integers(0, 2, 1000).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits))
    # flip 3% of the coded bits (well inside K=7 rate-1/2 correction power)
    flips = rng.choice(coded.size, size=coded.size * 3 // 100, replace=False)
    corrupted = coded.copy()
    corrupted[flips] ^= 1
    out = np.asarray(fec.viterbi_decode(fec.hard_to_llr(corrupted)))
    assert (out == bits).all()


def test_viterbi_soft_beats_hard(rng):
    # QPSK at low SNR: soft-decision decoding corrects where hard fails
    from aether_primitives_tpu.ops import modulation

    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, 4000).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits))
    syms = np.asarray(qpsk.modulate(coded))
    sigma = 0.85  # per-component noise std on the +-1 grid
    noisy = (syms + sigma * (rng.normal(size=syms.size)
                             + 1j * rng.normal(size=syms.size))).astype(np.complex64)
    llr_soft = np.asarray(qpsk.demod_soft(noisy, noise_var=sigma**2)).reshape(-1)
    hard_bits = np.asarray(qpsk.demod(noisy))
    out_soft = np.asarray(fec.viterbi_decode(llr_soft))
    out_hard = np.asarray(fec.viterbi_decode(fec.hard_to_llr(hard_bits)))
    ber_soft = (out_soft != bits).mean()
    ber_hard = (out_hard != bits).mean()
    ber_uncoded = (hard_bits[: 2 * 2000] != coded[: 2 * 2000]).mean()
    assert ber_soft < ber_hard or (ber_soft == 0 and ber_hard == 0)
    assert ber_soft < 0.3 * ber_uncoded


def test_viterbi_unterminated(rng):
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits, terminate=False))
    out = np.asarray(
        fec.viterbi_decode(fec.hard_to_llr(coded), terminated=False)
    )
    # truncated decoding is exact except possibly the last few bits
    assert (out[:-10] == bits[:-10]).all()


def test_viterbi_rejects_bad_input(rng):
    with pytest.raises(ValueError, match="multiple"):
        fec.viterbi_decode(np.zeros(7, np.float32))
    # 2-D input is the BATCHED contract now (round 5): leading axes
    # decode independently and match per-stream decoding bit for bit
    bits = rng.integers(0, 2, (2, 60)).astype(np.uint8)
    encs = np.stack([np.asarray(fec.conv_encode(bits[i])) for i in range(2)])
    llrs = (1 - 2.0 * encs).astype(np.float32) * 4
    out = np.asarray(fec.viterbi_decode(llrs))
    assert np.array_equal(out, bits)
    for i in range(2):
        assert np.array_equal(
            np.asarray(fec.viterbi_decode(llrs[i])), bits[i]
        )


def test_interleaver_roundtrip_and_burst_spread(rng):
    x = rng.integers(0, 2, 640).astype(np.uint8)
    inter = np.asarray(fec.interleave(x, 16))
    assert (np.asarray(fec.deinterleave(inter, 16)) == x).all()
    # a burst of up to rows=16 errors lands >= cols-1 = 39 apart originally
    hit = np.zeros(640, bool)
    hit[100:116] = True
    orig_positions = np.where(np.asarray(fec.deinterleave(hit, 16)))[0]
    assert np.diff(orig_positions).min() >= 39


def test_interleaved_viterbi_survives_burst(rng):
    bits = rng.integers(0, 2, 984).astype(np.uint8)  # 984+6 flush -> 1980
    coded = np.asarray(fec.conv_encode(bits))
    inter = np.asarray(fec.interleave(coded, 30))
    corrupted = inter.copy()
    corrupted[500:530] ^= 1  # a 30-bit burst: fatal without interleaving
    out = np.asarray(
        fec.viterbi_decode(fec.hard_to_llr(fec.deinterleave(corrupted, 30)))
    )
    assert (out == bits).all()
    # control: the same burst without interleaving breaks the decoder
    direct = coded.copy()
    direct[500:530] ^= 1
    out2 = np.asarray(fec.viterbi_decode(fec.hard_to_llr(direct)))
    assert (out2 != bits).any()


# ---------------------------------------------------------------- CRC


def _crc_serial(bits, poly, width, init=0):
    """Independent bit-serial MSB-first CRC register (no reflection)."""
    reg = init
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for b in bits:
        fb = ((reg >> (width - 1)) & 1) ^ int(b)
        reg = ((reg << 1) & mask) ^ (poly if fb else 0)
    return reg


def _bits_to_int(vec):
    """MSB-first bit vector -> int."""
    out = 0
    for b in np.asarray(vec):
        out = (out << 1) | int(b)
    return out


def test_crc32_matches_zlib(rng):
    import zlib

    for n in (1, 2, 3, 9, 64, 511, 512, 513, 1000):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert fec.crc32(data) == zlib.crc32(data), n


def test_crc16_ccitt_check_value():
    # CRC-16/CCITT-FALSE("123456789") = 0x29B1 (standard check value)
    bits = np.unpackbits(np.frombuffer(b"123456789", np.uint8))  # MSB-first
    got = _bits_to_int(fec.crc_bits(bits, "crc16-ccitt"))
    assert got == 0x29B1


def test_crc8_check_value():
    # CRC-8/SMBUS("123456789") = 0xF4
    bits = np.unpackbits(np.frombuffer(b"123456789", np.uint8))
    assert _bits_to_int(fec.crc_bits(bits, "crc8")) == 0xF4


def test_crc_compute_matches_bit_serial(rng):
    poly, width, init = 0x1021, 16, 0xFFFF
    for n in (200, 512, 700):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        got = _bits_to_int(fec.crc_compute(bits, poly, width, init))
        assert got == _crc_serial(bits, poly, width, init), n


def test_crc_compute_short_message_edge(rng):
    # n < width exercises the dedicated small-matrix path
    poly, width, init = 0x04C11DB7, 32, 0xFFFFFFFF
    for n in (1, 5, 31):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        got = _bits_to_int(fec.crc_compute(bits, poly, width, init))
        assert got == _crc_serial(bits, poly, width, init), n


def test_crc_block_size_invariance(rng):
    bits = rng.integers(0, 2, 777).astype(np.uint8)
    a = np.asarray(fec.crc_compute(bits, 0x04C11DB7, 32, 0xFFFFFFFF, block=64))
    b = np.asarray(fec.crc_compute(bits, 0x04C11DB7, 32, 0xFFFFFFFF, block=512))
    assert (a == b).all()


def test_crc_append_check_and_detection(rng):
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    frame = np.asarray(fec.crc_append(bits, "crc32"))
    assert bool(fec.crc_check(frame, "crc32"))
    for pos in (0, 150, 299, 320):
        bad = frame.copy()
        bad[pos] ^= 1
        assert not bool(fec.crc_check(bad, "crc32")), pos


def test_viterbi_windowed_matches_full_block(rng):
    """Windowed truncated-traceback decode (the streaming idiom) equals
    the full-block ML decode through error bursts when the guard covers
    the survivor-merge depth (~5-7 K). Windowed is the long-stream mode
    (a 1M-bit stream is ~224 batched steps windowed vs a million serial
    ACS steps full-block)."""
    for nbits in (1024, 777):
        bits = rng.integers(0, 2, nbits).astype(np.uint8)
        coded = np.asarray(fec.conv_encode(bits))
        llr = 4.0 * (1.0 - 2.0 * coded.astype(np.float32))
        idx = rng.choice(llr.size, int(0.03 * llr.size), replace=False)
        llr[idx] *= -1.0
        full = np.asarray(fec.viterbi_decode(llr))
        win = np.asarray(fec.viterbi_decode(llr, window=128, guard=48))
        assert (full == bits).all()
        assert (win == full).all()


def test_viterbi_windowed_exact_head_tail_small_guard(rng):
    # advisor finding r3: head/tail bits must honor the known state-0
    # start/termination. With the boundary constraints in the pads, the
    # first and last bits match the full-block ML decode even at a guard
    # too short for survivor merge to do the job probabilistically.
    bits = rng.integers(0, 2, 4000).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits))
    llr = np.asarray(fec.hard_to_llr(coded)).astype(np.float32)
    flip = rng.random(llr.shape) < 0.03
    llr = np.where(flip, -llr, llr)
    full = np.asarray(fec.viterbi_decode(llr))
    win = np.asarray(fec.viterbi_decode(llr, window=128, guard=8))
    assert (full[:16] == win[:16]).all()
    assert (full[-16:] == win[-16:]).all()


def test_conv_decode_soft_matches_viterbi(rng):
    """Max-log BCJR soft-output decode: hard decisions equal the Viterbi
    ML decode on clean and moderately noisy streams (bitwise-MAP and
    sequence-ML agree away from the failure region)."""
    bits = rng.integers(0, 2, 600).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits))
    llr = 4.0 * (1.0 - 2.0 * coded.astype(np.float32))
    soft = np.asarray(fec.conv_decode_soft(llr))
    assert soft.shape == (600,)
    assert ((soft < 0).astype(np.uint8) == bits).all()

    sigma = 0.8
    y = (1 - 2.0 * coded.astype(np.float64)) + sigma * rng.normal(
        size=coded.shape
    )
    nllr = (2 * y / sigma**2).astype(np.float32)
    soft = np.asarray(fec.conv_decode_soft(nllr))
    hard_v = np.asarray(fec.viterbi_decode(nllr))
    assert ((soft < 0).astype(np.uint8) == hard_v).mean() > 0.995


def test_conv_decode_soft_reliability_marks_fades(rng):
    """The point of soft output: bits the decoder gets WRONG must carry
    much lower |LLR| than bits it gets right — a fade's footprint is
    flaggable downstream (this is what enables ccsds+rs_erasures)."""
    bits = rng.integers(0, 2, 2000).astype(np.uint8)
    coded = np.asarray(fec.conv_encode(bits))
    sigma = 0.5
    y = (1 - 2.0 * coded.astype(np.float64)) + sigma * rng.normal(
        size=coded.shape
    )
    y[800:1100] = 0.05 * rng.normal(size=300)  # deep fade
    llr = (2 * y / sigma**2).astype(np.float32)
    soft = np.asarray(fec.conv_decode_soft(llr))
    err = (soft < 0).astype(np.uint8) != bits
    assert err.any()  # the fade genuinely defeats the code
    assert np.abs(soft[err]).mean() < 0.1 * np.abs(soft[~err]).mean()


def test_conv_interleaver_cascade_is_pure_delay(rng):
    """Forney interleaver -> deinterleaver = identity delayed by
    (I-1)*cell*I samples (zeros ahead of the stream head)."""
    i_br, m = 4, 3
    depth = (i_br - 1) * m * i_br
    x = rng.integers(0, 256, 400).astype(np.float32)
    y, _ = fec.conv_interleave(x, i_br, m)
    z, _ = fec.conv_deinterleave(np.asarray(y), i_br, m)
    z = np.asarray(z)
    assert (z[:depth] == 0).all()
    assert np.array_equal(z[depth:], x[: 400 - depth])


def test_conv_interleaver_streaming_matches_contiguous(rng):
    """Chunked interleaving with threaded state is bit-identical to one
    contiguous call — the FIR history= contract for interleavers."""
    i_br, m = 12, 17
    x = rng.integers(0, 2, 1200).astype(np.float32)
    y_all, _ = fec.conv_interleave(x, i_br, m)
    state = None
    chunks = []
    for lo in range(0, 1200, 240):
        yc, state = fec.conv_interleave(x[lo: lo + 240], i_br, m, state)
        chunks.append(np.asarray(yc))
    assert np.array_equal(np.concatenate(chunks), np.asarray(y_all))


def test_conv_interleaver_block_permutation_and_spreading(rng):
    """The circular (framed) form is a true permutation, roundtrips
    exactly, and spreads an I-length channel burst to >= cell*I - 1
    spacing after deinterleaving."""
    i_br, m, n = 4, 3, 240
    x = np.arange(n).astype(np.int32)
    y = np.asarray(fec.conv_interleave_block(x, i_br, m))
    assert len(set(y.tolist())) == n
    assert np.array_equal(
        np.asarray(fec.conv_deinterleave_block(y, i_br, m)), x
    )
    err = np.zeros(n, np.int32)
    err[100: 100 + i_br] = 1
    d = np.asarray(fec.conv_deinterleave_block(err, i_br, m))
    pos = np.sort(np.where(d)[0])
    assert np.diff(pos).min() >= m * i_br - 1


def test_conv_soft_windowed_matches_full_block(rng):
    """Windowed parallel max-log BCJR (round 5): sign-identical to the
    exact full-block recursion at the operating guard, and batched ==
    per-stream."""
    bits = rng.integers(0, 2, 800).astype(np.uint8)
    enc = np.asarray(fec.conv_encode(bits))
    llr = ((1 - 2.0 * enc) * 2
           + rng.normal(size=enc.shape)).astype(np.float32)
    full = np.asarray(fec.conv_decode_soft(llr))
    wx = np.asarray(fec.conv_decode_soft(llr, window=96, guard=64,
                                         backend="xla"))
    assert ((wx < 0) == (full < 0)).all()  # signs exact at this guard
    assert np.corrcoef(wx, full)[0, 1] > 0.999

    B = 3
    bb = rng.integers(0, 2, (B, 500)).astype(np.uint8)
    encs = np.stack([np.asarray(fec.conv_encode(bb[i])) for i in range(B)])
    llrs = ((1 - 2.0 * encs) * 2
            + rng.normal(size=encs.shape)).astype(np.float32)
    wb = np.asarray(fec.conv_decode_soft(llrs, window=96, guard=64,
                                         backend="xla"))
    for i in range(B):
        assert np.array_equal(
            wb[i],
            np.asarray(fec.conv_decode_soft(llrs[i], window=96, guard=64,
                                            backend="xla")),
        )
    assert np.array_equal((wb < 0).astype(np.uint8), bb)


def test_conv_soft_windowed_rejects_non_rate_half():
    with pytest.raises(ValueError, match="rate-1/2"):
        fec.conv_decode_soft(np.zeros(300, np.float32), (0o7, 0o5, 0o7), 3,
                             window=32)


def test_decoder_backend_typos_rejected():
    # a backend typo must raise, not silently select the XLA path
    from aether_primitives_tpu.ops import turbo as _turbo

    llr = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match="backend"):
        fec.viterbi_decode(llr, backend="palas")
    with pytest.raises(ValueError, match="backend"):
        fec.conv_decode_soft(llr, window=16, guard=8, backend="palas")
    with pytest.raises(ValueError, match="backend"):
        _turbo.turbo_decode(llr[:20], llr[:20], llr[:20],
                            iterations=1, window=8, guard=4,
                            bcjr_backend="palas")
