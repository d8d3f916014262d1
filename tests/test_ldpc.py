"""LDPC: generator/parity consistency, min-sum error correction, coding
gain over uncoded BPSK, batching, and syndrome flags."""

import numpy as np
import pytest

from aether_primitives_tpu.ops import ldpc


@pytest.fixture(scope="module")
def code():
    return ldpc.make_regular_ldpc(648, 3, 6, seed=7)


def test_generator_orthogonal_to_h(code):
    h, g, info = code
    k = g.shape[0]
    assert h.shape == (324, 648)
    # band sums are dependent: rank = m - (dv-1) -> k = n - rank = 326
    assert k == 326
    assert ((g @ h.T) % 2 == 0).all()
    assert info.size == k and np.unique(info).size == k


def test_regular_degrees(code):
    h, _, _ = code
    assert (h.sum(axis=1) == 6).all()  # dc
    assert (h.sum(axis=0) == 3).all()  # dv


def test_encode_systematic_and_valid(rng, code):
    h, g, info = code
    u = rng.integers(0, 2, g.shape[0]).astype(np.uint8)
    c = np.asarray(ldpc.ldpc_encode(u, g))
    assert ((h @ c) % 2 == 0).all()
    assert (c[info] == u).all()  # message bits sit at info_indices


def test_decode_clean_roundtrip(rng, code):
    h, g, info = code
    u = rng.integers(0, 2, g.shape[0]).astype(np.uint8)
    c = np.asarray(ldpc.ldpc_encode(u, g))
    llr = 1.0 - 2.0 * c.astype(np.float32)
    hard, ok = ldpc.ldpc_decode(llr, h, iters=5)
    assert bool(ok)
    assert (np.asarray(ldpc.extract_info(hard, info)) == u).all()


def test_decode_corrects_bit_flips(rng, code):
    h, g, info = code
    u = rng.integers(0, 2, g.shape[0]).astype(np.uint8)
    c = np.array(ldpc.ldpc_encode(u, g))
    flips = rng.choice(648, size=30, replace=False)
    c[flips] ^= 1
    llr = 1.0 - 2.0 * c.astype(np.float32)
    hard, ok = ldpc.ldpc_decode(llr, h, iters=40)
    assert bool(ok)
    assert (np.asarray(ldpc.extract_info(hard, info)) == u).all()


def test_syndrome_flag_false_on_garbage(rng, code):
    h, _, _ = code
    llr = rng.normal(size=648).astype(np.float32) * 0.1
    _, ok = ldpc.ldpc_decode(llr, h, iters=3)
    assert not bool(ok)


def test_awgn_coding_gain(rng, code):
    # BPSK over AWGN at an SNR where uncoded BER ~ 2%: coded link is clean
    h, g, info = code
    n_frames = 8
    u = rng.integers(0, 2, (n_frames, g.shape[0])).astype(np.uint8)
    c = np.asarray(ldpc.ldpc_encode(u, g)).astype(np.float32)
    tx = 1.0 - 2.0 * c
    sigma = 0.69  # Q(1/0.69) ~ 7.4e-2 raw
    rx = tx + sigma * rng.normal(size=tx.shape).astype(np.float32)
    uncoded_ber = np.mean((rx < 0) != (c == 1))
    assert uncoded_ber > 0.02
    llr = 2.0 * rx / sigma**2
    hard, ok = ldpc.ldpc_decode(llr, h, iters=40)
    got = np.asarray(ldpc.extract_info(hard, info))
    assert np.asarray(ok).all()
    assert (got == u).all()


def test_batched_matches_single(rng, code):
    h, g, _ = code
    u = rng.integers(0, 2, (3, g.shape[0])).astype(np.uint8)
    c = np.asarray(ldpc.ldpc_encode(u, g)).astype(np.float32)
    rx = (1.0 - 2.0 * c) + 0.5 * rng.normal(size=c.shape).astype(np.float32)
    llr = 2.0 * rx / 0.25
    hb, okb = ldpc.ldpc_decode(llr, h, iters=10)
    for i in range(3):
        h1, ok1 = ldpc.ldpc_decode(llr[i], h, iters=10)
        assert (np.asarray(hb)[i] == np.asarray(h1)).all()
        assert bool(np.asarray(okb)[i]) == bool(ok1)


def test_rank_deficient_h_handled():
    # dependent rows just shrink the check space: k = n - rank
    h = np.zeros((4, 8), np.uint8)
    h[0, :2] = 1
    h[1, :2] = 1  # dependent row
    h[2, 2:4] = 1
    h[3, 4:6] = 1
    g = ldpc.ldpc_generator(h)
    assert g.shape == (8 - 3, 8)
    assert ((g @ h.T) % 2 == 0).all()


def test_llr_length_mismatch_raises(code):
    h, _, _ = code
    with pytest.raises(ValueError, match="length"):
        ldpc.ldpc_decode(np.zeros(100, np.float32), h)


# ----------------------------------------------------- 802.11n QC-LDPC


@pytest.fixture(scope="module")
def wifi():
    return ldpc.wifi_ldpc()


def test_qc_expand_structure():
    base = np.array([[0, -1], [2, 1]])
    h = ldpc.qc_expand(base, 3)
    assert h.shape == (6, 6)
    assert (h[:3, :3] == np.eye(3)).all()          # shift 0 = identity
    assert (h[:3, 3:] == 0).all()                  # -1 = zero block
    # shift s: block-row bit t checks bit (t+s) mod z
    assert (h[3:, :3] == np.roll(np.eye(3), -2, axis=0)).all()
    assert (h[3:, 3:] == np.roll(np.eye(3), -1, axis=0)).all()


def test_wifi_ldpc_structure(wifi):
    h, g, info = wifi
    assert h.shape == (324, 648) and g.shape == (324, 648)
    # standard code is full rank (dual-diagonal parity part invertible)
    _, _, rank = ldpc._gf2_row_reduce(h)
    assert rank == 324
    # 802.11n 648 R1/2 degree profile: row weights 7/8; parity chain
    # columns weight 2, first parity column weight 3, heavy info column 12
    assert set(np.unique(h.sum(axis=1))) == {7, 8}
    assert set(np.unique(h.sum(axis=0))) == {2, 3, 12}
    assert ((g @ h.T) % 2 == 0).all()
    # TRUE systematic: message bits are the codeword prefix
    assert (info == np.arange(324)).all()
    assert (g[:, :324] == np.eye(324, dtype=np.uint8)).all()


def test_wifi_ldpc_roundtrip_and_flips(rng, wifi):
    h, g, info = wifi
    u = rng.integers(0, 2, (4, 324)).astype(np.uint8)
    c = np.asarray(ldpc.ldpc_encode(u, g))
    assert ((c @ h.T) % 2 == 0).all()
    assert (c[:, :324] == u).all()
    llr = 4.0 * (1.0 - 2.0 * c.astype(np.float32))
    for row in llr:  # 30 flipped bits per codeword
        row[rng.choice(648, 30, replace=False)] *= -1.0
    hard, ok = ldpc.ldpc_decode(llr, h, iters=30)
    assert np.asarray(ok).all()
    assert (np.asarray(hard) == c).all()


def test_wifi_ldpc_waterfall_matches_published(rng, wifi):
    """BER/FER at fixed Eb/N0 points vs the published 802.11n n=648 R=1/2
    waterfall (BPSK/AWGN, normalized min-sum ~30 iters): the cliff sits
    between ~1.5 and ~2.5 dB — FER is tens of percent at 1.0 dB and the
    link is essentially clean by 2.5 dB. Measured here (384 frames/point,
    seed-free sim): FER 0.58 @ 1.0 dB, 0.20 @ 1.5 dB, 0.036 @ 2.0 dB,
    0 @ 2.5 dB. The test pins three points with wide statistical margins.
    """
    h, g, info = wifi
    rate = 0.5

    def fer_at(ebno_db, n_frames=128):
        sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebno_db / 10)))
        u = rng.integers(0, 2, (n_frames, 324)).astype(np.uint8)
        c = np.asarray(ldpc.ldpc_encode(u, g)).astype(np.float32)
        rx = (1.0 - 2.0 * c) + sigma * rng.normal(size=c.shape).astype(
            np.float32
        )
        llr = 2.0 * rx / sigma**2
        hard, _ok = ldpc.ldpc_decode(llr, h, iters=30)
        errs = np.asarray(hard)[:, :324] != u
        return errs.any(axis=1).mean(), errs.mean()

    fer_low, ber_low = fer_at(1.0)
    fer_mid, _ = fer_at(2.0)
    fer_hi, ber_hi = fer_at(2.5)
    # inside the waterfall at 1.0 dB (published ~0.5-0.6 FER)
    assert 0.30 < fer_low < 0.85, fer_low
    # on the cliff at 2.0 dB (published few-percent FER)
    assert fer_mid < 0.15, fer_mid
    # clean by 2.5 dB (published <1e-2 FER; 128 frames -> allow a couple)
    assert fer_hi <= 0.03, fer_hi
    assert ber_hi < 1e-3, ber_hi
    # monotone waterfall ordering
    assert fer_low > fer_mid >= fer_hi


def test_packet_modem_ldpc11n(rng):
    from aether_primitives_tpu.models.packet import PacketConfig, PacketModem

    pm = PacketModem(PacketConfig(payload_bits=600, fec="ldpc11n"))
    payload = rng.integers(0, 2, 600).astype(np.uint8)
    got, ok, _diag = pm.loopback(payload)
    assert bool(ok)
    assert (np.asarray(got) == payload).all()


def test_qc_decoder_matches_dense(rng, wifi):
    """The QC edge-message decoder runs the same normalized min-sum
    schedule as the dense plane; on any correctable channel both converge
    to the transmitted codeword (f32 column-sum ORDER differs — the dense
    plane reduces over 324 rows, the edge decoder over its 88 edges — so
    marginal undecodable frames may flip different bits)."""
    h, g, info = wifi
    u = rng.integers(0, 2, (6, 324)).astype(np.uint8)
    cw = np.asarray(ldpc.ldpc_encode(u, g)).astype(np.float32)
    sigma = 0.72  # Eb/N0 ~ 2.9 dB: comfortably decodable
    rx = (1.0 - 2.0 * cw) + sigma * rng.normal(size=cw.shape).astype(np.float32)
    llr = 2.0 * rx / sigma**2
    hd, okd = ldpc.ldpc_decode(llr, h, iters=25)
    hq, okq = ldpc.qc_ldpc_decode(llr, ldpc._WIFI_648_R12, 27, iters=25)
    both_ok = np.asarray(okd) & np.asarray(okq)
    assert both_ok.mean() > 0.5  # the channel is decodable
    assert (np.asarray(hd)[both_ok] == np.asarray(hq)[both_ok]).all()
    # flat (no batch axis) path matches the batched one exactly
    h1, ok1 = ldpc.qc_ldpc_decode(llr[0], ldpc._WIFI_648_R12, 27, iters=25)
    assert (np.asarray(h1) == np.asarray(hq)[0]).all()
    assert bool(np.asarray(ok1)) == bool(np.asarray(okq)[0])


def test_qc_decoder_corrects_and_flags(rng, wifi):
    h, g, info = wifi
    u = rng.integers(0, 2, (4, 324)).astype(np.uint8)
    cw = np.asarray(ldpc.ldpc_encode(u, g))
    llr = 4.0 * (1.0 - 2.0 * cw.astype(np.float32))
    for row in llr:
        row[rng.choice(648, 28, replace=False)] *= -1.0
    hard, ok = ldpc.qc_ldpc_decode(llr, ldpc._WIFI_648_R12, 27, iters=30)
    assert np.asarray(ok).all()
    assert (np.asarray(hard) == cw).all()
    # garbage must not satisfy the syndrome
    bad = rng.normal(size=648).astype(np.float32) * 0.1
    _, okb = ldpc.qc_ldpc_decode(bad, ldpc._WIFI_648_R12, 27, iters=3)
    assert not bool(np.asarray(okb))
