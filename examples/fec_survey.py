"""FEC family survey: every decoder in the framework on one AWGN axis.

One script exercises the complete channel-coding surface — Viterbi,
802.11n QC-LDPC, NR-style LDPC with rate matching, Reed-Solomon,
binary BCH (hard and Chase-2 soft), turbo product code, convolutional
turbo, and polar (CA-SCL and flooding BP) — encoding random data,
passing BPSK-equivalent AWGN at a common Eb/N0, and decoding, then
prints a rate/BER/BLER table. Every family is the SAME batched jitted
style, so the whole survey is a handful of device calls per code.

Numbers are smoke-scale (a few hundred blocks), not publication
curves; the per-family tests in ``tests/`` hold the rigorous
waterfall/BLER assertions. Run: python examples/fec_survey.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)
import math

import numpy as np


def _awgn_llr(cw, ebn0_db, rate, rng):
    """BPSK AWGN channel at the given Eb/N0 for a rate-``rate`` code."""
    sigma = math.sqrt(1 / (2 * rate * 10 ** (ebn0_db / 10)))
    y = (1 - 2 * np.asarray(cw).astype(np.float64)) + sigma * rng.normal(
        size=np.shape(cw)
    )
    return (2 * y / sigma**2).astype(np.float32), sigma


def main():
    import jax


    from aether_primitives_tpu.ops import bch, fec, ldpc, polar, rs, tpc, turbo
    from aether_primitives_tpu.ops.nr_ldpc import NrLdpc

    rng = np.random.default_rng(815)
    ebn0 = 3.0
    rows = []

    def report(name, rate, data, dec, extra=""):
        data = np.asarray(data)
        dec = np.asarray(dec)
        ber = (dec != data).mean()
        bler = (dec != data).reshape(data.shape[0], -1).any(axis=1).mean()
        rows.append((name, rate, ber, bler, extra))

    # ---- convolutional (K=7 rate 1/2, Viterbi ML)
    B, n_info = 32, 400
    data = rng.integers(0, 2, (B, n_info)).astype(np.uint8)
    coded = np.asarray(jax.vmap(fec.conv_encode)(data))
    llr, _ = _awgn_llr(coded, ebn0, 0.5, rng)
    dec = jax.vmap(fec.viterbi_decode)(llr)
    report("conv K=7 Viterbi", 0.5, data, dec)

    # ---- 802.11n QC-LDPC n=648 (QC edge-message min-sum)
    h, g, info = ldpc.wifi_ldpc()
    B = 96
    data = rng.integers(0, 2, (B, g.shape[0])).astype(np.uint8)
    cw = np.asarray(ldpc.ldpc_encode(data, g))
    llr, _ = _awgn_llr(cw, ebn0, 0.5, rng)
    hard, _ok = ldpc.qc_ldpc_decode(llr, ldpc._WIFI_648_R12, 27, iters=30)
    dec = ldpc.extract_info(hard, info)
    report("802.11n QC-LDPC 648", 0.5, data, dec)

    # ---- NR-style QC-LDPC BG2 with rate matching
    nr = NrLdpc(z=64, bg=2, k=500)
    B = 64
    data = rng.integers(0, 2, (B, 500)).astype(np.uint8)
    cw = np.asarray(nr.encode(data, 1000))
    llr, _ = _awgn_llr(cw, ebn0, 0.5, rng)
    dec, _ok = nr.decode(llr, iters=30)
    report("NR-style LDPC BG2", 0.5, data, dec)

    # ---- Reed-Solomon (255, 223) over GF(2^8), hard symbols
    code = rs.rs_255_223()
    B = 16
    data = rng.integers(0, 256, (B, 223)).astype(np.uint8)
    cw = code.encode(data)
    cbits = np.asarray(rs.symbols_to_bits(cw))
    llr, _ = _awgn_llr(cbits, ebn0, 223 / 255, rng)
    syms = rs.bits_to_symbols((llr < 0).astype(np.uint8))
    dec, _ok, _ = code.decode(syms)
    report("RS(255,223) hard", 223 / 255, data, dec)

    # ---- binary BCH (255,191,t=8): hard and Chase-2 soft
    c = bch.BCH(255, 8)
    B = 48
    data = rng.integers(0, 2, (B, c.k)).astype(np.uint8)
    cw = np.asarray(c.encode(data))
    llr, _ = _awgn_llr(cw, ebn0, c.k / 255, rng)
    dec, _ok, _ = c.decode((llr < 0).astype(np.uint8))
    report("BCH(255,191) hard", c.k / 255, data, dec)
    dec, _ok = c.decode_soft(llr, p=4)
    report("BCH(255,191) Chase-2", c.k / 255, data, dec)

    # ---- closed-form t=2 BCH (255,239): scan-free hard + Chase soft
    c2 = bch.BCH(255, 2)
    data = rng.integers(0, 2, (B, c2.k)).astype(np.uint8)
    cw = np.asarray(c2.encode(data))
    llr, _ = _awgn_llr(cw, ebn0, c2.k / 255, rng)
    dec, _ok = c2.decode_soft(llr, p=4)
    report("BCH(255,239) Chase-2", c2.k / 255, data, dec)

    # ---- turbo product code (32,26)^2
    t = tpc.TPC(m=5, p=4, iters=4)
    B = 32
    data = rng.integers(0, 2, (B, t.k, t.k)).astype(np.uint8)
    cw = np.asarray(t.encode(data))
    llr, _ = _awgn_llr(cw, ebn0, t.rate, rng)
    dec, _ok = t.decode(llr)
    report("TPC(32,26)^2", t.rate, data, dec)

    # ---- the stronger 802.16-class t=2 BCH square
    t2 = tpc.TPC(m=6, p=4, iters=4, t_component=2)
    B = 16
    data = rng.integers(0, 2, (B, t2.k, t2.k)).astype(np.uint8)
    cw = np.asarray(t2.encode(data))
    llr, _ = _awgn_llr(cw, ebn0, t2.rate, rng)
    dec, _ok = t2.decode(llr)
    report("TPC(64,51)^2 t=2", t2.rate, data, dec)

    # ---- convolutional turbo (rate 1/3, 8 iterations)
    B, n_info = 24, 400
    rate = n_info / (3 * n_info + 6)
    data = rng.integers(0, 2, (B, n_info)).astype(np.uint8)

    def tenc(b):
        s, p1, p2, ts, tp = turbo.turbo_encode(b)
        return np.concatenate(
            [np.asarray(s), np.asarray(p1), np.asarray(p2),
             np.asarray(ts), np.asarray(tp)]
        )

    cw = np.stack([tenc(b) for b in data])
    llr, _ = _awgn_llr(cw, ebn0, rate, rng)

    def tdec(v):
        nb = n_info
        out, _l = turbo.turbo_decode(
            v[:nb], v[nb:2 * nb], v[2 * nb:3 * nb],
            v[3 * nb:3 * nb + 3], v[3 * nb + 3:], iterations=8,
        )
        return out

    dec = jax.vmap(tdec)(llr)
    report("turbo 1/3 8it", rate, data, dec)

    # ---- polar (256,128): CA-SCL L=8 and flooding BP
    pc = polar.PolarCode(n=256, k=128, design_snr_db=1.0, crc="crc8",
                         list_size=8)
    B = 64
    data = rng.integers(0, 2, (B, pc.payload_bits)).astype(np.uint8)
    cw = np.asarray(pc.encode(data))
    llr, _ = _awgn_llr(cw, ebn0, 0.5, rng)
    dec, _ok = pc.decode(llr)
    report("polar CA-SCL L=8", 0.5, data, dec)
    dec, _ok = pc.decode_bp(llr, iters=40)
    report("polar BP 40it", 0.5, data, dec)

    # ---- table
    print(f"\nFEC survey @ Eb/N0 = {ebn0} dB (BPSK AWGN, smoke-scale)\n")
    print(f"{'code':<24}{'rate':>6}{'BER':>12}{'BLER':>9}")
    for name, rate, ber, bler, extra in rows:
        print(f"{name:<24}{rate:>6.3f}{ber:>12.2e}{bler:>9.3f}{extra}")

    # the families built for this operating point must be clean here
    strong = {"802.11n QC-LDPC 648", "TPC(32,26)^2", "TPC(64,51)^2 t=2",
              "turbo 1/3 8it", "polar CA-SCL L=8"}
    for name, rate, ber, bler, _ in rows:
        if name in strong:
            assert bler < 0.1, f"{name} BLER {bler} out of family"
    print(
        "\n(the high-rate algebraic rows — RS 0.875, BCH 0.749 — need a"
        "\nhigher operating point by Shannon's accounting; at 3 dB the"
        "\ntable shows the rate/performance trade, not a defect)"
    )
    print("\nall strong-family BLERs inside expectations")


if __name__ == "__main__":
    main()
