"""NR-style LDPC link with HARQ incremental redundancy.

Demonstrates the TS 38.212 rate-matching machinery end to end
(``ops.nr_ldpc``): a transport block is encoded once, transmitted as
redundancy version 0 at a code rate too high for the channel, fails,
and is rescued by soft-combining an rv2 retransmission — the 5G HARQ
mechanism. Each transmission is just a different window of the same
circular buffer; the receiver accumulates de-rate-matched LLRs.

Run: python examples/nr_harq.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)


import numpy as np


def main():
    from aether_primitives_tpu.ops.nr_ldpc import NrLdpc

    rng = np.random.default_rng(3)
    code = NrLdpc(z=64, bg=2, k=600)  # 600 info bits + 40 fillers
    frames, e = 64, 900  # rate 2/3 per transmission
    bits = rng.integers(0, 2, (frames, 600)).astype(np.uint8)
    sigma = 0.95  # Es/N0 ~ 0.45 dB — too noisy for rate 2/3 alone

    def transmit(rv):
        tx = np.asarray(code.encode(bits, e, rv=rv)).astype(np.float64)
        y = (1.0 - 2.0 * tx) + sigma * rng.normal(size=tx.shape)
        return (2.0 * y / sigma**2).astype(np.float32)

    # first transmission: rv0 alone
    llr0 = transmit(0)
    dec, ok = code.decode(llr0, rv=0, iters=25)
    fail0 = float((np.asarray(dec) != bits).any(axis=1).mean())
    print(f"rv0 alone (rate {600 / e:.2f}): {100 * fail0:.0f}% of frames fail")

    # HARQ: soft-combine an rv2 retransmission (different buffer window)
    buf = code.dematch(llr0, rv=0) + code.dematch(transmit(2), rv=2)
    dec2, ok2 = code.decode_buffer(buf, iters=25)
    fail2 = float((np.asarray(dec2) != bits).any(axis=1).mean())
    print(f"rv0 + rv2 combined (effective rate {600 / (2 * e):.2f}): "
          f"{100 * fail2:.0f}% fail")
    assert fail0 > 0.25 and fail2 < fail0 / 4, (fail0, fail2)
    print(f"syndrome flags agree with outcomes on "
          f"{float((np.asarray(ok2) == ~(np.asarray(dec2) != bits).any(axis=1)).mean()):.2f} "
          "of frames")
    print("OK")


if __name__ == "__main__":
    main()
