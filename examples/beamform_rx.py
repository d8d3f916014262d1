"""Array receive: DOA estimation + MVDR beamforming + packet decode.

Scene: an 8-element half-wavelength ULA receives a QPSK packet burst
from one bearing while a strong in-band interferer transmits from
another. Element-wise decoding fails (interference-limited); the array
pipeline recovers the payload:

1. estimate both bearings blind with MUSIC (``models.doa``);
2. identify the packet's bearing by trying each (the packet CRC is the
   oracle — same pattern as the AMC hypothesis tests);
3. MVDR weights steer unit gain at the packet and a null at the
   interferer; the beamformed stream feeds the standard ``PacketModem``
   receiver (acquisition, CFO, soft decode, CRC).

Run: python examples/beamform_rx.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)


import numpy as np


def main():
    from aether_primitives_tpu.models import doa
    from aether_primitives_tpu.models.packet import PacketConfig, PacketModem

    rng = np.random.default_rng(11)
    m_elem = 8
    theta_pkt = np.deg2rad(18.0)
    theta_jam = np.deg2rad(-30.0)

    pm = PacketModem(PacketConfig(payload_bits=256, fec="ldpc11n"))
    payload = rng.integers(0, 2, 256).astype(np.uint8)
    burst = np.asarray(pm.tx(payload), dtype=np.complex64)

    # pad the burst into a longer observation window at unknown offset
    n = burst.size * 3
    offset = 421
    s = np.zeros(n, np.complex64)
    s[offset : offset + burst.size] = burst

    # continuous-wave-ish interferer, 12 dB stronger than the packet
    jam = (
        4.0
        * np.exp(2j * np.pi * 0.083 * np.arange(n))
        * np.exp(1j * 2 * np.pi * rng.uniform())
    ).astype(np.complex64)

    a_pkt = np.asarray(doa.steering_vector(m_elem, theta_pkt))
    a_jam = np.asarray(doa.steering_vector(m_elem, theta_jam))
    x = a_pkt[:, None] * s[None, :] + a_jam[:, None] * jam[None, :]
    x += 0.05 * (
        rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    ).astype(np.complex64)
    x = x.astype(np.complex64)

    # single element: interference-limited, decode fails
    _bits0, ok0, _ = pm.rx(x[0])
    print(f"single-element decode CRC ok: {bool(ok0)}")

    # blind bearings
    est = np.asarray(doa.estimate_doa(x, 2, method="music"))
    print(f"MUSIC bearings: {np.rad2deg(est).round(1)} deg "
          f"(true: {np.rad2deg([theta_jam, theta_pkt]).round(1)})")

    # steer at each bearing; the CRC arbitrates which one is the packet
    r = doa.covariance(x)
    recovered = None
    for th in est:
        w = np.asarray(doa.mvdr_weights(r, th))
        y = np.einsum("m,mt->t", np.conj(w), x)
        bits, ok, diag = pm.rx(y.astype(np.complex64))
        print(f"  bearing {np.rad2deg(float(th)):6.1f} deg: CRC ok = {bool(ok)}")
        if bool(ok):
            recovered = np.asarray(bits)
    assert recovered is not None, "no bearing decoded"
    assert (recovered == payload).all(), "payload mismatch"
    print("Beamformed decode: payload exact through a 12 dB-stronger "
          "interferer.")


if __name__ == "__main__":
    main()
