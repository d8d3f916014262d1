"""FDM transmultiplexer demo on the DDC/DUC models: three independent QPSK
streams are pulse-shaped, up-converted to separate carriers (Duc), summed
into one wideband signal, then a single channel is tuned, filtered, and
decimated back out (Ddc) and demodulated bit-exactly.

The composition the reference leaves to the user (its mixer doesn't exist
and its fir.rs is a stub) — here each direction is a streaming, jittable
stage: polyphase interpolation + exact-mod NCO up, NCO + fused
overlap-save spectral-fold decimation down.

Run: python examples/ddc.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)

import numpy as np


def main():
    from aether_primitives_tpu.models.ddc import Ddc, DdcConfig, Duc, DucConfig
    from aether_primitives_tpu.ops import fir, modulation

    ell = 8  # interpolation / decimation factor
    sps = 2  # samples/symbol at the low rate
    carriers = [-0.31, 0.02, 0.27]  # cycles/sample at the high rate
    nsym = 2048
    qpsk = modulation.qpsk()
    rng = np.random.default_rng(815)
    shaping = fir.rrc_taps(sps, span=6, beta=0.5)

    # ---- transmit side: 3 shaped streams, each up-converted ----
    streams, bits = [], []
    for ch, f in enumerate(carriers):
        b = rng.integers(0, 2, nsym * 2).astype(np.uint8)
        bits.append(b)
        syms = np.asarray(qpsk.modulate(b))
        # flush pad: room for the DUC/DDC/matched-filter group delays so
        # the last symbols survive the cascade
        up = np.zeros((nsym + 64) * sps, np.complex64)
        up[: nsym * sps : sps] = syms
        baseband = np.asarray(fir.fir_filter(up, shaping))
        streams.append(np.asarray(Duc(DucConfig(freq=f, interpolation=ell)).step(baseband)))
    wideband = np.sum(streams, axis=0).astype(np.complex64)
    print(f"wideband: {len(wideband)} samples, {len(carriers)} QPSK channels "
          f"at {carriers} cyc/sample")

    # ---- receive side: extract channel 1, matched filter, demod ----
    ch = 1
    ddc = Ddc(DdcConfig(freq=carriers[ch], decimation=ell))
    narrow = np.asarray(ddc.step(wideband))
    mf = np.asarray(fir.fir_filter(narrow, shaping))
    # group delays: DUC interp + DDC lowpass (at the low rate) + 2x RRC
    k_interp = 16 * ell + 1
    d = (k_interp - 1) // ell + (shaping.size - 1)
    pts = mf[d::sps][:nsym]
    out = np.asarray(qpsk.demod(pts / np.sqrt(np.mean(np.abs(pts) ** 2))))
    ber = float((out != bits[ch]).mean())
    print(f"channel {ch}: {len(out)} bits recovered, BER = {ber:.2%}")
    assert ber == 0.0, "transmux demod failed"
    print("bit-exact through Duc -> FDM sum -> Ddc.")


if __name__ == "__main__":
    main()
