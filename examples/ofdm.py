"""CP-OFDM burst demo: modulate -> unknown delay + 20-tap multipath + CFO
+ AWGN -> blind CP sync (timing + CFO, no preamble) -> pilot-frame one-tap
equalization -> exact data bits.

The CP waveform's whole pitch in one script: multipath shorter than the
cyclic prefix is a per-bin complex gain (equalization is exact, not
approximate), and the prefix's self-similarity gives frame timing and CFO
for free.

Run: python examples/ofdm.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)

import numpy as np


def main():
    from aether_primitives_tpu.models.ofdm import OfdmConfig, OfdmModem, cp_sync
    from aether_primitives_tpu.models.sync import OfdmEqualizer, apply_freq_shift
    from aether_primitives_tpu.ops import noise, sequence

    cfg = OfdmConfig(fft_len=256, cp_len=32, active_bins=192)
    modem = OfdmModem(cfg)
    bpf = modem.bits_per_frame()
    rng = np.random.default_rng(2026)

    # pilot frame (known) + data frames
    pilot_bits = np.asarray(sequence.lte_gold(0x5A5, bpf))
    data_bits = rng.integers(0, 2, 12 * bpf).astype(np.uint8)
    tx = np.asarray(modem.modulate(np.concatenate([pilot_bits, data_bits])))
    print(f"TX: {len(tx)} samples, 13 OFDM symbols ({12 * bpf} data bits)")

    # channel: delay, 20-tap multipath (inside the 32-sample CP), CFO, AWGN
    delay = int(rng.integers(100, 2000))
    f0 = float(rng.uniform(-8e-4, 8e-4))
    h = np.zeros(20, np.complex64)
    h[0], h[6], h[19] = 1.0, 0.4j, -0.25 + 0.1j
    rxed = np.convolve(tx, h)
    rxed = np.concatenate([np.zeros(delay, np.complex64), rxed,
                           np.zeros(cfg.symbol_len, np.complex64)])
    rxed = rxed * np.exp(2j * np.pi * f0 * np.arange(rxed.size))
    rxed = np.asarray(noise.new(1e-5, 815).apply(rxed.astype(np.complex64)))
    print(f"channel: delay={delay}, CFO={f0:+.2e}, 20-tap multipath, AWGN")

    # blind CP sync: no preamble, the prefix itself is the sync word
    off, cfo = cp_sync(rxed, cfg)
    off, cfo = int(off), float(cfo)
    print(f"cp_sync: offset {off} (true {delay % cfg.symbol_len} mod "
          f"{cfg.symbol_len}), CFO {cfo:+.2e} (err {abs(cfo - f0):.1e})")

    fixed = np.asarray(apply_freq_shift(rxed, cfo))
    # step to the first full symbol at/after the true burst start
    start = off
    while start < delay:
        start += cfg.symbol_len
    usable = (fixed.size - start) // cfg.symbol_len * cfg.symbol_len
    spec = np.asarray(modem.spectra(fixed[start : start + usable]))

    # the first received symbol is the pilot: estimate H, equalize the rest
    pilot_tx = np.asarray(modem.modulation.modulate(pilot_bits)).reshape(1, -1)
    h_hat = OfdmEqualizer.estimate(spec[:1], pilot_tx)
    eq = np.asarray(OfdmEqualizer.apply(spec[1:13], h_hat))
    out = np.asarray(modem.modulation.demod(eq)).reshape(-1)
    ber = float((out != data_bits).mean())
    print(f"recovered {out.size} bits, BER = {ber:.2%}")
    assert ber == 0.0, "OFDM receive failed"
    print("bit-exact recovery, no preamble used.")


if __name__ == "__main__":
    main()
