"""Complete burst receiver demo: TX burst -> realistic channel (unknown
delay, multipath, carrier frequency offset, AWGN) + analog front end
(DC offset, IQ imbalance, low drive level) -> front-end conditioning
(DC removal, blind IQ-imbalance correction, AGC) -> timing acquisition
(matched-filter preamble detection) -> CFO estimation/correction
(Schmidl-Cox) -> RX chain -> pilot-based per-subcarrier equalization ->
exact data bits.

Run: python examples/receiver.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)

import numpy as np



def main():
    from aether_primitives_tpu.models import (
        OfdmEqualizer,
        RxChain,
        RxChainConfig,
        TxChain,
        detect_preamble,
        loopback_delay,
    )
    from aether_primitives_tpu.models.sync import apply_freq_shift, estimate_cfo
    from aether_primitives_tpu.ops import modulation, noise, sequence

    cfg = RxChainConfig(fft_len=256, decimation=4, active_bins=128)
    tx, rx = TxChain(cfg), RxChain(cfg)
    bpf = tx.bits_per_frame()
    rng = np.random.default_rng(2026)  # deterministic demo

    # ---- transmitter: preamble + pilot frame + data frames ----
    pilot_bits = np.asarray(sequence.lte_gold(0x5A5, bpf))
    data_bits = rng.integers(0, 2, 4 * bpf).astype(np.uint8)
    burst = np.asarray(tx.step(np.concatenate([pilot_bits, data_bits])))
    rep = 128
    half = np.asarray(
        modulation.qpsk().modulate(np.asarray(sequence.lte_gold(0x77, 2 * rep)))
    )
    preamble = np.concatenate([half, half])
    signal = np.concatenate([preamble, burst])
    print(f"TX burst: {len(signal)} samples ({4 * bpf} data bits)")

    # ---- channel: delay, multipath, CFO, noise ----
    delay = int(rng.integers(200, 3000))
    f0 = float(rng.uniform(-3e-4, 3e-4))
    h_chan = np.zeros(5, np.complex64)
    h_chan[0], h_chan[2] = 1.0, 0.2 + 0.1j
    rxed = np.convolve(signal, h_chan)
    rxed = np.concatenate([np.zeros(delay, np.complex64), rxed,
                           np.zeros(4 * cfg.fft_len * cfg.decimation, np.complex64)])
    rxed = (rxed * np.exp(2j * np.pi * f0 * np.arange(len(rxed)))).astype(np.complex64)
    rxed = np.asarray(noise.new(1e-6, 815).apply(rxed))
    print(f"channel: delay={delay}, CFO={f0:+.2e} cyc/sample, 3-tap multipath, AWGN")

    # ---- analog front end: low drive, Q-arm imbalance, DC offset ----
    from aether_primitives_tpu.ops import frontend

    rxed = np.asarray(
        frontend.apply_iq_imbalance(0.06 * rxed, gain=1.08, phase=0.04)
    ) + np.complex64(0.013 - 0.008j)
    print("front end: x0.06 level, IQ gain 1.08 / phase 0.04 rad, DC offset")

    # ---- front-end conditioning (all blind) ----
    rxed = np.asarray(frontend.remove_dc(rxed))
    g_hat, ph_hat = (float(np.asarray(v)) for v in
                     frontend.estimate_iq_imbalance(rxed))
    rxed = np.asarray(frontend.correct_iq_imbalance(rxed, g_hat, ph_hat))
    # one-shot level recovery: a burst capture is mostly silence, so a
    # block AGC would pump between noise-floor and burst gains mid-burst
    # (frontend.agc is for continuous streams); normalize the capture once
    rxed = np.asarray(frontend.normalize_rms(rxed))
    print(f"conditioned: IQ estimate gain={g_hat:.3f} phase={ph_hat:+.3f}, "
          f"level normalized to rms {np.sqrt(np.mean(np.abs(rxed)**2)):.3f}")

    # ---- receiver ----
    off, metric = detect_preamble(rxed, preamble)
    off = int(off)
    print(f"timing: preamble at {off} (metric {float(metric):.2f})")
    f_hat = float(estimate_cfo(rxed[off:], rep))
    print(f"CFO estimate: {f_hat:+.2e} (error {abs(f_hat - f0):.1e})")
    corrected = np.asarray(apply_freq_shift(rxed, f_hat))

    start = off + len(preamble) + loopback_delay(tx, rx)
    span = cfg.fft_len * cfg.decimation
    spec = np.asarray(rx.spectra(corrected[start : start + 5 * span]))
    h = OfdmEqualizer.estimate(spec[0], np.asarray(rx.modulation.modulate(pilot_bits)))
    out_bits = np.asarray(rx.demod_spectra(OfdmEqualizer.apply(spec[1:], h)))
    ber = float((out_bits != data_bits).mean())
    print(f"recovered {len(out_bits)} bits, BER = {ber:.2%}")
    assert ber == 0.0, "receiver failed"
    print("bit-exact recovery.")


if __name__ == "__main__":
    main()
