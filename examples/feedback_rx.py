"""Feedback-loop receiver demo: a continuous QPSK stream whose sample
clock drifts (+800 ppm) and whose carrier walks (residual CFO + phase
noise) — the regime where the block feedforward estimators stop being
enough and the tracking loops take over:

    RRC matched filter
      -> Gardner timing loop   (clock-drift tracking, carrier-independent)
      -> Costas loop           (M-th power carrier PLL on the strobes)
      -> differential decode   (absorbs the loops' phase/index ambiguity)
      -> exact payload bits after the acquisition transient

Run: python examples/feedback_rx.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)

import numpy as np


def main():
    from aether_primitives_tpu.models.sync import costas_loop, gardner_loop
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops import modulation as mod
    from aether_primitives_tpu.ops import noise as noise_mod
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(815)
    sps, nsym = 4, 6000

    # --- TX: differentially coded QPSK, RRC pulse shaping ---------------
    d_idx = rng.integers(0, 4, nsym).astype(np.int32)
    # index-linear-phase QPSK on the DIAGONAL grid: costas_loop's M-th
    # power detector references the framework's diagonal constellations
    # (an axis grid would lock 45 degrees off, onto decision boundaries)
    table = (mod.psk_table(4) * np.exp(1j * np.pi / 4)).astype(np.complex64)
    tx_idx = np.asarray(mod.differential_encode(d_idx, 4))
    syms = table[tx_idx]
    up = np.zeros(nsym * sps, np.complex64)
    up[::sps] = syms
    taps = fir_mod.rrc_taps(sps, span=8, beta=0.35)
    tx = np.asarray(fir_mod.fir_filter(up, taps))

    # --- channel: clock drift, CFO, phase-noise walk, AWGN --------------
    q = 1249  # +800 ppm receive clock (resampler needs len % q == 0)
    tx = tx[: (len(tx) // q) * q]
    tx = np.asarray(sampling.resample_poly(tx, 1250, q))
    n = len(tx)
    cfo = 1.1e-4  # cycles/sample — wound phase >> 2pi over the stream
    pn = np.cumsum(rng.normal(scale=2e-3, size=n))  # oscillator random walk
    carrier = np.exp(1j * (2 * np.pi * cfo * np.arange(n) + pn))
    rx = (tx * carrier).astype(np.complex64)
    rx = np.asarray(noise_mod.new(1e-4, 815).apply(rx))

    # --- RX: matched filter -> Gardner -> Costas -> diff decode ---------
    mf = np.asarray(fir_mod.fir_filter(rx, taps))
    strobes, tau = gardner_loop(mf, sps=sps, loop_bw=0.01)
    tracked, phase, freq = costas_loop(strobes, m=4, loop_bw=0.02)
    rx_idx = np.asarray(mod.nearest_index(tracked, table))
    got = np.asarray(mod.differential_decode(rx_idx, 4))

    # --- score after the loops' acquisition transient --------------------
    settle = 600
    best, shift = 0.0, 0
    for s in range(-20, 20):
        lo = max(settle, -s)
        nn = min(len(got) - lo, nsym - lo - s)
        if nn < 100:
            continue
        agree = float(np.mean(got[lo : lo + nn] == d_idx[lo + s : lo + s + nn]))
        if agree > best:
            best, shift = agree, s
    period = float(np.mean(np.diff(np.asarray(tau)[2000:5000])))
    ppm = (period / sps - 1.0) * 1e6
    print(f"clock estimate: {period:.5f} samples/symbol ({ppm:+.0f} ppm)")
    print(f"costas residual freq: {float(np.mean(np.asarray(freq)[3000:])):+.2e} rad/symbol")
    print(f"symbol agreement after settle: {best*100:.2f}% (alignment {shift:+d})")
    if best <= 0.999:
        raise SystemExit("FAILED: tracking loops did not converge")
    print("feedback receiver: exact payload after acquisition — OK")


if __name__ == "__main__":
    main()
