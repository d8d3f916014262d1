"""Plot demo — the equivalent of the reference's examples/plotting.rs:
seeded noise through all five plots (constellation, time, compare,
spectrum, waterfall — plus the framework's Welch PSD and eye diagram).
Writes PNGs to the given prefix (default /tmp/aeth).

Run: python examples/plotting.py [prefix]
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)
import sys

import numpy as np



def main():
    from aether_primitives_tpu.ops import noise
    from aether_primitives_tpu.utils import plot

    pos = [a for a in sys.argv[1:] if not a.startswith("-")]
    prefix = pos[0] if pos else "/tmp/aeth"
    gen = noise.new(1.0, 815)

    print("Generating noise and plotting constellation")
    plot.constellation(np.asarray(gen.fill(2048)), "2048 Noise Values", f"{prefix}_constellation.png")

    print("Generating noise and plotting time signal")
    plot.time(np.asarray(gen.fill(200)), "200 Noise Values", f"{prefix}_time.png")

    print("Generating noise and plotting comparison")
    nv = np.asarray(gen.fill(400))
    plot.compare(nv[:200], nv[200:], "200 Noise Values", f"{prefix}_compare.png")

    print("Generating noise and plotting spectrum")
    plot.spectrum(np.asarray(gen.fill(2048)), 2048, True, "Noise Spectrum", f"{prefix}_spectrum.png")

    print("Generating noise and waterfall (500 x 2048)")
    cap = np.asarray(gen.fill(2048 * 500))
    plot.waterfall(cap, 2048, True, "500*2048 Noise Values", f"{prefix}_waterfall.png")

    print("Welch PSD of the capture")
    plot.psd(cap, 1024, title="Noise PSD", file=f"{prefix}_psd.png")

    print("Eye diagram of a shaped QPSK stream")
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops import modulation

    rng = np.random.default_rng(815)
    bits = rng.integers(0, 2, 2 * 400).astype(np.uint8)
    syms = np.asarray(modulation.qpsk().modulate(bits))
    up = np.zeros(400 * 8, np.complex64)
    up[::8] = syms
    shaped = np.asarray(fir_mod.fir_filter(up, fir_mod.rrc_taps(8, span=6)))
    plot.eye(shaped, sps=8, n_traces=150, title="QPSK eye", file=f"{prefix}_eye.png")
    print(f"Wrote plots with prefix {prefix}_")


if __name__ == "__main__":
    main()
