"""End-to-end QPSK modem loopback — the equivalent of the reference's
examples/modem.rs: random bits -> QPSK -> AWGN(0.01) -> hard demod ->
bit-exact assert -> time + constellation plots.

Run: python examples/modem.py [--plot out_prefix]
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)
import sys

import numpy as np



def main():
    from aether_primitives_tpu.models import Modem, ModemConfig
    from aether_primitives_tpu.ops import modulation, noise

    rng = np.random.default_rng()
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    print(f"Input bits: {bits.tolist()}")

    m = modulation.qpsk()
    symbols = m.modulate(bits)
    n = noise.new(0.01, 815)
    noisy = n.apply(symbols)
    out_bits = np.asarray(m.demod(noisy))
    assert (out_bits == bits).all(), "loopback not bit-exact"
    print("Demodulated bits match input — loopback bit-exact.")

    # same thing as one fused jitted step
    modem = Modem(ModemConfig(noise_power=0.01, seed=815))
    fused = np.asarray(modem.loopback(bits))
    assert (fused == bits).all()
    print("Fused jitted loopback bit-exact.")

    if "--plot" in sys.argv:
        prefix = sys.argv[sys.argv.index("--plot") + 1]
        from aether_primitives_tpu.utils import plot

        noisy_np = np.asarray(noisy)
        plot.time(noisy_np, "m", f"{prefix}_time.png")
        plot.constellation(noisy_np, "Modulated bits", f"{prefix}_constellation.png")
        print(f"Wrote {prefix}_time.png, {prefix}_constellation.png")


if __name__ == "__main__":
    main()
