"""GPS L1 C/A: the full tracking channel — acquire, track, read nav bits.

The complete GNSS receiver signal path built from the framework's layers
(each independently tested; this composes them the way a receiver does):

1. **cold acquisition** — cross-ambiguity surface over code delay x
   Doppler (``models.caf.estimate_delay_doppler``) against the PRN's
   self-verified C/A code (``ops.sequence.gps_ca_code``);
2. **code tracking** — early-late DLL (``models.sync.
   code_tracking_loop``) holds the chip clock through oscillator ppm
   drift, despreading one prompt symbol per 1 ms code period;
3. **carrier tracking** — FLL-assisted Costas PLL (``models.sync.
   carrier_tracking_loop``) wipes the residual Doppler the acquisition
   grid could not resolve, putting the 50 bps nav data on the real axis;
4. **bit sync + decision** — ``models.sync.nav_bit_sync`` finds the
   20-ms bit edges and decides.

The channel is deliberately hostile: 5 ppm chip-clock offset (TCXO
class), residual CFO after acquisition, and enough noise that the raw
prompt signs are useless without the carrier loop.

Run: python examples/gnss_track.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)


import numpy as np


def main():
    from aether_primitives_tpu.models.sync import (
        carrier_tracking_loop,
        code_tracking_loop,
        nav_bit_sync,
    )
    from aether_primitives_tpu.ops.sequence import gps_ca_code

    rng = np.random.default_rng(42)
    prn = 13
    chips01 = gps_ca_code(prn)
    code = 1.0 - 2.0 * chips01.astype(np.float64)

    # ---- synthesize the received signal
    sps, n_dwells, ppm, cfo = 2, 620, 5e-6, 4e-5
    dwell = 1023 * sps
    n = (n_dwells + 3) * dwell
    s = np.arange(n, dtype=np.float64)
    chip_pos = (s - sps) * (1 + ppm) / sps
    idx = np.floor(chip_pos).astype(np.int64) % 1023
    nav_bits = rng.integers(0, 2, n_dwells // 20 + 3).astype(np.uint8)
    bit_of_dwell = (np.floor((s - sps) / dwell).astype(np.int64) + 7) // 20
    data = 1.0 - 2.0 * nav_bits[bit_of_dwell % nav_bits.size]
    x = code[idx] * data * np.exp(2j * np.pi * cfo * s)
    x += 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    x = x.astype(np.complex64)

    # ---- 1. DLL code tracking (acquisition already gave the code phase;
    # see examples/gps_acquire.py for the cold-start CAF sweep)
    prompt, tau = code_tracking_loop(
        x, chips01, sps=sps, loop_bw=0.05, n_dwells=n_dwells
    )
    mag = np.abs(np.asarray(prompt)) / 1023
    print(f"PRN {prn}: DLL locked, prompt |corr| tail mean "
          f"{mag[-50:].mean():.2f} (1.0 = full despread)")
    print(f"  chip-clock drift followed: {float(np.asarray(tau)[-1]) - float(np.asarray(tau)[0]):+.2f} "
          f"samples over {n_dwells} ms (true {-ppm * 1023 * sps * n_dwells:+.2f})")

    # ---- 2. carrier loop
    wiped, _phase, freq = carrier_tracking_loop(prompt)
    f_hat = float(np.mean(np.asarray(freq)[-100:]))
    print(f"  carrier recovered: {f_hat / dwell:+.2e} cyc/sample "
          f"(true {cfo:+.2e})")

    # ---- 3. nav bits
    settle = 60  # 3 bit periods of loop pull-in
    bits, off, quality = nav_bit_sync(np.asarray(wiped)[settle:], 20)
    bits = np.asarray(bits)
    first_dwell = settle + int(off)
    expect = nav_bits[(np.arange(bits.size) * 20 + first_dwell + 7) // 20
                      % nav_bits.size]
    agree = (bits == expect).mean()
    agree = max(agree, 1 - agree)  # Costas 180-deg ambiguity: preamble
    print(f"  bit sync: edge offset {int(off)} ms, coherence "
          f"{float(quality):.3f}")
    print(f"  nav bits recovered: {bits.size} bits at 50 bps, "
          f"{100 * agree:.1f}% agreement (mod polarity)")
    assert agree == 1.0, "nav bit recovery failed"
    print("OK")


if __name__ == "__main__":
    main()
