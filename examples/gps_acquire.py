"""GPS L1 C/A cold acquisition: which satellites, at what code phase and
Doppler?

Builds a baseband capture containing three satellites (self-verified
IS-GPS-200 C/A codes, ``ops.sequence.gps_ca_code``) at different code
phases, Dopplers, and power levels, buried in noise — then sweeps all 32
PRNs through the cross-ambiguity function (``models.caf.ambiguity``, one
batched derotator-bank correlation per PRN on the matmul-FFT path) and
reports every satellite whose peak clears the noise floor.

Run: python examples/gps_acquire.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)


import numpy as np


def main():
    from aether_primitives_tpu.models.caf import ambiguity
    from aether_primitives_tpu.ops.sequence import gps_ca_code

    rng = np.random.default_rng(21)
    n = 1023  # one code period at 1 chip/sample
    truth = {7: (152, 2.4e-4, 1.0), 13: (641, -1.1e-4, 0.8),
             29: (307, 3.9e-4, 0.6)}
    t = np.arange(n)
    x = np.zeros(n, np.complex128)
    for prn, (tau, fd, amp) in truth.items():
        chips = 1.0 - 2.0 * gps_ca_code(prn).astype(np.float64)
        x += amp * np.roll(chips, tau) * np.exp(2j * np.pi * fd * t)
    x += 0.8 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    x = x.astype(np.complex64)

    dops = np.linspace(-5e-4, 5e-4, 41).astype(np.float32)

    def acquire(prn):
        ref = (1.0 - 2.0 * gps_ca_code(prn).astype(np.float32)).astype(
            np.complex64
        )
        surf = np.abs(np.asarray(ambiguity(x, ref, dops)))
        di, ti = np.unravel_index(surf.argmax(), surf.shape)
        # detection metric: peak over the surface's median (noise floor)
        return surf.max() / np.median(surf), ti, float(dops[di])

    detected = {}
    for prn in range(1, 33):
        metric, tau, fd = acquire(prn)
        if metric > 6.0:
            detected[prn] = (tau, fd, metric)

    print(f"{'PRN':>4} {'phase':>6} {'doppler':>10} {'metric':>7}")
    for prn, (tau, fd, metric) in sorted(detected.items()):
        true_tau, true_fd, _ = truth.get(prn, (None, None, None))
        mark = "" if true_tau is None else (
            "  <- exact" if tau == true_tau and abs(fd - true_fd) < 3e-5
            else "  <- WRONG"
        )
        print(f"{prn:4d} {tau:6d} {fd:10.2e} {metric:7.1f}{mark}")

    assert set(detected) == set(truth), (set(detected), set(truth))
    for prn, (tau, fd, _m) in detected.items():
        assert tau == truth[prn][0]
        assert abs(fd - truth[prn][1]) < 3e-5
    print(f"acquired all {len(truth)} planted satellites "
          "(exact code phase, sub-bin Doppler); no false alarms across "
          "the other 29 PRNs.")


if __name__ == "__main__":
    main()
