"""Wideband scanning receiver: one capture, every stage of the framework.

A 64-channel band is synthesized with signals of different modulations
and SNRs parked on a few channel centers. The scanner then, blind:

  oversampled PFB channelizer (os=2, root-Nyquist prototype)
    -> per-channel power + noise-floor estimate -> occupancy detection
    -> per occupied channel:
         blind baud-rate estimate (envelope periodogram)
         feedforward timing (Oerder-Meyr) + fractional-delay correction
         blind SNR (M2M4) and modulation classification (moment AMC)

and must rediscover exactly what was planted, channel by channel.

Run: python examples/scanner.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)

import numpy as np


def main():
    from aether_primitives_tpu.models.amc import classify_modulation
    from aether_primitives_tpu.models.channelizer import pfb_channelize_os
    from aether_primitives_tpu.models.sync import estimate_baud_rate, estimate_timing
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops import modulation as mod
    from aether_primitives_tpu.ops import sampling
    from aether_primitives_tpu.ops.frontend import estimate_snr_m2m4

    rng = np.random.default_rng(815)
    m = 64  # channels
    nsym = 3000
    sps_wide = 2 * m  # = 4 channel-rate samples/symbol after os=2 channelizing

    plan = {  # channel -> (modulation name, nominal TX level dB)
        9: ("qpsk", 22.0),
        21: ("qam16", 24.0),
        40: ("psk8", 20.0),
        52: ("bpsk", 15.0),
    }

    def shaped(name):
        mm = {
            "bpsk": mod.bpsk,
            "qpsk": mod.qpsk,
            "psk8": lambda: mod.psk(8),
            "qam16": mod.qam16,
        }[name]()
        bits = rng.integers(0, 2, nsym * mm.bits_per_symbol).astype(np.uint8)
        syms = np.asarray(mm.modulate(bits))
        up = np.zeros(nsym * sps_wide, np.complex64)
        up[::sps_wide] = syms
        taps = fir_mod.rrc_taps(sps_wide, span=6, beta=0.35)
        out = np.asarray(fir_mod.fir_filter(up, taps))
        return out / np.sqrt(np.mean(np.abs(out) ** 2))  # unit RMS

    n = nsym * sps_wide
    band = np.zeros(n, np.complex64)
    t = np.arange(n)
    for chan, (name, snr_db) in plan.items():
        sig = shaped(name)
        amp = 10 ** (snr_db / 20) * np.sqrt(1.0 / m)  # vs per-channel noise
        f = chan / m  # channel-center frequency (FFT bin convention)
        band += (amp * sig * np.exp(2j * np.pi * f * t)).astype(np.complex64)
    band += ((rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)).astype(
        np.complex64
    )

    # --- scanner -------------------------------------------------------
    frames = np.asarray(pfb_channelize_os(band, m, os=2))  # [T, m]
    power = np.mean(np.abs(frames) ** 2, axis=0)
    floor = np.median(power)
    occupied = np.where(power > 8.0 * floor)[0]
    print(f"noise floor {floor:.2f}; occupied channels: {sorted(occupied)}")
    assert sorted(occupied) == sorted(plan), (occupied, sorted(plan))

    for chan in sorted(occupied):
        x = np.ascontiguousarray(frames[:, chan])  # os=2 -> sps = 4 here
        baud = float(np.asarray(estimate_baud_rate(x)))
        sps = 1.0 / baud
        snr_db = 10 * np.log10(float(np.asarray(estimate_snr_m2m4(x))))
        # timing: correct the fractional offset, strobe symbols
        tau = float(np.asarray(estimate_timing(x, int(round(sps)))))
        fixed = np.asarray(sampling.fractional_delay(x, -tau))
        syms = fixed[:: int(round(sps))]
        syms = syms[20:-20]
        name, scores = classify_modulation(syms.astype(np.complex64))
        want, tx_level = plan[chan]
        status = "OK" if name == want else f"MISCLASSIFIED (want {want})"
        # measured SNR is per CHANNEL bandwidth (the signal occupies ~half
        # of it), so it sits below the nominal TX level by the occupancy
        # fraction + channelizer skirts — report both, assert neither
        print(
            f"ch {chan:2d}: baud 1/{sps:.2f}, in-channel SNR {snr_db:5.1f} dB "
            f"(tx level {tx_level:.0f}), {name:6s} {status}"
        )
        assert name == want, (chan, name, want)
        assert abs(sps - 4.0) < 0.05
    print("scanner: all planted signals rediscovered and classified — OK")


if __name__ == "__main__":
    main()
