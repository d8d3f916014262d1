"""FM receiver demo: two FM stations share a wideband capture; the
receiver tunes one (Ddc), discriminates it (quadrature FM demod), and
decimates to audio — recovering the transmitted message to ~1% RMS.

Exercises the analog path end-to-end: fm_mod (block-modular phase
accumulator) -> Duc (polyphase interpolation + NCO) -> sum + AWGN ->
Ddc (NCO + fused OS spectral fold) -> fm_demod -> audio lowpass/decimate.

Run: python examples/fm_radio.py
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)

import numpy as np


def main():
    from aether_primitives_tpu.models.ddc import Ddc, DdcConfig, Duc, DucConfig
    from aether_primitives_tpu.ops import analog, fir, noise

    ell = 8  # wideband rate = 8x channel rate
    dev = 0.08  # FM deviation, cycles/sample at channel rate
    stations = [(-0.29, 0.0037), (0.22, 0.0059)]  # (carrier, audio tone)
    n_chan = 1 << 15

    # ---- transmit: two stations, tone + harmonic messages ----
    t = np.arange(n_chan)
    wide = None
    messages = []
    for carrier, f_audio in stations:
        msg = (0.7 * np.sin(2 * np.pi * f_audio * t)
               + 0.2 * np.sin(2 * np.pi * 2.7 * f_audio * t)).astype(np.float32)
        messages.append(msg)
        baseband = np.asarray(analog.fm_mod(msg, dev))
        s = np.asarray(Duc(DucConfig(freq=carrier, interpolation=ell)).step(baseband))
        wide = s if wide is None else wide + s
    wide = np.asarray(noise.new(1e-5, 815).apply(wide.astype(np.complex64)))
    print(f"wideband: {len(wide)} samples, stations at "
          f"{[c for c, _ in stations]} (dev {dev} cyc/sample at channel rate)")

    # ---- receive: tune station 0, discriminate, low-pass the audio ----
    tune = 0
    carrier, f_audio = stations[tune]
    chan = np.asarray(Ddc(DdcConfig(freq=carrier, decimation=ell)).step(wide))
    audio = np.asarray(analog.fm_demod(chan, dev))
    # audio cleanup: remove discriminator noise above the message band
    from aether_primitives_tpu.models.ddc import _design_lowpass

    lp = np.real(_design_lowpass(193, 6 * f_audio)).astype(np.complex64)
    audio_f = np.real(np.asarray(fir.fir_filter(audio.astype(np.complex64), lp)))

    # align (group delays of DUC+DDC+audio LP) by peak correlation
    msg = messages[tune]
    corr = np.correlate(audio_f[:5000], msg[:4096], "valid")
    d = int(np.argmax(corr))
    # compare steady-state span
    a = audio_f[d + 256 : d + 24000]
    m = msg[256 : 24000]
    m = m[: a.size]
    rel = np.sqrt(np.mean((a - m) ** 2) / np.mean(m**2))
    print(f"station {tune}: audio recovered, delay {d}, NMSE {rel:.2%}")
    assert rel < 0.05, "FM receive failed"
    print("clean FM audio recovery.")


if __name__ == "__main__":
    main()
