"""Channelizer demo: waterfall vs polyphase filterbank, plus the
analysis -> per-channel processing -> synthesis round trip (transmux).

Builds a multi-carrier capture (three QPSK-modulated tones + noise),
then shows:

1. the plain chunked-FFT waterfall (the reference's ``plot::waterfall``
   core, src/util/plot.rs:36-99) vs the PFB waterfall — the prototype
   skirt isolates the occupied channels where the rectangle's sinc
   sidelobes smear energy everywhere;
2. channel extraction: the PFB output IS the per-channel baseband series,
   one complex sample per frame per channel;
3. the synthesis bank: zero all but the occupied channels and rebuild the
   time series — a channel-select filter implemented as mask + synthesis.

Run: python examples/channelizer.py [prefix]   (PNGs, default /tmp/aeth_chan)
"""

import _bootstrap  # noqa: F401  (offline bare-clone path setup)
import sys

import numpy as np


def main():
    from aether_primitives_tpu.models.channelizer import (
        PfbChannelizer,
        pfb_channelize,
        pfb_prototype,
        pfb_spectra,
        pfb_synthesis_taps,
        pfb_synthesize,
        waterfall_spectra,
    )
    from aether_primitives_tpu.ops import modulation, noise
    from aether_primitives_tpu.utils import plot

    pos = [a for a in sys.argv[1:] if not a.startswith("-")]
    prefix = pos[0] if pos else "/tmp/aeth_chan"

    m = 64          # channels
    frames = 256    # output frames
    n = m * frames
    rng = np.random.default_rng(815)

    # three QPSK bursts on channels 9, 24, 47. Each symbol is held for 8
    # frames so the per-channel signal is narrowband relative to the
    # channel spacing (the PFB prototype's P=8 transient settles within a
    # symbol) — the realistic "many slow carriers in one wide capture"
    # channelizer workload.
    spf = 8  # frames per symbol
    qpsk = modulation.qpsk()
    clean = np.zeros(n, np.complex64)
    t = np.arange(n)
    for chan in (9, 24, 47):
        bits = rng.integers(0, 2, size=2 * frames // spf).astype(np.uint8)
        syms = np.asarray(qpsk.modulate(bits))
        carrier = np.exp(2j * np.pi * chan / m * t).astype(np.complex64)
        clean += np.repeat(syms, m * spf).astype(np.complex64) * carrier
    x = clean + 0.05 * np.asarray(noise.new(1.0, 815).fill(n))

    print("waterfall (rectangle) vs PFB spectra")
    rect = np.asarray(waterfall_spectra(x, m, use_db=True))
    pfb = np.asarray(pfb_spectra(x, m, use_db=True))
    plot.waterfall(x, m, True, "rect waterfall", file=f"{prefix}_rect.png")
    # reuse the compare plot on one frame to show the skirt difference
    row = frames // 2
    plot.compare(
        (10 ** (rect[row] / 10)).astype(np.complex64),
        (10 ** (pfb[row] / 10)).astype(np.complex64),
        "rect vs PFB channel skirt (one frame, linear mag)",
        file=f"{prefix}_skirt.png",
    )

    print("channel extraction (PFB frames = per-channel baseband)")
    h = pfb_prototype(m, 8)
    y = np.asarray(pfb_channelize(x, m, taps=h))
    ch24 = y[:, 24]
    # sample mid-symbol (past the prototype transient) for the display
    mid = ch24[spf // 2 :: spf]
    plot.constellation(mid / np.abs(mid).mean(),
                       "channel 24 baseband (mid-symbol)",
                       file=f"{prefix}_ch24.png")

    print("transmux: mask channels, synthesize back")
    g = pfb_synthesis_taps(h, m)
    # keep each carrier plus one guard channel per side (the rect symbol
    # transitions put real energy in the first sidelobes: ±1 buys ~5 dB)
    mask = np.zeros(m, np.float32)
    for c in (9, 24, 47):
        mask[c - 1 : c + 2] = 1.0
    back = np.asarray(pfb_synthesize(y * mask, m, taps=g))
    p = -(-h.shape[-1] // m)
    q = -(-g.shape[-1] // m)
    d = (p + q - 2) // 2
    rebuilt = back[d * m : d * m + n]
    plot.time(rebuilt[: 8 * m], "masked synthesis output", file=f"{prefix}_rebuilt.png")

    # report reconstruction quality against the CLEAN signal (interior,
    # transients off): the mask drops the broadband noise, so the residual
    # is the carriers' own out-of-channel sidebands + the near-PR floor
    core = slice(q * m, n - q * m)
    num = np.linalg.norm(rebuilt[core] - clean[core])
    den = np.linalg.norm(clean[core])
    print(f"masked-synthesis residual vs clean carriers: "
          f"{20 * np.log10(num / den):.1f} dB")
    print(f"wrote {prefix}_rect.png _skirt.png _ch24.png _rebuilt.png")

    # streaming equivalence spot check
    st = PfbChannelizer(m, taps=h)
    a = np.asarray(st.step(x[: n // 2]))
    b = np.asarray(st.step(x[n // 2 :]))
    assert np.allclose(np.concatenate([a, b]), y, atol=1e-5)
    print("streaming PfbChannelizer matches one-shot: ok")


if __name__ == "__main__":
    main()
