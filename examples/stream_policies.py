"""Stream edge policies and emission formats: what happens
when a capture doesn't divide the frame span, and how production bit
emission works.

- strict default: a precise error names the policy options;
- ``step_ragged``: demodulate every complete frame, carry the remainder
  (drop-free — the streaming receiver's policy);
- ``step_padded``: zero-pad the tail frame (the reference waterfall's
  convention, reference src/util/plot.rs:50-57);
- ``packed_bits``: MAC-layer byte emission (8 bits LSB-first), 8x less
  output than one byte per bit.

Run: python examples/stream_policies.py
"""

import _bootstrap  # noqa: F401

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from aether_primitives_tpu.models import RxChain, RxChainConfig

    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os"))
    span = chain.frame_span
    rng = np.random.default_rng(3)
    n = 3 * span + 217  # ragged on purpose
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)

    try:
        chain.step(x)
    except ValueError as e:
        print(f"strict default: {str(e)[:84]}...")

    bits, tail = chain.step_ragged(x)
    print(f"step_ragged: {bits.shape[-1]} bits from 3 whole frames, "
          f"{tail.shape[-1]}-sample remainder carried")
    # the carried tail prepends to the next capture — nothing dropped
    y = (rng.normal(size=2 * span - 217)
         + 1j * rng.normal(size=2 * span - 217)).astype(np.complex64)
    bits2, tail2 = chain.step_ragged(
        np.concatenate([np.asarray(tail), y])
    )
    assert tail2.shape[-1] == 0
    print(f"  ... next capture consumed the remainder: +{bits2.shape[-1]} "
          "bits, no leftover")

    padded = chain.step_padded(x)
    print(f"step_padded: {padded.shape[-1]} bits "
          f"({-(-n // span)} frames incl. the zero-padded tail)")

    packed = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os",
                                   packed_bits=True))
    xb = x[: 3 * span]
    flat = np.asarray(chain.step(xb))
    bytes_out = np.asarray(packed.step(xb))
    assert np.array_equal(np.unpackbits(bytes_out, bitorder="little"), flat)
    print(f"packed_bits: {flat.shape[-1]} bits -> {bytes_out.shape[-1]} "
          "bytes, unpackbits-identical (the headline bench's "
          "emission format)")
    print("stream_policies: OK")


if __name__ == "__main__":
    main()
