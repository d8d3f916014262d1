"""Matmul-precision trade-off for the fused RX frame op, on the device.

``Precision.HIGHEST`` asks for full f32 in every matmul; ``HIGH`` allows
bf16x3 (or TF32 where the device has it). This script measures both
accuracy (EVM vs a float64 reference, demod bit agreement) and speed of
`fir_decimate_fft` at each setting, to decide whether the chain can run
at HIGH.

Usage: python benches/precision_experiment.py [--cpu] [--n 4194304]
"""

try:
    import aether_primitives_tpu  # noqa: F401
except ModuleNotFoundError:  # bare offline clone: resolve the in-tree package
    import os as _os
    import sys as _sys

    _sys.path.append(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 22)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.cli import _Digest, marginal_cost
    from aether_primitives_tpu.evm import evm_rms_db
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops.fft import Scale

    dev = jax.devices()[0]
    dec, n_fft = 4, 2048
    span = dec * n_fft
    n = args.n
    rng = np.random.default_rng(815)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    from aether_primitives_tpu.models.modem import _default_lowpass

    taps = _default_lowpass(65, 1.0 / 8)

    # f64 reference spectra for the accuracy gate (first 16 frames)
    nref = span * 16
    y = np.convolve(x[:nref].astype(np.complex128), taps.astype(np.complex128))[:nref]
    ref = np.fft.fft(y.reshape(-1, span)[:, ::dec], axis=-1) / np.sqrt(
        np.float64(n_fft)
    )

    blk = jax.device_put(
        Split(x.real.copy(), x.imag.copy()), dev
    )
    digest = _Digest()

    for name, prec in [
        ("HIGHEST", jax.lax.Precision.HIGHEST),
        ("HIGH", jax.lax.Precision.HIGH),
        ("DEFAULT", jax.lax.Precision.DEFAULT),
    ]:
        def spectra(b, p=prec):
            return fir_mod.fir_decimate_fft(
                b.to_complex(), taps, dec, n_fft, Scale.SN, precision=p
            )

        fn = jax.jit(spectra)
        out = fn(blk)
        jax.block_until_ready(out)
        digest(out)
        # accuracy: pull the first 16 frames to host as split planes
        head = jax.jit(
            lambda b, p=prec: (lambda s: (s.real, s.imag))(
                fir_mod.fir_decimate_fft(
                    b.to_complex()[: span * 16], taps, dec, n_fft,
                    Scale.SN, precision=p,
                )
            )
        )(blk)
        got = np.asarray(head[0]) + 1j * np.asarray(head[1])
        acc = evm_rms_db(got, ref)
        bits_got = np.stack([(got.real < 0), (got.imag < 0)], -1).reshape(-1)
        bits_ref = np.stack([(ref.real < 0), (ref.imag < 0)], -1).reshape(-1)
        agree = float((bits_got == bits_ref).mean())

        def run(kk, f=fn):
            t0 = time.perf_counter()
            o = None
            for _ in range(kk):
                o = f(blk)
            digest(o)
            return time.perf_counter() - t0

        run(2)
        dt, _ = marginal_cost(run, 10, 50)
        ms = "n/a" if dt is None else f"{dt*1e3:7.3f} ms {n/dt/1e6:7.0f} Msa/s"
        print(f"{name:8s} {ms}  accuracy {acc:7.1f} dB  bit-agree {agree:.6f}",
              flush=True)


if __name__ == "__main__":
    main()
