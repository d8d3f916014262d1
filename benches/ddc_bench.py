"""Device throughput of the DDC path (NCO mix + fused OS decimating FIR).

Times three realizations of ``mix -> 129-tap lowpass -> /8`` on a
device-resident capture, marginal-cost methodology (see cli.py):

- ``fused fold``: :func:`ops.fir.fir_filter_os_decimate` — product spectrum
  folded by ``dec``, inverse transform at ``1/dec`` the points;
- ``os + dense decim``: plain overlap-save FIR then the chunked one-hot
  matmul decimator (what a user would compose by hand);
- ``mix only``: the NCO rotation alone (the elementwise floor).

Correctness is gated against the f64 composed golden on a prefix before
timing. Usage: python benches/ddc_bench.py [--cpu] [--n 4194304] [--dec 8]
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
    ap.add_argument("--dec", type=int, default=8)
    ap.add_argument("--freq", type=float, default=0.1375)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.cli import _Digest, marginal_cost
    from aether_primitives_tpu.evm import evm_rms_db
    from aether_primitives_tpu.models.ddc import DdcConfig
    from aether_primitives_tpu.ops import fir, frontend, sampling

    dev = jax.devices()[0]
    n, dec, f0 = args.n, args.dec, args.freq
    taps = DdcConfig(decimation=dec).resolved_taps()
    rng = np.random.default_rng(815)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    blk = jax.device_put(Split(x.real.copy(), x.imag.copy()), dev)
    digest = _Digest()

    # correctness gate on a prefix: f64 composed mix -> convolve -> ::dec
    npre = 1 << 16
    idx = np.arange(npre)
    mixed = x[:npre].astype(np.complex128) * np.exp(-2j * np.pi * f0 * idx)
    ref = np.convolve(mixed, taps.astype(np.complex128))[:npre][::dec]

    def gate_fn(b):
        y = fir.fir_filter_os_decimate(
            frontend.nco_mix(b.to_complex(), -f0), taps, dec
        )
        return jnp.real(y), jnp.imag(y)

    gre, gim = jax.jit(gate_fn)(
        jax.device_put(Split(x[:npre].real.copy(), x[:npre].imag.copy()), dev)
    )
    gate = evm_rms_db(np.asarray(gre) + 1j * np.asarray(gim), ref)
    print(f"correctness gate (vs f64 composed): {gate:.1f} dB", flush=True)
    assert gate < -80

    variants = [
        (
            "fused fold",
            lambda b: fir.fir_filter_os_decimate(
                frontend.nco_mix(b.to_complex(), -f0), taps, dec
            ),
        ),
        (
            "os + dense decim",
            lambda b: sampling.downsample_by(
                fir.fir_filter_os(frontend.nco_mix(b.to_complex(), -f0), taps),
                dec,
            ),
        ),
        ("mix only", lambda b: frontend.nco_mix(b.to_complex(), -f0)),
    ]

    best = {}
    jitted = []
    for name, fn in variants:
        jfn = jax.jit(fn)
        out = jfn(blk)
        jax.block_until_ready(out)
        digest(out)
        jitted.append((name, jfn))

    for rnd in range(args.rounds):
        for name, jfn in jitted:
            def run(kk, f=jfn):
                t0 = time.perf_counter()
                o = None
                for _ in range(kk):
                    o = f(blk)
                digest(o)
                return time.perf_counter() - t0

            run(2)
            dt, _ = marginal_cost(run, 10, 40)
            if dt is None:
                print(f"round {rnd} {name:20s} unresolved", flush=True)
                continue
            best[name] = min(best.get(name, float("inf")), dt)
            print(
                f"round {rnd} {name:20s} {dt*1e3:7.3f} ms "
                f"{n/dt/1e6:7.0f} Msa/s",
                flush=True,
            )

    print("--- min over rounds ---", flush=True)
    for name, _ in jitted:
        if name in best:
            dt = best[name]
            print(
                f"{name:20s} {dt*1e3:7.3f} ms {n/dt/1e6:7.0f} Msa/s",
                flush=True,
            )


if __name__ == "__main__":
    main()
