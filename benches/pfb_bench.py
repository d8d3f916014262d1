"""Device throughput of the polyphase filterbank channelizer.

Times ``pfb_channelize`` (P-branch windowed-overlap-add + batched matmul
FFT) against the plain chunked-FFT waterfall core (the P=1 rectangle) on a
device-resident capture, marginal-cost methodology (see cli.py). Output
magnitude is digested on device; correctness is gated against the f64
direct WOLA golden on a small prefix before timing.

Usage: python benches/pfb_bench.py [--cpu] [--n 4194304] [--chan 2048]
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
    ap.add_argument("--chan", type=int, default=2048)
    ap.add_argument("--taps-per-branch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.cli import _Digest, marginal_cost
    from aether_primitives_tpu.evm import evm_rms_db
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize,
        pfb_prototype,
    )
    from aether_primitives_tpu.ops.fft import Scale

    dev = jax.devices()[0]
    n, m, p = args.n, args.chan, args.taps_per_branch
    rng = np.random.default_rng(815)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    blk = jax.device_put(Split(x.real.copy(), x.imag.copy()), dev)
    digest = _Digest()
    h = pfb_prototype(m, p)

    # correctness gate on a small prefix (f64 direct WOLA)
    npre = m * 16
    xpre = x[:npre].astype(np.complex128)
    hb = np.pad(h.astype(np.complex128), (0, 0)).reshape(p, m)
    fr = xpre.reshape(-1, m)
    u = np.zeros_like(fr)
    for t in range(fr.shape[0]):
        for pi in range(p):
            if t - pi >= 0:
                u[t] += hb[pi] * fr[t - pi]
    ref = np.fft.fft(u, axis=-1)
    import jax.numpy as jnp

    def gate_fn(b):
        z = pfb_channelize(b.to_complex(), m, taps=h)
        return jnp.real(z), jnp.imag(z)  # complex can't cross the boundary

    gre, gim = jax.jit(gate_fn)(
        jax.device_put(Split(x[:npre].real.copy(), x[:npre].imag.copy()), dev)
    )
    got = np.asarray(gre) + 1j * np.asarray(gim)
    gate = evm_rms_db(got, ref)
    print(f"correctness gate (vs f64 WOLA): {gate:.1f} dB", flush=True)
    assert gate < -80

    from aether_primitives_tpu.models.channelizer import (
        pfb_synthesis_taps,
        pfb_synthesize,
    )

    g = pfb_synthesis_taps(h, m, taps_per_branch=2 * p)

    def synth(b):
        fr = b.to_complex().reshape(-1, m)  # treat capture as channel frames
        return pfb_synthesize(fr, m, taps=g)

    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        pfb_synthesize_os,
    )

    variants = [
        ("pfb P=%d" % p, lambda b: pfb_channelize(b.to_complex(), m, taps=h)),
        (
            "os-pfb os=2 (analysis)",
            lambda b: pfb_channelize_os(b.to_complex(), m, os=2),
        ),
        (
            "os-pfb os=2 (analysis, xla fold)",
            lambda b: pfb_channelize_os(b.to_complex(), m, os=2),
        ),
        (
            "os-pfb os=2 (synthesis, xla)",
            lambda b: pfb_synthesize_os(
                b.to_complex().reshape(-1, m), m, os=2
            ),
        ),
        (
            "rect P=1 (chunked FFT)",
            lambda b: pfb_channelize(
                b.to_complex(), m, taps=np.ones(m, np.complex64),
                scale=Scale.NONE,
            ),
        ),
        ("synthesis Q=%d" % (-(-g.shape[-1] // m)), synth),
        (
            "os-pfb os=2 (synthesis)",
            lambda b: pfb_synthesize_os(
                b.to_complex().reshape(-1, m), m, os=2
            ),
        ),
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
                print(f"round {rnd} {name:24s} unresolved", flush=True)
                continue
            best[name] = min(best.get(name, float("inf")), dt)
            print(
                f"round {rnd} {name:24s} {dt*1e3:7.3f} ms "
                f"{n/dt/1e6:7.0f} Msa/s",
                flush=True,
            )

    print("--- min over rounds ---", flush=True)
    for name, _ in jitted:
        if name in best:
            dt = best[name]
            print(
                f"{name:24s} {dt*1e3:7.3f} ms {n/dt/1e6:7.0f} Msa/s",
                flush=True,
            )


if __name__ == "__main__":
    main()
