"""Fold-chain experiment: can (decimating OS fold -> separate frame FFT ->
demod) beat the production two-einsum fused chain?

Motivation: the fused DDC fold (forward span FFT + fold + 1/dec inverse)
can run near the elementwise floor, while the two-einsum frame op pays
XLA composition overhead. This harness times, on one device:

- ``production``: RxChain.jitted (fused two-einsum + staged sign demod);
- ``fold``: fir_filter_os_decimate -> [nsym, fft_len] reshape ->
  matmul-FFT (Scale.SN) -> generic demod;
- ``fold-front``: the fold FIR+decimate stage alone (floor of the variant).

Bit agreement for both full variants is gated against the f64 numpy
reference before timing. Usage: python benches/fold_chain_bench.py [--cpu]
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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.cli import _Digest, marginal_cost, numpy_reference_bits
    from aether_primitives_tpu.models import RxChain, RxChainConfig
    from aether_primitives_tpu.ops import fir
    from aether_primitives_tpu.ops.fft import Scale, plan as fft_plan

    dev = jax.devices()[0]
    n = args.n
    cfg = RxChainConfig(fft_len=2048, decimation=4)
    chain = RxChain(cfg)
    taps = chain.taps
    dec, m = cfg.decimation, cfg.fft_len

    production = chain.jitted(donate=False, split_boundary=True)

    def fold_bits(b):
        y = fir.fir_filter_os_decimate(b.to_complex(), taps, dec)
        nsym = y.shape[-1] // m
        frames = y.reshape(y.shape[:-1] + (nsym, m))
        spec = fft_plan(m, cfg.fft_backend).fwd(frames, Scale.SN)
        return chain._demod_frames(spec)

    fold = jax.jit(fold_bits)

    def fold_front_fn(b):
        return fir.fir_filter_os_decimate(b.to_complex(), taps, dec)

    fold_front = jax.jit(fold_front_fn)

    # hybrid: fold front (FIR+decimate, time domain) + the two-einsum op at
    # span = fft_len (dec=1, identity taps) for frame FFT + staged sign
    # demod — 4x less einsum work than the production span = dec*fft_len
    def make_hybrid(n1):
        c1 = RxChain(RxChainConfig(
            fft_len=m, decimation=1,
            fir_taps=np.array([1.0 + 0j], np.complex64),
            fir_mode="fused", stage_n1=n1,
        ))

        def hybrid_bits(b):
            y = fir.fir_filter_os_decimate(b.to_complex(), taps, dec)
            return c1.step(y)

        return jax.jit(hybrid_bits)

    hybrid128 = make_hybrid(None)  # heuristic (128)
    hybrid16 = make_hybrid(16)

    rng = np.random.default_rng(815)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    blk = jax.device_put(Split(x.real.copy(), x.imag.copy()), dev)
    digest = _Digest()

    ref_bits = numpy_reference_bits(x, taps, dec, m)
    for name, fn in (("production", production), ("fold", fold),
                     ("hybrid128", hybrid128), ("hybrid16", hybrid16)):
        got = np.asarray(fn(blk))
        agree = float((got == ref_bits).mean())
        print(f"{name:12s} bit agreement vs f64: {agree:.7f}", flush=True)
        assert agree > 0.999, name

    out = fold_front(blk)
    jax.block_until_ready(out)
    digest(out)

    variants = [("production", production), ("fold", fold),
                ("hybrid128", hybrid128), ("hybrid16", hybrid16),
                ("fold-front", fold_front)]
    best = {}
    for rnd in range(args.rounds):
        for name, jfn in variants:
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
                print(f"round {rnd} {name:12s} unresolved", flush=True)
                continue
            best[name] = min(best.get(name, float("inf")), dt)
            print(
                f"round {rnd} {name:12s} {dt*1e3:7.3f} ms "
                f"{n/dt/1e6:7.0f} Msa/s",
                flush=True,
            )

    print("--- min over rounds ---", flush=True)
    for name, _ in variants:
        if name in best:
            dt = best[name]
            print(f"{name:12s} {dt*1e3:7.3f} ms {n/dt/1e6:7.0f} Msa/s", flush=True)


if __name__ == "__main__":
    main()
