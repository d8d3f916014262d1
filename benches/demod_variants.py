"""Whole-chain A/B of sign-demod layout strategies (interleaved rounds).

The staged fused op emits ``zk [n1, nsym, r]`` (k1-leading) but the bit
contract needs natural bin order ``k = k1 + n1*d`` -> ``[nsym, r, n1]``
flat. The relayout strategies under test:

- ``u16-moveaxis`` (production): sign-test in staged layout, pack the two
  bits into a u16 word, ``moveaxis`` the 2-byte words, bitcast. 4x less
  transpose traffic than moving spectra, in 16-bit transposes.
- ``mxu-transpose``: relayout the COMPLEX zk on the matrix unit by
  contracting the
  k1 axis with a 16x16 identity (``einsum('kfd,ke->fde')``). 0/1 products
  and single-term sums are exact in any precision, so this is bit-exact at
  ``Precision.DEFAULT``; sign-pack then happens in natural layout with no
  16-bit transpose at all.
- ``gemm-native``: ask the stage-2 einsum for ``...fdk`` output directly
  (``einsum('kfm,kmd->fdk')``) so XLA fuses the relayout into the GEMM
  epilogue; sign-pack in natural layout.
- ``c64-moveaxis``: ``moveaxis`` the complex64 zk (8-byte elements use the
  efficient f32 shuffle path), then sign-pack in natural layout.

Each variant runs the FULL chain (merge -> spectra -> demod -> flat bits),
gated on bit agreement vs the f64 numpy reference, timed min-of-rounds
with the marginal-cost estimator. Winner ships in RxChain._bits_fast.

Usage: python benches/demod_variants.py [--cpu] [--n 4194304] [--rounds 4]
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
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.cli import (
        _Digest, marginal_cost, numpy_reference_bits,
    )
    from aether_primitives_tpu.models import RxChain, RxChainConfig
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops.fft import Scale

    dev = jax.devices()[0]
    n = args.n
    rng = np.random.default_rng(815)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    blk = jax.device_put(Split(x.real.copy(), x.imag.copy()), dev)
    digest = _Digest()

    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, fir_mode="fused"))
    cfg = chain.config
    dec, n_fft = cfg.decimation, cfg.fft_len
    taps = chain.taps
    prec = chain._einsum_precision()
    ref_bits = numpy_reference_bits(x, taps, dec, n_fft)
    n1 = fir_mod._fused_stage_n1(dec, n_fft)
    eye = np.eye(n1, dtype=np.float32)

    def staged(b):
        return fir_mod.fir_decimate_fft(
            b.to_complex(), taps, dec, n_fft, Scale.NONE,
            precision=prec, _staged_layout=True,
        )  # [n1, nsym, r]

    def pack_natural(z_fdk):
        # z in [..., nsym, r, n1]: sign-pack + bitcast, no further relayout
        v = (jnp.real(z_fdk) < 0).astype(jnp.uint16) | (
            (jnp.imag(z_fdk) < 0).astype(jnp.uint16) << 8
        )
        bits = jax.lax.bitcast_convert_type(v, jnp.uint8)
        return bits.reshape(bits.shape[:-4] + (-1,))

    def v_production(b):
        return chain.step_split(b)

    def v_mxu_transpose(b):
        zk = staged(b)
        z = jnp.einsum("kfd,ke->fde", zk, jnp.asarray(eye),
                       precision=jax.lax.Precision.DEFAULT)
        return pack_natural(z)

    def v_gemm_native(b):
        # two einsums with natural-order output straight from the GEMM
        span = dec * n_fft
        nsym = n // span
        n2 = span // n1
        f1, gp = fir_mod._fused_stage_matrices(
            taps.tobytes(), taps.shape[-1], dec, n_fft, n1
        )
        _, cm = fir_mod._fused_rx_matrices(
            taps.tobytes(), taps.shape[-1], dec, n_fft
        )
        k = taps.shape[-1]
        r = n_fft // n1
        xc = b.to_complex()
        frames = xc.reshape(nsym, span)
        xv = frames.reshape(nsym, n1, n2)
        a = jnp.einsum("fnm,nk->kfm", xv, jnp.asarray(f1), precision=prec)
        z = jnp.einsum("kfm,kmd->fdk", a, jnp.asarray(gp), precision=prec)
        # wrap correction in [f, d, k1] layout
        tails = frames[:, span - (k - 1):]
        prev = jnp.concatenate(
            [jnp.zeros((1, k - 1), frames.dtype), tails[:-1, :]], axis=0
        )
        delta = tails - prev
        cm_dk = np.ascontiguousarray(
            cm.reshape(k - 1, r, n1)
        )  # [u, d, k1]
        ecorr = jnp.einsum(
            "fu,udk->fdk", delta, jnp.asarray(cm_dk),
            precision=jax.lax.Precision.HIGHEST,
        )
        return pack_natural(z - ecorr)

    def v_c64_moveaxis(b):
        zk = staged(b)
        z = jnp.moveaxis(zk, 0, -1)  # [nsym, r, n1] complex
        return pack_natural(z)

    variants = [
        ("u16-moveaxis (production)", v_production),
        ("mxu-transpose", v_mxu_transpose),
        ("gemm-native", v_gemm_native),
        ("c64-moveaxis", v_c64_moveaxis),
    ]

    jitted = []
    for name, fn in variants:
        jfn = jax.jit(fn)
        got = np.asarray(jfn(blk))
        agree = float((got == ref_bits).mean())
        flag = "" if agree >= 0.999 else "  ** GATE FAIL **"
        print(f"{name:28s} bit-agree {agree:.6f}{flag}", flush=True)
        jitted.append((name, jfn))

    best = {}
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
                print(f"round {rnd} {name:28s} unresolved", flush=True)
                continue
            best[name] = min(best.get(name, float("inf")), dt)
            print(f"round {rnd} {name:28s} {dt*1e3:7.3f} ms "
                  f"{n/dt/1e6:7.0f} Msa/s", flush=True)

    print("--- min over rounds ---", flush=True)
    for name, _ in jitted:
        if name in best:
            dt = best[name]
            print(f"{name:28s} {dt*1e3:7.3f} ms {n/dt/1e6:7.0f} Msa/s",
                  flush=True)


if __name__ == "__main__":
    main()
