"""Stage-level profile of the fused RX chain on the current backend.

Times (marginal-cost methodology) the full jitted step and each stage in
isolation — boundary merge, stage-1 einsum, combined stage-2 einsum, tail
correction, demod — to show where the block time goes and how far the
chain sits from the two-einsum roofline.

Usage: python benches/chain_profile.py [--cpu] [--n 4194304]
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
    from aether_primitives_tpu.models import RxChain, RxChainConfig
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops.fft import Scale

    dev = jax.devices()[0]
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4, fir_mode="fused"))
    cfg = chain.config
    dec, n_fft = cfg.decimation, cfg.fft_len
    span = dec * n_fft
    n = args.n
    rng = np.random.default_rng(815)
    blk = jax.device_put(
        Split(rng.normal(size=n).astype(np.float32),
              rng.normal(size=n).astype(np.float32)),
        dev,
    )
    digest = _Digest()

    taps = chain.taps
    k = taps.shape[-1]
    n1 = fir_mod._fused_stage_n1(dec, n_fft)
    f1, gp = fir_mod._fused_stage_matrices(taps.tobytes(), k, dec, n_fft, n1)
    _, cm = fir_mod._fused_rx_matrices(taps.tobytes(), k, dec, n_fft)
    n2 = span // n1
    nsym = n // span
    print(f"n={n} frames={nsym} span={span} n1={n1} n2={n2} K={k}")

    def stage_full(b):
        return chain.step_split(b)

    def stage_merge(b):
        return b.to_complex()

    def stage_e1(b):
        x = b.to_complex().reshape(nsym, n1, n2)
        return jnp.einsum("fnm,nk->fkm", x, jnp.asarray(f1),
                          precision=jax.lax.Precision.HIGHEST)

    def stage_e1e2(b):
        x = b.to_complex().reshape(nsym, n1, n2)
        a = jnp.einsum("fnm,nk->fkm", x, jnp.asarray(f1),
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum("fkm,kmd->fkd", a, jnp.asarray(gp),
                          precision=jax.lax.Precision.HIGHEST)

    def stage_spectra(b):
        return fir_mod.fir_decimate_fft(b.to_complex(), taps, dec, n_fft, Scale.SN)

    prec_chain = chain._einsum_precision()

    def stage_staged_spectra(b):
        # the production front half: k1-leading staged layout, chain precision
        return fir_mod.fir_decimate_fft(
            b.to_complex(), taps, dec, n_fft, Scale.NONE,
            precision=prec_chain, _staged_layout=True,
        )

    def stage_demod_only(zk):
        # the production back half, fed a device-resident staged tensor
        re, im = jnp.real(zk), jnp.imag(zk)
        v = (re < 0).astype(jnp.uint16) | ((im < 0).astype(jnp.uint16) << 8)
        v = jnp.moveaxis(v, 0, -1)
        bits = jax.lax.bitcast_convert_type(v, jnp.uint8)
        return bits.reshape(bits.shape[:-4] + (-1,))

    stages = [
        ("full step (spectra+demod)", stage_full, blk),
        ("boundary merge only", stage_merge, blk),
        ("einsum1 (stage-1 DFT)", stage_e1, blk),
        ("einsum1+einsum2", stage_e1e2, blk),
        ("full spectra (with correction)", stage_spectra, blk),
        ("staged spectra (chain precision)", stage_staged_spectra, blk),
    ]
    jitted = {}
    for name, fn, arg in stages:
        jfn = jax.jit(fn)
        jitted[name] = jfn
        out = jfn(arg)
        jax.block_until_ready(out)
        digest(out)

        def run(kk, f=jfn, a=arg):
            t0 = time.perf_counter()
            o = None
            for _ in range(kk):
                o = f(a)
            digest(o)
            return time.perf_counter() - t0

        run(2)
        dt, floor = marginal_cost(run, 10, 50)
        if dt is None:
            print(f"{name:34s} < {floor*1e6:8.1f} us (below floor)", flush=True)
        else:
            print(f"{name:34s} {dt*1e3:8.3f} ms  {n/dt/1e6:8.0f} Msa/s", flush=True)

    # demod in isolation (device-resident staged input) and the two-dispatch
    # composition: does splitting the jit at the spectra/demod seam dodge
    # whatever fusion penalty the composed graph pays?
    zk_dev = jitted["staged spectra (chain precision)"](blk)
    jax.block_until_ready(zk_dev)
    jd = jax.jit(stage_demod_only)
    out = jd(zk_dev)
    jax.block_until_ready(out)
    digest(out)

    def run_demod(kk):
        t0 = time.perf_counter()
        o = None
        for _ in range(kk):
            o = jd(zk_dev)
        digest(o)
        return time.perf_counter() - t0

    run_demod(2)
    dt, floor = marginal_cost(run_demod, 10, 50)
    name = "demod only (staged input)"
    if dt is None:
        print(f"{name:34s} < {floor*1e6:8.1f} us (below floor)", flush=True)
    else:
        print(f"{name:34s} {dt*1e3:8.3f} ms  {n/dt/1e6:8.0f} Msa/s", flush=True)

    js = jitted["staged spectra (chain precision)"]

    def run_two_dispatch(kk):
        t0 = time.perf_counter()
        o = None
        for _ in range(kk):
            o = jd(js(blk))
        digest(o)
        return time.perf_counter() - t0

    run_two_dispatch(2)
    dt, floor = marginal_cost(run_two_dispatch, 10, 50)
    name = "two-dispatch (spectra | demod)"
    if dt is None:
        print(f"{name:34s} < {floor*1e6:8.1f} us (below floor)", flush=True)
    else:
        print(f"{name:34s} {dt*1e3:8.3f} ms  {n/dt/1e6:8.0f} Msa/s", flush=True)


if __name__ == "__main__":
    main()
