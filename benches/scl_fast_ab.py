"""Interleaved device A/B: node-classified fast SCL vs the leaf-wise
reference.

Times polar (256,128) CA-SCL L=8 at batch 64 and 1024 through
PolarCode.decode (crc8, the production entry), plus the raw
polar_decode_list for both implementations, interleaving A and B within
one session so session-to-session drift cancels. Correctness is
asserted on the device
before any timing (decode-exact + fast==leafwise path metrics).

Writes benches/results_scl_fast_r5.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from aether_primitives_tpu.cli import marginal_cost
from aether_primitives_tpu.ops import polar as P


def _time(fn, args, digest, rounds=3, k1=3, k2=12):
    out = fn(*args)
    jax.block_until_ready(out)
    float(np.asarray(digest(out)))

    def run(k):
        t = time.perf_counter()
        o = None
        for _ in range(k):
            o = fn(*args)
        float(np.asarray(digest(o)))
        return time.perf_counter() - t

    run(2)
    samples = []
    for _ in range(rounds):
        d, _f = marginal_cost(run, k1, k2)
        if d is not None:
            samples.append(d)
    return min(samples), samples


def main():
    dev = jax.devices()[0]
    rng = np.random.default_rng(7)
    digest = jax.jit(lambda o: sum(
        jnp.sum(l.astype(jnp.float32)) for l in jax.tree.leaves(o)
    ))

    n, k = 256, 128
    code = P.PolarCode(n=n, k=k, design_snr_db=1.0, crc="crc8", list_size=8)
    mask = code.info_mask
    enc = jax.jit(lambda b: code.encode(b))

    results = []
    for batch in (64, 1024):
        bits = rng.integers(0, 2, (batch, code.payload_bits)).astype(np.uint8)
        cw = np.asarray(enc(bits))
        sigma = 0.6
        y = (1.0 - 2.0 * cw.astype(np.float64)) + sigma * rng.normal(
            size=cw.shape
        )
        llr = jax.device_put((2.0 * y / sigma**2).astype(np.float32), dev)
        info = batch * code.payload_bits

        fast = jax.jit(lambda v: code.decode(v))
        slow_list = jax.jit(
            lambda v: P._decode_list_leafwise(v, mask, 8)
        )
        fast_list = jax.jit(lambda v: P.polar_decode_list(v, mask, 8))

        # correctness gates on the device
        dec, ok = fast(llr)
        assert (np.asarray(dec) == bits).all() and np.asarray(ok).all()
        _bf, pmf = fast_list(llr)
        _bs, pms = slow_list(llr)
        assert np.allclose(np.asarray(pmf), np.asarray(pms), atol=1e-3)

        # interleaved A/B: alternate fast/leafwise measurement rounds
        fast_s, slow_s = [], []
        for _ in range(3):
            d_f, _ = _time(fast_list, (llr,), digest, rounds=1)
            fast_s.append(d_f)
            d_s, _ = _time(slow_list, (llr,), digest, rounds=1)
            slow_s.append(d_s)
        d_fast, d_slow = min(fast_s), min(slow_s)
        d_decode, dec_samples = _time(fast, (llr,), digest, rounds=3)

        row = {
            "config": f"polar({n},{k}) L=8 b{batch}",
            "fast_list_ms": d_fast * 1e3,
            "leafwise_list_ms": d_slow * 1e3,
            "speedup": d_slow / d_fast,
            "decode_ms": d_decode * 1e3,
            "decode_info_mbit_s": info / d_decode / 1e6,
            "fast_samples_ms": [s * 1e3 for s in fast_s],
            "leafwise_samples_ms": [s * 1e3 for s in slow_s],
            "decode_samples_ms": [s * 1e3 for s in dec_samples],
        }
        results.append(row)
        print(f"b{batch}: fast {d_fast*1e3:.2f} ms vs leafwise "
              f"{d_slow*1e3:.2f} ms = {d_slow/d_fast:.1f}x; CA-SCL "
              f"decode {info/d_decode/1e6:.1f} Mbit/s info", flush=True)

    out = {
        "bench": "fast SCL (node-classified) vs leaf-wise, device A/B",
        "device": str(dev),
        "rows": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_scl_fast_r5.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
