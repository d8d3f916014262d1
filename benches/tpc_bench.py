"""Turbo product code (Chase-Pyndiah) throughput on the device.

Rows (decode-correctness asserted on the device at Eb/N0 = 3 dB AWGN — raw
channel BER ~5% — before timing):

- TPC(32,26)^2 p=4, 4 iterations, batch 16 / 64;
- TPC(64,57)^2 p=5, 4 iterations, batch 16.

Writes benches/results_tpc_r4.json. Mbit/s are INFO bits/s (k^2 per
block). Timing: min of 3 marginal-cost rounds with a jitted digest
(the aether-bench methodology).
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from aether_primitives_tpu.cli import marginal_cost
from aether_primitives_tpu.ops.tpc import TPC


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
    dt = None
    for _ in range(rounds):
        d, _f = marginal_cost(run, k1, k2)
        if d is not None:
            dt = d if dt is None else min(dt, d)
    return dt


def main():
    dev = jax.devices()[0]
    print(f"device: {dev}", flush=True)
    rng = np.random.default_rng(3)
    results = []
    digest = jax.jit(lambda o: sum(
        jnp.sum(l.astype(jnp.float32)) for l in jax.tree.leaves(o)
    ))

    for (m, p, tc, ebn0, batches) in [
        (5, 4, 1, 3.0, (16, 64)),
        (6, 5, 1, 3.5, (16,)),
        (6, 4, 2, 3.0, (16,)),  # the 802.16-class BCH-2 square
    ]:
        t = TPC(m=m, p=p, iters=4, t_component=tc)
        enc = jax.jit(t.encode)
        dec_fn = jax.jit(t.decode)
        for batch in batches:
            data = rng.integers(0, 2, (batch, t.k, t.k)).astype(np.uint8)
            cw = np.asarray(enc(data)).astype(np.float64)
            sigma = math.sqrt(1 / (2 * t.rate * 10 ** (ebn0 / 10)))
            y = (1 - 2 * cw) + sigma * rng.normal(size=cw.shape)
            llr = jax.device_put((2 * y / sigma**2).astype(np.float32), dev)
            dec, ok = dec_fn(llr)
            assert (np.asarray(dec) == data).all() and np.asarray(ok).all()
            dt = _time(dec_fn, (llr,), digest)
            info = batch * t.k * t.k
            results.append({
                "op": f"TPC({t.n},{t.k})^2 t{tc} p={p} 4it decode",
                "batch": batch, "ebn0_db": ebn0,
                "ms_per_call": dt * 1e3,
                "info_mbit_s": info / dt / 1e6,
                "coded_mbit_s": batch * t.n * t.n / dt / 1e6,
            })
            print(f"TPC({t.n},{t.k})^2 b{batch}: {dt*1e3:.2f} ms, "
                  f"{info/dt/1e6:.1f} Mbit/s info", flush=True)

    out = {
        "bench": "turbo product code Chase-Pyndiah throughput",
        "device": str(dev),
        "method": "min of 3 marginal-cost rounds, jitted digest; decode "
                  "correctness asserted on the device per row at the stated "
                  "Eb/N0 (raw channel BER ~3-5%)",
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_tpc_r4.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
