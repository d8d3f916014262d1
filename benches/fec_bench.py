"""Soft-FEC throughput on the device: polar BP vs CA-SCL, NR-structured
LDPC.

Rows (all decode-correctness-checked on the device before timing):

- polar (256,128) CA-SCL L=8 batch 64;
- polar (256,128) BP 40 iters at batch 64 / 1024 — the flooding path;
- NR-structured BG2 z=64 k=500 e=1000 (rate 1/2) QC edge-message min-sum
  25 iters at batch 64 / 1024;
- 802.11n n=648 QC edge decoder batch 1024.

Writes benches/results_fec_r5.json. Mbit/s are INFO bits/s (payload);
coded bits/s also recorded.
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
from aether_primitives_tpu.ops import ldpc as L
from aether_primitives_tpu.ops import polar as P
from aether_primitives_tpu.ops.nr_ldpc import NrLdpc


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
    rng = np.random.default_rng(7)
    results = []
    digest = jax.jit(lambda o: sum(
        jnp.sum(l.astype(jnp.float32)) for l in jax.tree.leaves(o)
    ))

    def noisy_llr(cw, sigma=0.6):
        y = (1.0 - 2.0 * cw.astype(np.float64)) + sigma * rng.normal(
            size=cw.shape
        )
        return (2.0 * y / sigma**2).astype(np.float32)

    # ---------------- polar (256,128): CA-SCL vs BP
    n, k = 256, 128
    mask = P.polar_construct(n, k, 1.0)
    code_crc = P.PolarCode(n=n, k=k, design_snr_db=1.0, crc="crc8",
                           list_size=8)
    enc = jax.jit(lambda b: code_crc.encode(b))
    for batch in (64, 1024):
        bits = rng.integers(0, 2, (batch, code_crc.payload_bits)).astype(
            np.uint8
        )
        cw = np.asarray(enc(bits))
        llr = jax.device_put(noisy_llr(cw), dev)
        info = batch * code_crc.payload_bits

        if batch == 64:  # the round-3 row, for the interleaved A/B
            scl = jax.jit(lambda v: code_crc.decode(v))
            dec, ok = scl(llr)
            assert (np.asarray(dec) == bits).all() and np.asarray(ok).all()
            dt = _time(scl, (llr,), digest)
            results.append({
                "decoder": "polar CA-SCL L=8", "n": n, "batch": batch,
                "ms_per_call": dt * 1e3,
                "info_mbit_s": info / dt / 1e6,
                "coded_mbit_s": batch * n / dt / 1e6,
            })
            print(f"CA-SCL b{batch}: {dt*1e3:.2f} ms, "
                  f"{info/dt/1e6:.1f} Mbit/s info", flush=True)

        bp = jax.jit(lambda v: code_crc.decode_bp(v, iters=40))
        dec, ok = bp(llr)
        assert (np.asarray(dec) == bits).all() and np.asarray(ok).all()
        dt = _time(bp, (llr,), digest)
        results.append({
            "decoder": "polar BP 40it", "n": n, "batch": batch,
            "ms_per_call": dt * 1e3,
            "info_mbit_s": info / dt / 1e6,
            "coded_mbit_s": batch * n / dt / 1e6,
        })
        print(f"polar BP b{batch}: {dt*1e3:.2f} ms, "
              f"{info/dt/1e6:.1f} Mbit/s info", flush=True)

    # ---------------- NR-structured BG2 (z=64, k=500, e=1000)
    nr = NrLdpc(z=64, bg=2, k=500)
    nr_enc = jax.jit(lambda b: nr.encode(b, 1000))
    for batch in (64, 1024):
        bits = rng.integers(0, 2, (batch, 500)).astype(np.uint8)
        tx = np.asarray(nr_enc(bits))
        llr = jax.device_put(noisy_llr(tx, sigma=0.5), dev)
        dec_fn = jax.jit(lambda v: nr.decode(v, iters=25))
        dec, ok = dec_fn(llr)
        assert (np.asarray(dec) == bits).all() and np.asarray(ok).all()
        dt = _time(dec_fn, (llr,), digest)
        info = batch * 500
        results.append({
            "decoder": "NR-structured BG2 z=64 r1/2 QC-minsum 25it",
            "batch": batch, "ms_per_call": dt * 1e3,
            "info_mbit_s": info / dt / 1e6,
            "coded_mbit_s": batch * 1000 / dt / 1e6,
        })
        print(f"NR BG2 b{batch}: {dt*1e3:.2f} ms, "
              f"{info/dt/1e6:.1f} Mbit/s info", flush=True)

    # ---------------- 802.11n n=648 QC edge decoder (round-3 anchor)
    h, g, info_idx = L.wifi_ldpc()
    wenc = jax.jit(lambda b: L.ldpc_encode(b, g))
    batch = 1024
    bits = rng.integers(0, 2, (batch, g.shape[0])).astype(np.uint8)
    cw = np.asarray(wenc(bits))
    llr = jax.device_put(noisy_llr(cw, sigma=0.5), dev)
    qc = jax.jit(
        lambda v: L.qc_ldpc_decode(v, L._WIFI_648_R12, 27, iters=25)
    )
    hard, ok = qc(llr)
    assert np.asarray(ok).all()
    dt = _time(qc, (llr,), digest)
    results.append({
        "decoder": "802.11n 648 QC-minsum 25it", "batch": batch,
        "ms_per_call": dt * 1e3,
        "info_mbit_s": batch * 324 / dt / 1e6,
        "coded_mbit_s": batch * 648 / dt / 1e6,
    })
    print(f"11n b{batch}: {dt*1e3:.2f} ms, "
          f"{batch*324/dt/1e6:.1f} Mbit/s info", flush=True)

    out = {
        "bench": "soft-FEC throughput (polar BP vs CA-SCL, NR LDPC)",
        "device": str(dev),
        "method": "min of 3 marginal-cost rounds, jitted digest; decode "
                  "correctness asserted on the device per row",
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_fec_r5.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
