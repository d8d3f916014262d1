"""Binary BCH throughput on the device (the classical FEC family alongside
RS/Viterbi/LDPC/turbo/polar rows).

Rows (decode-correctness asserted on the device before timing, t errors
planted per codeword):

- BCH(255,191,t=8) batch 64 / 1024 — the PacketModem default;
- BCH(63,45,t=3) batch 1024 — the short telecommand-class code;
- BCH(255,191,t=8) encode batch 1024 — the one-matmul encoder.

Writes benches/results_bch_r4.json. Mbit/s are INFO bits/s; coded
bits/s also recorded. Timing: min of 3 marginal-cost rounds with a
jitted digest (the aether-bench methodology).
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
from aether_primitives_tpu.ops.bch import BCH


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
    rng = np.random.default_rng(11)
    results = []
    digest = jax.jit(lambda o: sum(
        jnp.sum(l.astype(jnp.float32)) for l in jax.tree.leaves(o)
    ))

    for (n, t, batches) in [(255, 8, (64, 1024)), (63, 3, (1024,))]:
        c = BCH(n, t)
        enc = jax.jit(c.encode)
        dec_fn = jax.jit(c.decode)
        for batch in batches:
            msg = rng.integers(0, 2, (batch, c.k)).astype(np.uint8)
            cw = np.asarray(enc(msg))
            rx = cw.copy()
            for b in range(batch):
                rx[b, rng.choice(n, size=t, replace=False)] ^= 1
            rx_dev = jax.device_put(rx, dev)
            dec, ok, nerr = dec_fn(rx_dev)
            assert (np.asarray(dec) == msg).all() and np.asarray(ok).all()
            assert (np.asarray(nerr) == t).all()
            dt = _time(dec_fn, (rx_dev,), digest)
            info = batch * c.k
            results.append({
                "op": f"BCH({n},{c.k},t={t}) decode", "batch": batch,
                "ms_per_call": dt * 1e3,
                "info_mbit_s": info / dt / 1e6,
                "coded_mbit_s": batch * n / dt / 1e6,
            })
            print(f"BCH({n},{c.k}) dec b{batch}: {dt*1e3:.3f} ms, "
                  f"{info/dt/1e6:.1f} Mbit/s info", flush=True)

    # t=2 closed form (half-trace quadratic solver) vs general BM+Chien:
    # interleaved same-session A/B on identical inputs, outputs asserted
    # identical before timing
    import jax.numpy as jnp2  # noqa: F401

    c = BCH(255, 2)
    batch = 1024
    msg = rng.integers(0, 2, (batch, c.k)).astype(np.uint8)
    cw = np.asarray(jax.jit(c.encode)(msg))
    rx = cw.copy()
    for b in range(batch):
        rx[b, rng.choice(255, size=2, replace=False)] ^= 1
    rxf = jax.device_put(rx.astype(np.float32), dev)
    closed = jax.jit(c._decode_closed)
    bm = jax.jit(c._decode_bm)
    oc = closed(rxf)
    ob = bm(rxf)
    for a, b2 in zip(oc, ob):
        assert (np.asarray(a) == np.asarray(b2)).all()
    assert (np.asarray(oc[0])[:, : c.k] == msg).all()
    dts = {}
    for _ in range(3):  # interleaved rounds
        for name, fn in (("closed", closed), ("bm", bm)):
            d = _time(fn, (rxf,), digest, rounds=1)
            if d is not None:
                dts[name] = min(dts.get(name, d), d)
    for name in ("closed", "bm"):
        dt = dts[name]
        results.append({
            "op": f"BCH(255,{c.k},t=2) decode [{name}]", "batch": batch,
            "ms_per_call": dt * 1e3,
            "info_mbit_s": batch * c.k / dt / 1e6,
            "coded_mbit_s": batch * 255 / dt / 1e6,
        })
        print(f"BCH(255,{c.k}) t2-{name} b{batch}: {dt*1e3:.3f} ms, "
              f"{batch*c.k/dt/1e6:.1f} Mbit/s info", flush=True)

    # Chase-2 on the t=2 closed form: 16 scan-free decodes per word
    chase2 = jax.jit(lambda v: c.decode_soft(v, p=4))
    llr = ((1.0 - 2.0 * cw.astype(np.float64)) * 4.0
           + 0.4 * rng.normal(size=cw.shape)).astype(np.float32)
    llr_dev = jax.device_put(llr, dev)
    dec, ok = chase2(llr_dev)
    assert (np.asarray(dec) == msg).all()
    dt = _time(chase2, (llr_dev,), digest)
    results.append({
        "op": f"BCH(255,{c.k},t=2) Chase-2 p=4 soft decode", "batch": batch,
        "ms_per_call": dt * 1e3,
        "info_mbit_s": batch * c.k / dt / 1e6,
        "coded_mbit_s": batch * 255 / dt / 1e6,
    })
    print(f"BCH(255,{c.k}) t2-chase4 b{batch}: {dt*1e3:.3f} ms, "
          f"{batch*c.k/dt/1e6:.1f} Mbit/s info", flush=True)

    # Chase-2 soft decode: 2^4 test patterns as one wider batch
    c = BCH(63, 3)
    chase = jax.jit(lambda v: c.decode_soft(v, p=4))
    batch = 1024
    msg = rng.integers(0, 2, (batch, c.k)).astype(np.uint8)
    cw = np.asarray(jax.jit(c.encode)(msg)).astype(np.float64)
    llr = ((1.0 - 2.0 * cw) * 4.0 + 0.45 * rng.normal(size=cw.shape)
           ).astype(np.float32)
    llr_dev = jax.device_put(llr, dev)
    dec, ok = chase(llr_dev)
    assert (np.asarray(dec) == msg).all() and np.asarray(ok).all()
    dt = _time(chase, (llr_dev,), digest)
    results.append({
        "op": "BCH(63,45,t=3) Chase-2 p=4 soft decode", "batch": batch,
        "ms_per_call": dt * 1e3,
        "info_mbit_s": batch * c.k / dt / 1e6,
        "coded_mbit_s": batch * 63 / dt / 1e6,
    })
    print(f"BCH(63,45) chase-4 b{batch}: {dt*1e3:.3f} ms, "
          f"{batch*c.k/dt/1e6:.1f} Mbit/s info", flush=True)

    # encoder row: one [k, n-k] matmul mod 2
    c = BCH(255, 8)
    enc = jax.jit(c.encode)
    batch = 1024
    msg = jax.device_put(
        rng.integers(0, 2, (batch, c.k)).astype(np.uint8), dev
    )
    dt = _time(enc, (msg,), digest)
    results.append({
        "op": f"BCH(255,{c.k},t=8) encode", "batch": batch,
        "ms_per_call": dt * 1e3,
        "info_mbit_s": batch * c.k / dt / 1e6,
        "coded_mbit_s": batch * 255 / dt / 1e6,
    })
    print(f"BCH(255,{c.k}) enc b{batch}: {dt*1e3:.3f} ms, "
          f"{batch*c.k/dt/1e6:.1f} Mbit/s info", flush=True)

    out = {
        "bench": "binary BCH encode/decode throughput",
        "device": str(dev),
        "method": "min of 3 marginal-cost rounds, jitted digest; decode "
                  "correctness asserted on the device per row (t planted errors)",
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_bch_r4.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
