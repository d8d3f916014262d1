"""Compiler-level attribution of the RX-chain step time: a profiler
trace of the streaming step at the headline config, aggregated per HLO
op, cross-referenced against the compiled HLO text — where the time goes
beyond the sum of the chain's own stage times.

Writes results_chain_residue_r5.json: per-op-kind time, the top
individual fusions with shapes, and the share of the step spent outside
the two einsum stages.
"""

import collections
import glob
import gzip
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from aether_primitives_tpu.boundary import Split
from aether_primitives_tpu.models import RxChain, RxChainConfig


def main():
    dev = jax.devices()[0]
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4,
                                  fir_mode="fused", fft_backend="matmul"))
    n = 4 * 1024 * 1024
    rng = np.random.default_rng(7)
    blk = jax.device_put(Split(
        rng.normal(size=n).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
    ), dev)
    state = jax.device_put(chain.init_state_split(), dev)
    step = jax.jit(chain.streaming_step_split, donate_argnums=(1,))

    bits, state = step(blk, state)
    jax.block_until_ready(bits)
    t0 = time.perf_counter()
    for _ in range(10):
        bits, state = step(blk, state)
    jax.block_until_ready(bits)
    wall_ms = (time.perf_counter() - t0) / 10 * 1e3

    trace_dir = "/tmp/chain_residue_trace"
    with jax.profiler.trace(trace_dir):
        for _ in range(5):
            bits, state = step(blk, state)
        jax.block_until_ready(bits)

    tr_files = sorted(glob.glob(
        os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")
    ))
    with gzip.open(tr_files[-1]) as f:
        tr = json.load(f)
    ev = [e for e in tr.get("traceEvents", []) if e.get("ph") == "X"]
    agg = collections.Counter()
    cnt = collections.Counter()
    tops = []
    for e in ev:
        name = e.get("name", "?")
        if name.startswith(("$", "jit", "Pjit")):
            continue
        kind = re.sub(r"[.\d]+$", "", name)
        agg[kind] += e.get("dur", 0)
        cnt[kind] += 1
        ln = e.get("args", {}).get("long_name", "")
        tops.append((e.get("dur", 0), name, ln[:260]))
    tops.sort(reverse=True)
    total_us = sum(agg.values())

    # de-duplicate top entries by deduplicated fusion name
    seen = set()
    top_rows = []
    for dur, name, ln in tops:
        base = re.sub(r"[.\d]+$", "", name) + "|" + ln[:80]
        if base in seen:
            continue
        seen.add(base)
        top_rows.append({"us": dur, "op": name, "hlo": ln})
        if len(top_rows) >= 25:
            break

    out = {
        "bench": "RX chain streaming step: device-op attribution "
                 "(5 traced iterations)",
        "device": str(dev),
        "wall_ms_per_step": wall_ms,
        "traced_device_us_total": total_us,
        "per_kind_us": {
            k: {"us": v, "n": cnt[k]} for k, v in agg.most_common(20)
        },
        "top_ops": top_rows,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_chain_residue_r5.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wall {wall_ms:.3f} ms/step; traced total {total_us/1e3:.2f} ms "
          f"over 5 iters -> {total_us/5e3:.3f} ms device time/step")
    for k, v in agg.most_common(8):
        print(f"  {v/5e3:8.3f} ms/step  n={cnt[k]//5:4d}  {k}")
    print("wrote", path)


if __name__ == "__main__":
    main()
