"""Scaling-efficiency benchmark: sharded RX chain at 1..N devices.

Scaling efficiency measured by running the time-sharded chain on growing device
subsets of the available mesh and comparing per-device throughput against
the single-device baseline.  Also times the UNSHARDED step on one device,
so the 1-device row quantifies what the sharded graph itself costs
(shard_map + halo machinery with nothing to exchange).

On a multi-GPU host this is the real measurement (halos ride NCCL).
On a single-device or CPU host it still validates the sharded path end to end
(pass --cpu to use the 8-virtual-device CPU mesh; numbers are then about
the machinery, not the silicon).  For the multi-process (multi-host proxy)
measurement see benches/scaling_distributed.py, which forms a
process-spanning mesh via jax.distributed and times the same chain across
the process boundary.

Timing mirrors the headline bench (aether_primitives_tpu/cli.py): jitted
digest forces completion, marginal cost cancels the fixed sync overhead,
best of several interleaved rounds (reference's own always-on throughput self-report:
/root/reference/src/pipeline.rs:100-107).

Usage: python benches/scaling.py [--cpu] [--samples-per-dev 4194304]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

try:
    import aether_primitives_tpu  # noqa: F401
except ModuleNotFoundError:  # bare offline clone: resolve the in-tree package
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _best_marginal(run, rounds=4):
    from aether_primitives_tpu.cli import marginal_cost

    dt = None
    for _ in range(rounds):
        dt_i, _floor = marginal_cost(run, 3, 13)
        if dt_i is not None:
            dt = dt_i if dt is None else min(dt, dt_i)
    return dt


def _make_runner(f, xd, digest):
    def run(iters):
        t0 = time.perf_counter()
        o = None
        for _ in range(iters):
            o = f(xd)
        float(np.asarray(digest(o)))
        return time.perf_counter() - t0

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--samples-per-dev", type=int, default=1 << 22)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from aether_primitives_tpu.boundary import Split
    from aether_primitives_tpu.models import RxChain, RxChainConfig
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    devs = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4))
    rng = np.random.default_rng(815)

    digest = jax.jit(lambda bits: jnp.sum(bits.astype(jnp.float32).ravel()[:1024]))

    def make_block(n, sharding=None):
        x = Split(
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
        )
        return jax.device_put(x, sharding if sharding is not None else devs[0])

    rows = []

    # unsharded single-device baseline: the plain jitted step
    n1 = args.samples_per_dev
    xd0 = make_block(n1)
    step0 = jax.jit(lambda blk: chain.step(blk.to_complex()))
    jax.block_until_ready(step0(xd0))
    float(np.asarray(digest(step0(xd0))))
    run0 = _make_runner(step0, xd0, digest)
    run0(2)
    dt0 = _best_marginal(run0)
    unsharded_rate = n1 / dt0 / 1e6 if dt0 else None
    print(f"unsharded 1-device step: {unsharded_rate:10.1f} Msa/s", flush=True)

    base_rate = None
    for nd in sizes:
        mesh = mesh_mod.make_mesh({"time": nd}, devices=devs[:nd])
        n = args.samples_per_dev * nd
        sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("time"))
        xd = make_block(n, sharding)

        f = jax.jit(lambda blk, mesh=mesh: chain.sharded_step(blk.to_complex(), mesh))
        jax.block_until_ready(f(xd))
        float(np.asarray(digest(f(xd))))
        run = _make_runner(f, xd, digest)
        run(2)
        dt = _best_marginal(run)
        if dt is None:
            print(f"devices={nd:3d}: timing did not resolve", flush=True)
            continue
        rate = n / dt / 1e6
        per_dev = rate / nd
        if base_rate is None:
            base_rate = per_dev
        eff = per_dev / base_rate
        row = {
            "devices": nd,
            "msamples_per_s": round(rate, 1),
            "per_device": round(per_dev, 1),
            "efficiency": round(eff, 3),
        }
        if nd == 1 and unsharded_rate:
            row["sharded_vs_unsharded"] = round(per_dev / unsharded_rate, 3)
        rows.append(row)
        print(
            f"devices={nd:3d}: {rate:10.1f} Msa/s total, {per_dev:10.1f}/dev, "
            f"efficiency {eff * 100:5.1f}%"
            + (
                f", sharded/unsharded {per_dev / unsharded_rate * 100:5.1f}%"
                if nd == 1 and unsharded_rate
                else ""
            ),
            flush=True,
        )

    payload = {
        "platform": devs[0].platform,
        "samples_per_dev": args.samples_per_dev,
        "unsharded_msamples_per_s": round(unsharded_rate, 1) if unsharded_rate else None,
        "rows": rows,
    }
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=1)
    return payload


if __name__ == "__main__":
    main()
