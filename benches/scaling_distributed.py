"""Multi-process scaling proxy: the sharded RX chain across a process-
spanning mesh (jax.distributed), timed.

A CPU-only localhost proxy for multi-host scaling: every worker is
pinned to the CPU backend, and the SAME total device count is arranged
as 1 process × 8 devices vs 2 processes × 4 devices, so the 2-process rate ÷ 1-process rate isolates
exactly what crossing a process boundary costs (the cross-process halo +
distributed-runtime dispatch — what DCN latency would add to on a real
deployment, minus the wire).  The reference self-reports throughput
continuously from inside its pipeline stages
(/root/reference/src/pipeline.rs:100-107); this is the framework's
committed-artifact equivalent.

Launcher mode (default): spawns the worker twice for nproc=1 and nproc=2,
collects per-config throughput, prints + writes JSON.

    python benches/scaling_distributed.py --json /tmp/scaling_2proc.json

Worker mode (internal): --worker <pid> <nproc> <port> [samples_per_dev]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

try:
    import aether_primitives_tpu  # noqa: F401
except ModuleNotFoundError:  # bare offline clone: resolve the in-tree package
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOTAL_DEVICES = 8


def worker(pid: int, nproc: int, port: str, samples_per_dev: int) -> None:
    ndev_local = TOTAL_DEVICES // nproc
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={ndev_local}"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from aether_primitives_tpu.parallel.mesh import init_distributed, make_mesh

    if nproc > 1:
        init_distributed(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc,
            process_id=pid,
        )
        assert jax.process_count() == nproc

    import jax.numpy as jnp

    from aether_primitives_tpu.cli import marginal_cost
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    ndev = len(jax.devices())
    assert ndev == TOTAL_DEVICES, ndev
    chain = RxChain(RxChainConfig(fft_len=2048, decimation=4))
    n = samples_per_dev * ndev

    # identical capture in every process (fixed seed); each contributes its
    # local slice to the global sharded array
    rng = np.random.default_rng(815)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)

    mesh = make_mesh({"time": ndev})
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("time"))
    local = x[pid * n // nproc : (pid + 1) * n // nproc]
    xg = jax.make_array_from_process_local_data(sharding, local, (n,))

    f = jax.jit(lambda v: chain.sharded_step(v, mesh))
    digest = jax.jit(lambda bits: jnp.sum(bits.astype(jnp.float32).ravel()[:1024]))

    out = jax.block_until_ready(f(xg))
    float(np.asarray(digest(out)))

    def run(iters):
        t0 = time.perf_counter()
        o = None
        for _ in range(iters):
            o = f(xg)
        float(np.asarray(digest(o)))
        return time.perf_counter() - t0

    run(2)
    dt = None
    for _ in range(3):
        dt_i, _floor = marginal_cost(run, 3, 13)
        if dt_i is not None:
            dt = dt_i if dt is None else min(dt, dt_i)
    rate = n / dt / 1e6 if dt else None
    if pid == 0:
        print(json.dumps({
            "nproc": nproc,
            "devices": ndev,
            "samples_per_dev": samples_per_dev,
            "msamples_per_s": round(rate, 1) if rate else None,
        }), flush=True)


def _free_port() -> str:
    """Bind an ephemeral port and release it — avoids hanging the
    1200 s jax.distributed communicate timeout on a collision with a
    stale listener (advisor finding r3: the port was hardcoded)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def launch(samples_per_dev: int, json_path: str | None) -> None:
    here = os.path.abspath(__file__)
    results = {}
    for nproc, port in ((1, None), (2, _free_port())):
        procs = []
        for pid in range(nproc):
            cmd = [sys.executable, here, "--worker", str(pid), str(nproc),
                   port or "0", str(samples_per_dev)]
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=1200)[0] for p in procs]
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                print(o)
                raise SystemExit(f"worker failed (nproc={nproc})")
        row = json.loads([l for l in outs[0].splitlines() if l.startswith("{")][-1])
        results[nproc] = row
        print(f"nproc={nproc}: {row['msamples_per_s']} Msa/s "
              f"({row['devices']} devices total)", flush=True)

    eff = results[2]["msamples_per_s"] / results[1]["msamples_per_s"]
    payload = {
        "platform": "cpu (8 virtual devices; multi-host proxy)",
        "configs": list(results.values()),
        "two_process_efficiency": round(eff, 3),
        "note": (
            "same 8-device time mesh as 1x8 vs 2x4 processes; ratio isolates "
            "the cross-process boundary cost (halo + distributed dispatch)"
        ),
    }
    print(f"two-process efficiency: {eff * 100:.1f}%")
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(payload, fh, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=4, metavar=("PID", "NPROC", "PORT", "SPD"))
    ap.add_argument("--samples-per-dev", type=int, default=1 << 21)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if args.worker:
        pid, nproc, port, spd = args.worker
        worker(int(pid), int(nproc), port, int(spd))
    else:
        launch(args.samples_per_dev, args.json)


if __name__ == "__main__":
    main()
