"""Batched-DOA scan throughput + correlator-2048 diagnosis, one device
session, interleaved marginal-cost rounds.

Part 1 — DOA scan mode: single-window latency on 8 elem x 512
snapshots against the batched scan, which runs [W, M, T] through
one jitted covariance + eigh + grid-matmul + peaks graph. Bearings must
match the per-window calls.

Part 2 — correlator 2048: interleaved A/B of stage-1 factors n1 in {128 (table), 64 (heuristic), 32, 16, 8} on the
chained fft->mul->ifft composition decides whether the 2048 chain is
structurally slower or the table entry is wrong for chains.

Writes benches/results_doa_corr_r4.json.
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
from aether_primitives_tpu.models import doa
from aether_primitives_tpu.ops import fft as F


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


def main(parts=("doa", "corr")):
    dev = jax.devices()[0]
    print(f"device: {dev}", flush=True)
    rng = np.random.default_rng(99)
    results = []
    digest = jax.jit(lambda o: sum(
        jnp.sum(jnp.abs(l).astype(jnp.float32).ravel()[:256])
        for l in jax.tree.leaves(o)
    ))

    # ---------------- Part 1: batched DOA
    m, tsnap = 8, 512
    wmax = 256 if "doa" in parts else 0
    t = np.arange(tsnap)
    wins = []
    for w in range(wmax):
        x = np.zeros((m, tsnap), np.complex64)
        for deg in (-31.0 + 0.2 * (w % 50), 14.0 + 0.15 * (w % 60)):
            a = np.exp(-2j * np.pi * 0.5
                       * np.sin(np.deg2rad(deg)) * np.arange(m))
            s = np.exp(2j * np.pi * (0.03 + 1e-3 * (w % 40)) * t
                       + 2j * np.pi * rng.uniform())
            x += np.outer(a, s)
        x += 0.15 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
        wins.append(x.astype(np.complex64))
    wins = (np.stack(wins) if wins
            else np.zeros((0, m, tsnap), np.complex64))  # [W, M, T]
    re_all, im_all = wins.real.copy(), wins.imag.copy()

    def doa1(re, im):
        return doa.estimate_doa(jax.lax.complex(re, im), 2)

    f1 = jax.jit(doa1)
    if wmax:
        r0 = jax.device_put(re_all[0], dev)
        i0 = jax.device_put(im_all[0], dev)
        b0 = np.asarray(f1(r0, i0))
        dt1 = _time(f1, (r0, i0), digest)
        per_win = 1.0 / dt1
        print(f"DOA per-window: {dt1*1e6:.0f} us -> {per_win:.0f} est/s",
              flush=True)
        results.append({"bench": "doa music 8x512", "mode": "per_window",
                        "batch": 1, "us_per_call": dt1 * 1e6,
                        "estimates_per_s": per_win})

    fb = jax.jit(doa1)  # same fn; batched shapes compile separately
    for w in (16, 64, 256) if wmax else ():
        rw = jax.device_put(re_all[:w], dev)
        iw = jax.device_put(im_all[:w], dev)
        bw = np.asarray(fb(rw, iw))
        # bearings unchanged vs per-window (0.1 deg = the device DOA
        # accuracy contract; batched vs single eigh round differently)
        worst = 0.0
        for j in (0, w // 2, w - 1):
            single = np.asarray(f1(jax.device_put(re_all[j], dev),
                                   jax.device_put(im_all[j], dev)))
            worst = max(worst, float(np.max(np.abs(bw[j] - single))))
        assert worst < np.deg2rad(0.1), (w, np.rad2deg(worst))
        print(f"  bearings max dev vs per-window: {np.rad2deg(worst):.4f} deg",
              flush=True)
        dtb = _time(fb, (rw, iw), digest)
        eps = w / dtb
        print(f"DOA W={w}: {dtb*1e3:.2f} ms -> {eps:.0f} est/s "
              f"({eps/per_win:.1f}x)", flush=True)
        results.append({"bench": "doa music 8x512", "mode": "batched",
                        "batch": w, "ms_per_call": dtb * 1e3,
                        "estimates_per_s": eps,
                        "speedup_vs_per_window": eps / per_win})

    # ---------------- Part 2: correlator-2048 factor A/B
    from aether_primitives_tpu.ops.fft import mm_fft

    batch = 1024
    for n in (1024, 2048) if "corr" in parts else ():
        x = (rng.normal(size=(batch, n))
             + 1j * rng.normal(size=(batch, n))).astype(np.complex64)
        ref = np.zeros(n, np.complex64)
        ref[:64] = (rng.normal(size=64) + 1j * rng.normal(size=64))
        xr = jax.device_put(x.real.copy(), dev)
        xi = jax.device_put(x.imag.copy(), dev)
        rr = jax.device_put(np.broadcast_to(ref.real, (1, n)).copy(), dev)
        ri = jax.device_put(np.broadcast_to(ref.imag, (1, n)).copy(), dev)
        factors = [None, 128, 64, 32, 16, 8] if n == 2048 else [None, 8]

        def make(ff):
            def corr(ar, ai, br, bi):
                a = jax.lax.complex(ar, ai)
                b = jax.lax.complex(br, bi)
                spec = mm_fft(a, -1, first_factor=ff) * jnp.conj(
                    mm_fft(b, -1, first_factor=ff)
                )
                out = mm_fft(spec, +1, first_factor=ff) * jnp.float32(1.0 / n)
                # f32 planes out: complex cannot cross host<->device here
                return jnp.real(out), jnp.imag(out)
            return jax.jit(corr)

        fns = {ff: make(ff) for ff in factors}
        gold = None
        for ff, fn in fns.items():
            gr, gi = fn(xr, xi, rr, ri)
            out = np.asarray(gr) + 1j * np.asarray(gi)
            if gold is None:
                gold = out
            else:
                err = np.sqrt(np.mean(np.abs(out - gold) ** 2)
                              / np.mean(np.abs(gold) ** 2))
                assert err < 1e-4, (ff, err)
        # interleaved rounds: one marginal-cost round per factor, repeated
        times = {ff: [] for ff in factors}
        for _round in range(4):
            for ff, fn in fns.items():
                dt = _time(fn, (xr, xi, rr, ri), digest, rounds=1)
                if dt is not None:
                    times[ff].append(dt)
        for ff in factors:
            if not times[ff]:
                continue
            dt = min(times[ff])
            msps = batch * n / dt / 1e6
            label = "table" if ff is None else f"n1={ff}"
            print(f"corr {n} {label}: {dt*1e6:.0f} us -> {msps:.0f} Msa/s",
                  flush=True)
            results.append({"bench": f"correlator {n} factor A/B",
                            "first_factor": ff or "table",
                            "us_per_call": dt * 1e6,
                            "msamples_per_s": msps})

    out = {
        "bench": "batched DOA scan + correlator-2048 factor diagnosis",
        "device": str(dev),
        "method": "min of interleaved marginal-cost rounds, jitted digest; "
                  "DOA bearings cross-checked vs per-window on the device",
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"results_{'_'.join(parts)}_r4.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("doa", "corr"))
