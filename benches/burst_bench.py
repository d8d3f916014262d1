"""Batched burst RX bench on the device.

Per-FEC A/B in one session, interleaved marginal-cost rounds: the
per-burst ``PacketModem.rx`` latency path vs ``rx_batch`` over
``[B, window]`` captures at B in {16, 64, 256}. Every row checks payload
exactness on the device before it is timed; batch rows must be
bit-identical to the per-burst path (the CPU test asserts this exactly;
here the payload check catches any device-side divergence). Captures are
generated in this process from a fixed seed.

Writes benches/results_burst.json.
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
from aether_primitives_tpu.models.packet import PacketConfig, PacketModem

PAYLOAD_BITS = 600
CAPTURE = 16384
BATCHES = (16, 64, 256)
FECS = ("viterbi", "turbo", "ldpc11n", "rs", "ccsds")


def _channel(burst, rng, delay, cfo, snr_sigma=0.05):
    x = np.zeros(CAPTURE, np.complex64)
    x[delay : delay + burst.size] = burst
    n = np.arange(CAPTURE)
    x = x * (0.5 * np.exp(1j * 0.8)) * np.exp(2j * np.pi * cfo * n)
    x += snr_sigma * (rng.normal(size=CAPTURE) + 1j * rng.normal(size=CAPTURE))
    return x.astype(np.complex64)


def gen_captures():
    """TX every burst + channel, per FEC: ``{fec: (payloads, captures)}``."""
    rng = np.random.default_rng(4242)
    bmax = max(BATCHES)
    out = {}
    for fec in FECS:
        pm = PacketModem(PacketConfig(payload_bits=PAYLOAD_BITS, fec=fec))
        payloads = rng.integers(0, 2, (bmax, PAYLOAD_BITS)).astype(np.uint8)
        bursts = np.asarray(jax.jit(jax.vmap(pm.tx))(payloads))
        caps = np.stack([
            _channel(
                bursts[i], rng,
                delay=64 + (i * 53) % 2048, cfo=((i % 7) - 3) * 3e-4,
            )
            for i in range(bmax)
        ])
        out[fec] = (payloads, caps)
    return out


def main():
    def p(msg):
        print(msg, flush=True)

    data = gen_captures()
    dev = jax.devices()[0]
    p(f"device: {dev}")
    results = []

    for fec in FECS:
        pm = PacketModem(PacketConfig(payload_bits=PAYLOAD_BITS, fec=fec))
        payloads, caps = data[fec]

        def rx1(x):
            bits, ok, _ = pm.rx(x)
            return bits, ok

        def rxb(x):
            bits, ok, _ = pm.rx_batch(x)
            return bits, ok

        digest = jax.jit(
            lambda bits, ok: jnp.sum(bits.astype(jnp.float32))
            + jnp.sum(ok.astype(jnp.float32))
        )

        # ---- per-burst latency path
        f1 = jax.jit(rx1)
        x0 = jax.device_put(caps[0], dev)
        t0 = time.time()
        bits, ok = f1(x0)
        bits_h = np.asarray(bits)
        assert bool(np.asarray(ok)), f"{fec}: per-burst CRC failed"
        assert (bits_h == payloads[0]).all(), f"{fec}: per-burst payload wrong"
        p(f"{fec}: per-burst compile+first {time.time()-t0:.1f}s, payload exact")

        def run1(k):
            t = time.perf_counter()
            o = None
            for _ in range(k):
                o = f1(x0)
            float(np.asarray(digest(*o)))
            return time.perf_counter() - t

        run1(2)
        dt1 = None
        for _ in range(3):
            d, _f = marginal_cost(run1, 3, 12)
            if d is not None:
                dt1 = d if dt1 is None else min(dt1, d)
        per_burst = 1.0 / dt1 if dt1 else None
        p(f"{fec}: per-burst {dt1*1e3:.2f} ms -> {per_burst:.0f} bursts/s")
        results.append({
            "fec": fec, "mode": "per_burst", "batch": 1,
            "ms_per_call": dt1 * 1e3, "bursts_per_s": per_burst,
        })

        # ---- batched path
        fb = jax.jit(rxb)
        for b in BATCHES:
            xb = jax.device_put(caps[:b], dev)
            t0 = time.time()
            bits, ok = fb(xb)
            bits_h, ok_h = np.asarray(bits), np.asarray(ok)
            assert ok_h.all(), f"{fec} B={b}: {int((~ok_h).sum())} CRC fails"
            assert (bits_h == payloads[:b]).all(), f"{fec} B={b}: payload wrong"
            p(f"{fec}: B={b} compile+first {time.time()-t0:.1f}s, payloads exact")

            def runb(k):
                t = time.perf_counter()
                o = None
                for _ in range(k):
                    o = fb(xb)
                float(np.asarray(digest(*o)))
                return time.perf_counter() - t

            runb(2)
            dtb = None
            for _ in range(3):
                d, _f = marginal_cost(runb, 3, 12)
                if d is not None:
                    dtb = d if dtb is None else min(dtb, d)
            bps = b / dtb if dtb else None
            speedup = bps / per_burst if (bps and per_burst) else None
            p(f"{fec}: B={b} {dtb*1e3:.2f} ms/call -> {bps:.0f} bursts/s "
              f"({speedup:.1f}x per-burst)")
            results.append({
                "fec": fec, "mode": "rx_batch", "batch": b,
                "ms_per_call": dtb * 1e3, "bursts_per_s": bps,
                "speedup_vs_per_burst": speedup,
            })

    out = {
        "bench": "batched burst RX (PacketModem.rx vs rx_batch)",
        "payload_bits": PAYLOAD_BITS, "capture_len": CAPTURE,
        "device": str(dev),
        "device_kind": dev.device_kind,
        "method": "min of 3 marginal-cost rounds, jitted digest fetch; "
                  "payload exactness asserted on the device per row",
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_burst.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    p(f"wrote {path}")


if __name__ == "__main__":
    main()
