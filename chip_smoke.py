#!/usr/bin/env python3
"""Smoke run of the library's main paths on NVIDIA GPUs, at full width.

    python chip_smoke.py               # one card: RX chain, then burst link
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One process drives every card. Phases, in order:

- device: ``jax.devices()`` and ``nvidia-smi``'s name and power limit;
  anything but a GPU is a failure;
- RX chain: the headline streaming receive chain (65-tap FIR, decimation
  by 4, 2048-point FFT, QPSK demod, packed bits) on 4,194,304-sample
  blocks, gated against the float64 reference like ``aether-bench``;
- burst link: ``PacketModem.rx_batch`` on 256 captures of 16,384 samples
  for every trellis/LDPC/RS FEC, every payload exact and every CRC good;
- ``--four-cards`` instead: ``RxChain.sharded_streaming_step_2d``,
  ``sharded_ddc`` and ``PacketModem.rx_batch_sharded`` on four cards,
  each against its single-card run.

Every phase raises on a failed check, so the script exits non-zero; the
last line of standard output is a JSON object with ``"ok": true`` only
when every phase passed.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np

import jax

from aether_primitives_tpu.boundary import Split
from aether_primitives_tpu.cli import enable_compile_cache, rx_chain_gate
from aether_primitives_tpu.models import RxChain, RxChainConfig
from aether_primitives_tpu.models.ddc import Ddc, DdcConfig, sharded_ddc
from aether_primitives_tpu.models.packet import PacketConfig, PacketModem
from aether_primitives_tpu.parallel.mesh import make_mesh

BLOCK = 1 << 22
FECS = ("viterbi", "turbo", "ldpc11n", "rs", "ccsds")
P = jax.sharding.PartitionSpec


def card_name_and_limit() -> list:
    """``nvidia-smi``'s name and power limit, one line per card. Run as a
    child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def _peak_bytes(dev) -> str:
    stats = dev.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not reported"
    return str(stats["peak_bytes_in_use"])


def _hlo_ops(compiled) -> dict:
    """Counts of the HLO ops that could run on tensor cores (and the FFTs)
    in a compiled executable."""
    text = compiled.as_text()
    return {
        "dot": text.count(" dot("),
        "convolution": text.count(" convolution("),
        "gemm_custom_call": text.count("gemm"),
        "fft": text.count(" fft("),
    }


def _median_ms(fn, steps: int) -> float:
    """Median wall time of ``fn()`` over ``steps`` calls, each ending in
    ``block_until_ready``."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _scan_lengths(jaxpr) -> collections.Counter:
    """``{scan length: count}`` over every ``lax.scan`` in a jaxpr,
    nested ones included."""
    found = collections.Counter()

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "scan":
                found[int(eqn.params["length"])] += 1
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    return found


def device_phase(expect_count: int):
    """The devices JAX sees; exits when they are not GPUs."""
    devs = jax.devices()
    d0 = devs[0]
    print(f"device: platform={d0.platform} kind={d0.device_kind} "
          f"count={len(devs)}", flush=True)
    if d0.platform != "gpu":
        sys.exit(f"FAIL: no GPU (platform {d0.platform!r})")
    if len(devs) < expect_count:
        sys.exit(f"FAIL: {expect_count} GPUs needed, {len(devs)} found")
    cards = card_name_and_limit()
    for c in cards:
        print(f"card: {c}", flush=True)
    return devs, cards[0]


def rx_chain_phase(card: str, n: int = BLOCK, fft_len: int = 2048,
                   decimation: int = 4, steps: int = 20,
                   seed: int = 815) -> dict:
    """The streaming RX chain on two consecutive ``n``-sample blocks (the
    gate), then ``steps`` timed blocks."""
    dev = jax.devices()[0]
    chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=decimation,
                                  packed_bits=True))
    step = chain.jitted_streaming(donate_state=True, split_boundary=True)
    rng = np.random.default_rng(seed)
    x_full = (rng.normal(size=2 * n)
              + 1j * rng.normal(size=2 * n)).astype(np.complex64)
    blk0 = Split(np.zeros(n, np.float32), np.zeros(n, np.float32))
    t0 = time.perf_counter()
    compiled = step.lower(blk0, chain.init_state_split()).compile()
    compile_s = time.perf_counter() - t0
    ops = _hlo_ops(compiled)
    print(f"rx_chain: fir_mode={chain.fir_mode} taps={chain.taps.shape[-1]} "
          f"fft_len={fft_len} dec={decimation} block={n} "
          f"compile_s={compile_s:.3f}", flush=True)
    print(f"rx_chain: hlo ops {ops} -> "
          + ("no matrix product, f32 throughout (TF32 cannot apply)"
             if not (ops["dot"] or ops["convolution"]
                     or ops["gemm_custom_call"])
             else "has matrix products: precision set by each call"),
          flush=True)
    print(f"rx_chain: memory_analysis {compiled.memory_analysis()}",
          flush=True)

    ok, agree, evm_db, state = rx_chain_gate(chain, compiled, x_full)
    print(f"rx_chain: gate bit_agreement={agree} (need >= 0.99999) "
          f"block2_evm_rms_db={evm_db:.2f} (need <= -80)", flush=True)
    if not ok:
        raise AssertionError(
            f"RX chain gate failed: agreement {agree}, EVM {evm_db:.2f} dB"
        )

    blocks = [
        jax.device_put(Split(rng.normal(size=n).astype(np.float32),
                             rng.normal(size=n).astype(np.float32)), dev)
        for _ in range(2)
    ]
    box = {"state": state, "i": 0}

    def one():
        bits, box["state"] = compiled(blocks[box["i"] % 2], box["state"])
        box["i"] += 1
        return bits

    for _ in range(3):
        jax.block_until_ready(one())
    ms = _median_ms(one, steps)
    msps = n / (ms * 1e-3) / 1e6
    print(f"rx_chain: median {ms:.4f} ms/block {msps:.1f} Msa/s over "
          f"{steps} blocks | {card}", flush=True)
    print(f"rx_chain: peak_bytes_in_use={_peak_bytes(dev)}", flush=True)
    return {"agreement": agree, "evm_db": evm_db, "ms_per_block": ms,
            "msps": msps, "compile_s": compile_s}


def _captures(pm: PacketModem, batch: int, capture: int,
              rng: np.random.Generator):
    """``batch`` TX bursts at staggered delays and CFOs through a complex
    gain and AWGN (the channel of the burst benchmark)."""
    payloads = rng.integers(0, 2, (batch, pm.config.payload_bits))
    bursts = np.asarray(jax.jit(jax.vmap(pm.tx))(payloads.astype(np.uint8)))
    i = np.arange(batch)
    delay = 64 + (i * 53) % 2048
    cfo = ((i % 7) - 3) * 3e-4
    x = np.zeros((batch, capture), np.complex64)
    for b in range(batch):
        x[b, delay[b]:delay[b] + bursts.shape[-1]] = bursts[b]
    t = np.arange(capture)
    x = x * (0.5 * np.exp(1j * 0.8)) * np.exp(2j * np.pi * cfo[:, None] * t)
    x += 0.05 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return payloads.astype(np.uint8), x.astype(np.complex64)


def burst_phase(card: str, fecs=FECS, batch: int = 256,
                capture: int = 16384, payload_bits: int = 600,
                steps: int = 10, seed: int = 4242) -> dict:
    """``PacketModem.rx_batch`` per FEC: every payload exact, every CRC
    good, then ``steps`` timed batches."""
    dev = jax.devices()[0]
    rng = np.random.default_rng(seed)
    out = {}
    for fec in fecs:
        pm = PacketModem(PacketConfig(payload_bits=payload_bits, fec=fec))
        payloads, caps = _captures(pm, batch, capture, rng)
        x = jax.device_put(caps, dev)
        fn = jax.jit(lambda v, pm=pm: pm.rx_batch(v)[:2])
        t0 = time.perf_counter()
        compiled = fn.lower(x).compile()
        compile_s = time.perf_counter() - t0
        bits, ok = (np.asarray(v) for v in compiled(x))
        n_bad = int((bits != payloads).any(axis=-1).sum())
        if n_bad or not ok.all():
            raise AssertionError(
                f"burst {fec}: {n_bad} wrong payloads, "
                f"{int((~ok).sum())} CRC failures of {batch}"
            )
        scans = dict(sorted(_scan_lengths(
            jax.make_jaxpr(lambda v, pm=pm: pm.rx_batch(v))(x)
        ).items()))
        ms = _median_ms(lambda: compiled(x), steps)
        bps = batch / (ms * 1e-3)
        print(f"burst {fec}: B={batch} payloads exact, crc ok | "
              f"compile_s={compile_s:.3f} median {ms:.4f} ms/batch "
              f"{bps:.1f} bursts/s | {card}", flush=True)
        print(f"burst {fec}: scan length -> count {scans}", flush=True)
        out[fec] = {"ms_per_batch": ms, "bursts_per_s": bps,
                    "compile_s": compile_s, "scans": scans}
    print(f"burst: peak_bytes_in_use={_peak_bytes(dev)}", flush=True)
    return out


def _on_distinct_devices(arr, want: int, what: str) -> None:
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) != want:
        raise AssertionError(f"{what}: shards on {len(devs)} devices, "
                             f"expected {want}")


def four_card_phase(card: str, devices, n_local: int = BLOCK,
                    fft_len: int = 2048, ddc_len: int = 4 * BLOCK,
                    batch: int = 256, capture: int = 16384,
                    seed: int = 99) -> dict:
    """The sharded paths on four devices, each against one device."""
    devices = list(devices)[:4]
    rng = np.random.default_rng(seed)
    ref_dev = devices[0]

    # streaming RX chain on a (channel 2, time 2) mesh: three blocks of a
    # [2, 3 * 2 * n_local] capture, n_local samples per card per block
    mesh = make_mesh({"channel": 2, "time": 2}, devices=devices)
    chain = RxChain(RxChainConfig(fft_len=fft_len, decimation=4,
                                  packed_bits=True))
    n_blk = 2 * n_local
    cap = (rng.normal(size=(2, 3 * n_blk))
           + 1j * rng.normal(size=(2, 3 * n_blk))).astype(np.complex64)
    blk_sh = jax.sharding.NamedSharding(mesh, P("channel", "time"))
    st_sh = jax.sharding.NamedSharding(mesh, P("channel", None))
    t0 = time.perf_counter()
    sfn = jax.jit(lambda b, s: chain.sharded_streaming_step_2d(b, s, mesh))
    st = jax.device_put(chain.init_state((2,)), st_sh)
    parts = []
    for i in range(3):
        blk = jax.device_put(cap[:, i * n_blk:(i + 1) * n_blk], blk_sh)
        bits_i, st = sfn(blk, st)
        _on_distinct_devices(bits_i, 4, "sharded RX chain bits")
        parts.append(np.asarray(bits_i))
    stream_s = time.perf_counter() - t0
    single = np.asarray(
        jax.jit(chain.step)(jax.device_put(cap, ref_dev))
    )
    rx_agree = float((np.concatenate(parts, axis=-1) == single).mean())
    print(f"four_cards rx_chain: 3 blocks of [2, {n_blk}] on mesh "
          f"{dict(mesh.shape)} vs one card: bit_agreement={rx_agree} "
          f"(need 1.0) shards on 4 devices, {stream_s:.3f} s incl. "
          f"compile | {card}", flush=True)
    if rx_agree != 1.0:
        raise AssertionError(f"sharded RX chain agreement {rx_agree}")

    # DDC over a 4-card time mesh against Ddc.step on one card
    tmesh = jax.sharding.Mesh(np.asarray(devices), ("time",))
    cfg = DdcConfig(freq=0.21, decimation=4)
    xd = (rng.normal(size=ddc_len)
          + 1j * rng.normal(size=ddc_len)).astype(np.complex64)
    got_d = jax.jit(lambda v: sharded_ddc(v, cfg, tmesh))(
        jax.device_put(xd, jax.sharding.NamedSharding(tmesh, P("time")))
    )
    _on_distinct_devices(got_d, 4, "sharded DDC")
    got_d = np.asarray(got_d)
    ref_d = np.asarray(jax.jit(Ddc(cfg).step)(jax.device_put(xd, ref_dev)))
    ddc_err = float(np.sqrt(np.mean(np.abs(got_d - ref_d) ** 2)
                            / np.mean(np.abs(ref_d) ** 2)))
    print(f"four_cards ddc: {ddc_len} samples, rms_rel_err={ddc_err:.3e} "
          f"(need < 1e-5) shards on 4 devices | {card}", flush=True)
    if not ddc_err < 1e-5:
        raise AssertionError(f"sharded DDC error {ddc_err}")

    # burst link, bursts data-parallel over a 4-card mesh
    dmesh = jax.sharding.Mesh(np.asarray(devices), ("channel",))
    pm = PacketModem(PacketConfig(payload_bits=600, fec="rs"))
    payloads, caps = _captures(pm, batch, capture, rng)
    bits_s, ok_s = jax.jit(lambda v: pm.rx_batch_sharded(v, dmesh)[:2])(
        jax.device_put(caps, jax.sharding.NamedSharding(dmesh, P("channel")))
    )
    _on_distinct_devices(bits_s, 4, "sharded burst payloads")
    bits_u, ok_u = jax.jit(lambda v: pm.rx_batch(v)[:2])(
        jax.device_put(caps, ref_dev)
    )
    bits_s, ok_s, bits_u, ok_u = (np.asarray(v)
                                  for v in (bits_s, ok_s, bits_u, ok_u))
    same = bool(np.array_equal(bits_s, bits_u)
                and np.array_equal(ok_s, ok_u))
    exact = bool((bits_s == payloads).all() and ok_s.all())
    print(f"four_cards burst rs: B={batch} sharded == one card: {same}, "
          f"payloads exact: {exact} | {card}", flush=True)
    if not (same and exact):
        raise AssertionError("sharded burst link differs from one card")
    return {"rx_agreement": rx_agree, "ddc_err": ddc_err,
            "burst_identical": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)
    enable_compile_cache()
    devs, card = device_phase(4 if args.four_cards else 1)
    if args.four_cards:
        four_card_phase(card, devs[:4])
        count = 4
    else:
        rx_chain_phase(card)
        burst_phase(card)
        count = len(devs)
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
