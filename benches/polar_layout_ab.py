"""Polar BP scan-carry layout A/B on the device.

Question: does ``polar_decode_bp`` lose its batching win at large batch
because of its scan carry? Hypothesis: the
``[stages+1, B, N]`` stacked scan carry — every one of the
``2*stages`` per-iteration column writes is a ``dynamic_update_slice``
into the full (stages+1)-plane tensor, so if XLA fails to elide the
copies the per-iteration traffic scales with the whole trellis rather
than the two columns actually touched.

Variant B keeps the SAME message schedule and min-sum math but carries
the columns as a TUPLE of ``stages+1`` separate ``[B, N]`` arrays:
updating column ``s`` rebinds one tuple slot — no stacked-tensor
update at all. Outputs must be bit-identical (same arithmetic, same
order); only the carry layout differs.

Interleaved A/B with marginal_cost spans. Writes
``benches/results_polar_layout_r4.json``.
"""

import functools
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


def polar_decode_bp_stacked(llrs, info_mask, iters: int = 40):
    """The round-4 pre-A/B implementation: stacked [stages+1, B, N] carry
    with .at[s].set column writes (variant A, inlined from git history —
    the committed decoder now uses the tuple layout, variant B)."""
    mask = P._check_mask(info_mask)
    n = mask.shape[0]
    stages = int(np.log2(n))
    llr = jnp.asarray(llrs, jnp.float32)
    lead = llr.shape[:-1]
    flat = llr.reshape((-1, n))
    batch = flat.shape[0]

    r0 = jnp.broadcast_to(
        jnp.asarray(np.where(mask, 0.0, 1e9), jnp.float32), (batch, n)
    )

    def pairs(v, s):
        step = 1 << s
        blk = v.reshape(batch, n // (2 * step), 2, step)
        return blk[:, :, 0, :], blk[:, :, 1, :]

    def unpairs(a, b):
        out = jnp.stack([a, b], axis=2)
        return out.reshape(batch, -1)

    def bp_iter(carry, _):
        l_cols, r_cols = carry  # each [stages+1, batch, n]
        for s in range(stages - 1, -1, -1):
            lx1, lx2 = pairs(l_cols[s + 1], s)
            ru1, ru2 = pairs(r_cols[s], s)
            lu1 = P._f_minsum(lx1, lx2 + ru2)
            lu2 = P._f_minsum(lx1, ru1) + lx2
            l_cols = l_cols.at[s].set(unpairs(lu1, lu2))
        for s in range(stages):
            lx1, lx2 = pairs(l_cols[s + 1], s)
            ru1, ru2 = pairs(r_cols[s], s)
            rx1 = P._f_minsum(ru1, ru2 + lx2)
            rx2 = P._f_minsum(ru1, lx1) + ru2
            r_cols = r_cols.at[s + 1].set(unpairs(rx1, rx2))
        return (l_cols, r_cols), None

    l_cols = jnp.zeros((stages + 1, batch, n), jnp.float32)
    l_cols = l_cols.at[stages].set(flat)
    r_cols = jnp.zeros((stages + 1, batch, n), jnp.float32)
    r_cols = r_cols.at[0].set(r0)
    (l_cols, r_cols), _ = jax.lax.scan(
        bp_iter, (l_cols, r_cols), None, length=int(iters)
    )

    u_hard = ((l_cols[0] + r_cols[0]) < 0).astype(jnp.uint8)
    x_hard = ((l_cols[stages] + r_cols[stages]) < 0).astype(jnp.uint8)
    info_idx = np.where(mask)[0]
    bits = jnp.take(u_hard, jnp.asarray(info_idx), axis=-1)
    reenc = P.polar_encode(bits, mask)
    ok = jnp.all(reenc == x_hard, axis=-1)
    return bits.reshape(lead + (int(mask.sum()),)), ok.reshape(lead)


def polar_decode_bp_tuple(llrs, info_mask, iters: int = 40):
    """polar_decode_bp with a tuple-of-columns carry (layout variant B).

    This layout WON the A/B and is now the committed implementation
    (ops/polar.py); kept inline here so the script reproduces the
    experiment as run."""
    mask = P._check_mask(info_mask)
    n = mask.shape[0]
    stages = int(np.log2(n))
    llr = jnp.asarray(llrs, jnp.float32)
    lead = llr.shape[:-1]
    flat = llr.reshape((-1, n))
    batch = flat.shape[0]

    r0 = jnp.broadcast_to(
        jnp.asarray(np.where(mask, 0.0, 1e9), jnp.float32), (batch, n)
    )

    def pairs(v, s):
        step = 1 << s
        blk = v.reshape(batch, n // (2 * step), 2, step)
        return blk[:, :, 0, :], blk[:, :, 1, :]

    def unpairs(a, b):
        out = jnp.stack([a, b], axis=2)
        return out.reshape(batch, -1)

    def bp_iter(carry, _):
        l_cols, r_cols = carry  # tuples of [batch, n], len stages+1
        l_cols = list(l_cols)
        r_cols = list(r_cols)
        for s in range(stages - 1, -1, -1):
            lx1, lx2 = pairs(l_cols[s + 1], s)
            ru1, ru2 = pairs(r_cols[s], s)
            lu1 = P._f_minsum(lx1, lx2 + ru2)
            lu2 = P._f_minsum(lx1, ru1) + lx2
            l_cols[s] = unpairs(lu1, lu2)
        for s in range(stages):
            lx1, lx2 = pairs(l_cols[s + 1], s)
            ru1, ru2 = pairs(r_cols[s], s)
            rx1 = P._f_minsum(ru1, ru2 + lx2)
            rx2 = P._f_minsum(ru1, lx1) + ru2
            r_cols[s + 1] = unpairs(rx1, rx2)
        return (tuple(l_cols), tuple(r_cols)), None

    zeros = jnp.zeros((batch, n), jnp.float32)
    l_cols = tuple(flat if s == stages else zeros for s in range(stages + 1))
    r_cols = tuple(r0 if s == 0 else zeros for s in range(stages + 1))
    (l_cols, r_cols), _ = jax.lax.scan(
        bp_iter, (l_cols, r_cols), None, length=int(iters)
    )

    u_hard = ((l_cols[0] + r_cols[0]) < 0).astype(jnp.uint8)
    x_hard = ((l_cols[stages] + r_cols[stages]) < 0).astype(jnp.uint8)
    info_idx = np.where(mask)[0]
    bits = jnp.take(u_hard, jnp.asarray(info_idx), axis=-1)
    reenc = P.polar_encode(bits, mask)
    ok = jnp.all(reenc == x_hard, axis=-1)
    return bits.reshape(lead + (int(mask.sum()),)), ok.reshape(lead)


def main():
    n, k, iters = 256, 128, 40
    mask = P.polar_construct(n, k, design_snr_db=2.0)
    rng = np.random.default_rng(41)

    impls = {
        "A_stacked": functools.partial(polar_decode_bp_stacked, iters=iters),
        "B_tuple": functools.partial(polar_decode_bp_tuple, iters=iters),
    }
    jitted = {
        name: jax.jit(functools.partial(fn, info_mask=mask))
        for name, fn in impls.items()
    }

    results = {"device": str(jax.devices()[0]), "n": n, "k": k,
               "iters": iters, "rows": []}
    for batch in (64, 1024):
        bits = rng.integers(0, 2, size=(batch, k)).astype(np.uint8)
        x = np.asarray(P.polar_encode(bits, mask))
        tx = 1.0 - 2.0 * x.astype(np.float32)
        sigma = 10 ** (-2.5 / 20)  # ~2.5 dB Eb/N0-ish; exact value irrelevant
        llr = (2.0 / sigma**2) * (
            tx + sigma * rng.standard_normal(tx.shape).astype(np.float32)
        )
        llr_j = jnp.asarray(llr)

        outs = {}
        for name, f in jitted.items():
            b, ok = f(llrs=llr_j)
            outs[name] = (np.asarray(b), np.asarray(ok))
        ident = bool(
            np.array_equal(outs["A_stacked"][0], outs["B_tuple"][0])
            and np.array_equal(outs["A_stacked"][1], outs["B_tuple"][1])
        )

        row = {"batch": batch, "identical": ident}
        # interleaved rounds: alternate A/B within each round, keep best-of
        best = {name: float("inf") for name in jitted}
        for _ in range(3):
            for name, f in jitted.items():
                def run(kk, f=f):
                    t0 = time.perf_counter()
                    for _ in range(kk):
                        out = f(llrs=llr_j)
                    jax.block_until_ready(out)
                    return time.perf_counter() - t0
                run(1)  # warm
                dt, floor = marginal_cost(run, 2, 6)
                per = dt if dt is not None else floor
                best[name] = min(best[name], per)
        for name, per in best.items():
            row[name] = {
                "ms_per_call": per * 1e3,
                "info_mbit_s": batch * k / per / 1e6,
            }
        results["rows"].append(row)
        print(json.dumps(row))

    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "results_polar_layout_r4.json")
    with open(out_path, "w") as fh:
        json.dump(results, fh, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
