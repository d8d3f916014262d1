"""QC-LDPC check-update layout A/B on the device.

Compares the committed decoder (degree-class-batched check update + ONE
static gather for circulant alignment, ops/ldpc.py) against the
round-3 formulation (Python loop over block rows + per-edge rolls),
interleaved in one session. The old implementation is inlined below
verbatim (from git history) so the A/B is honest — both run the same
min-sum math and must produce identical bits.

Rows: 802.11n n=648 (12 block rows, E=88, z=27) and the NR-structured
BG2 z=64 graph (42 rows, E~170) at batch 64 / 1024.

Writes benches/results_qc_layout_r4.json.
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
from aether_primitives_tpu.ops import ldpc as L
from aether_primitives_tpu.ops.ldpc import _WIFI_648_R12, _qc_edges
from aether_primitives_tpu.ops.nr_ldpc import NrLdpc, make_nr_base_graph


def qc_decode_rows(llrs, base, z, iters=25, alpha=0.75):
    """The round-3 implementation: row-loop check update + per-edge rolls."""
    base = np.asarray(base, np.int64)
    rows_np, cols_np, shifts_np, row_slices = _qc_edges(
        tuple(map(tuple, base.tolist()))
    )
    mb, nb = base.shape
    n = nb * z
    lam = jnp.asarray(llrs, jnp.float32)
    bshape = lam.shape[:-1]
    lam_v = jnp.moveaxis(
        lam.reshape(bshape + (nb, z)), tuple(range(len(bshape))),
        tuple(range(-len(bshape), 0)),
    )
    e_count = rows_np.shape[0]
    cols_j = jnp.asarray(cols_np)
    mcol = np.zeros((nb, e_count), np.float32)
    mcol[cols_np, np.arange(e_count)] = 1.0
    mcol_j = jnp.asarray(mcol)
    big = jnp.float32(1e30)

    def to_check(v):
        return jnp.stack(
            [jnp.roll(v[e], -shifts_np[e], axis=0) for e in range(e_count)]
        )

    def to_var(c):
        return jnp.stack(
            [jnp.roll(c[e], shifts_np[e], axis=0) for e in range(e_count)]
        )

    def check_update(v2c_c):
        outs = []
        for (e0, e1) in row_slices:
            grp = v2c_c[e0:e1]
            mag = jnp.abs(grp)
            sgn = jnp.where(grp >= 0, 1.0, -1.0)
            row_sign = jnp.prod(sgn, axis=0, keepdims=True)
            m1 = jnp.min(mag, axis=0, keepdims=True)
            a1 = jnp.argmin(mag, axis=0)
            onehot = jax.nn.one_hot(a1, e1 - e0, dtype=jnp.float32)
            onehot = jnp.moveaxis(onehot, -1, 0)
            m2 = jnp.min(jnp.where(onehot == 1, big, mag), axis=0,
                         keepdims=True)
            ext = jnp.where(onehot == 1, m2, m1)
            outs.append(alpha * row_sign * sgn * ext)
        return jnp.concatenate(outs, axis=0)

    def contract_cols(c2v_v):
        flat = c2v_v.reshape(e_count, -1)
        tot = jnp.matmul(mcol_j, flat, precision=jax.lax.Precision.HIGHEST)
        return tot.reshape((nb,) + c2v_v.shape[1:])

    def bp_iter(c2v_v, _):
        col_total = lam_v + contract_cols(c2v_v)
        v2c_v = jnp.take(col_total, cols_j, axis=0) - c2v_v
        c2v_c = check_update(to_check(v2c_v))
        return to_var(c2v_c), None

    c2v0 = jnp.zeros((e_count,) + lam_v.shape[1:], jnp.float32)
    c2v, _ = jax.lax.scan(bp_iter, c2v0, None, length=int(iters))
    post = lam_v + contract_cols(c2v)
    hard_v = (post < 0).astype(jnp.uint8)
    nb_batch = len(bshape)
    hard = jnp.moveaxis(
        hard_v, tuple(range(-nb_batch, 0)) if nb_batch else (),
        tuple(range(nb_batch)) if nb_batch else (),
    )
    return hard.reshape(bshape + (n,))


def qc_decode_hybrid(llrs, base, z, iters=25, alpha=0.75):
    """Degree-class check update + per-edge ROLL alignment (hybrid)."""
    from aether_primitives_tpu.ops.ldpc import _qc_degree_classes

    base = np.asarray(base, np.int64)
    key = tuple(map(tuple, base.tolist()))
    rows_np, cols_np, shifts_np, row_slices = _qc_edges(key)
    classes, pos_of_edge = _qc_degree_classes(key)
    mb, nb = base.shape
    n = nb * z
    lam = jnp.asarray(llrs, jnp.float32)
    bshape = lam.shape[:-1]
    lam_v = jnp.moveaxis(
        lam.reshape(bshape + (nb, z)), tuple(range(len(bshape))),
        tuple(range(-len(bshape), 0)),
    )
    e_count = rows_np.shape[0]
    cols_j = jnp.asarray(cols_np)
    mcol = np.zeros((nb, e_count), np.float32)
    mcol[cols_np, np.arange(e_count)] = 1.0
    mcol_j = jnp.asarray(mcol)
    big = jnp.float32(1e30)
    pos_j = jnp.asarray(pos_of_edge)

    def to_check(v):
        return jnp.stack(
            [jnp.roll(v[e], -shifts_np[e], axis=0) for e in range(e_count)]
        )

    def to_var(c):
        return jnp.stack(
            [jnp.roll(c[e], shifts_np[e], axis=0) for e in range(e_count)]
        )

    def check_update(v2c_c):
        outs = []
        rest = v2c_c.shape[1:]
        for d, eidx, _r in classes:
            grp = jnp.take(v2c_c, jnp.asarray(eidx.reshape(-1)), axis=0)
            grp = grp.reshape((eidx.shape[0], d) + rest)
            mag = jnp.abs(grp)
            sgn = jnp.where(grp >= 0, 1.0, -1.0)
            row_sign = jnp.prod(sgn, axis=1, keepdims=True)
            m1 = jnp.min(mag, axis=1, keepdims=True)
            a1 = jnp.argmin(mag, axis=1)
            onehot = jax.nn.one_hot(a1, d, dtype=jnp.float32, axis=1)
            m2 = jnp.min(jnp.where(onehot == 1, big, mag), axis=1,
                         keepdims=True)
            ext = jnp.where(onehot == 1, m2, m1)
            outs.append((alpha * row_sign * sgn * ext).reshape(
                (eidx.size,) + rest))
        return jnp.take(jnp.concatenate(outs, axis=0), pos_j, axis=0)

    def contract_cols(c2v_v):
        flat = c2v_v.reshape(e_count, -1)
        tot = jnp.matmul(mcol_j, flat, precision=jax.lax.Precision.HIGHEST)
        return tot.reshape((nb,) + c2v_v.shape[1:])

    def bp_iter(c2v_v, _):
        col_total = lam_v + contract_cols(c2v_v)
        v2c_v = jnp.take(col_total, cols_j, axis=0) - c2v_v
        c2v_c = check_update(to_check(v2c_v))
        return to_var(c2v_c), None

    c2v0 = jnp.zeros((e_count,) + lam_v.shape[1:], jnp.float32)
    c2v, _ = jax.lax.scan(bp_iter, c2v0, None, length=int(iters))
    post = lam_v + contract_cols(c2v)
    hard_v = (post < 0).astype(jnp.uint8)
    nb_batch = len(bshape)
    hard = jnp.moveaxis(
        hard_v, tuple(range(-nb_batch, 0)) if nb_batch else (),
        tuple(range(nb_batch)) if nb_batch else (),
    )
    return hard.reshape(bshape + (n,))


def _time(fn, args, digest, rounds=1, k1=3, k2=12):
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
    rng = np.random.default_rng(5)
    digest = jax.jit(lambda o: sum(
        jnp.sum(l.astype(jnp.float32).ravel()[:256])
        for l in jax.tree.leaves(o)
    ))
    results = []

    configs = [
        ("11n z=27", _WIFI_648_R12, 27, 648),
        ("NR BG2 z=64", make_nr_base_graph(2, 64), 64, 52 * 64),
    ]
    for name, base, z, n in configs:
        for batch in (64, 1024):
            llr = rng.normal(size=(batch, n)).astype(np.float32) * 2 + 1
            llr_d = jax.device_put(llr, dev)
            new = jax.jit(
                lambda v: L.qc_ldpc_decode(v, base, z, iters=25)[0]
            )
            old = jax.jit(lambda v: qc_decode_rows(v, base, z, iters=25))
            hyb = jax.jit(lambda v: qc_decode_hybrid(v, base, z, iters=25))
            h_new = np.asarray(new(llr_d))
            h_old = np.asarray(old(llr_d))
            h_hyb = np.asarray(hyb(llr_d))
            assert (h_new == h_old).all() and (h_hyb == h_old).all(), (
                name, batch)
            # interleaved rounds
            t_new, t_old, t_hyb = [], [], []
            for _ in range(4):
                for fn, acc in ((new, t_new), (old, t_old), (hyb, t_hyb)):
                    d = _time(fn, (llr_d,), digest)
                    if d is not None:
                        acc.append(d)
            dn, do, dh = min(t_new), min(t_old), min(t_hyb)
            print(f"{name} b{batch}: classes+gather {dn*1e3:.2f} ms, "
                  f"rows+rolls {do*1e3:.2f} ms, classes+rolls {dh*1e3:.2f} "
                  f"ms", flush=True)
            results.append({
                "code": name, "batch": batch,
                "classes_gather_ms": dn * 1e3, "rows_rolls_ms": do * 1e3,
                "classes_rolls_ms": dh * 1e3, "bits_identical": True,
            })

    out = {
        "bench": "QC-LDPC check-update layout A/B (interleaved)",
        "device": str(dev),
        "results": results,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_qc_layout_r4.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
