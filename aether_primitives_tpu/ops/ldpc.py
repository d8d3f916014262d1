"""LDPC codes: GF(2) matmul encoding + batched min-sum decoding.

The modern block-code complement to :mod:`.fec`'s convolutional/Viterbi
pair (the reference has no channel coding at all — this extends the
capability surface the same way the Viterbi layer did). The design is
dictated by the hardware:

- **Encoding** is one f32 matmul mod 2 against a precomputed systematic
  generator (``u @ G``, exact: dot products sum ≤ k ones < 2^24) — the
  same GF(2)-as-matmul trick as
  :func:`~aether_primitives_tpu.ops.sequence.lfsr_matrix_generate`.
  The generator is derived host-side from the parity-check matrix by
  GF(2) Gaussian elimination, once, cached.
- **Decoding** is normalized min-sum belief propagation with the
  messages held as a DENSE ``[m, n]`` plane masked by the parity-check
  support. Sparse edge lists (the CPU/ASIC idiom) become gathers and
  segment reductions that break XLA's fusion; the dense plane
  makes every iteration two masked row/column reductions and a few
  elementwise ops, all batched over codewords and fused by XLA. At
  LDPC sizes (n ~ 10^3, m ~ n/2) the dense plane is ~1 MB/codeword —
  cheap against device memory, and the batch dimension keeps the device
  full.

Code construction: :func:`make_regular_ldpc` builds a Gallager
(dv, dc)-regular ensemble with banded structure + fixed-seed column
permutations, retrying until the GF(2) rank is full so the advertised
rate is exact. Bring standard base graphs (802.11/5G QC-LDPC) via
``ldpc_generator(H)`` on any H of your own.

LLR convention matches the rest of the framework (positive = bit 0,
:func:`~.fec.hard_to_llr` / ``demod_soft``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------- GF(2) host math


def _gf2_row_reduce(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row-reduce ``h`` over GF(2) with column pivoting.

    Returns ``(reduced, perm, rank)`` where ``reduced[:, perm]`` would be
    in reduced row-echelon form with the identity in the first ``rank``
    permuted columns.
    """
    h = h.copy().astype(np.uint8) % 2
    m, n = h.shape
    perm = np.arange(n)
    rank = 0
    for col in range(n):
        if rank == m:
            break
        # find a pivot row at/below `rank` in any remaining column
        sub = h[rank:, perm[col]]
        nz = np.nonzero(sub)[0]
        if nz.size == 0:
            continue
        piv = rank + nz[0]
        if piv != rank:
            h[[rank, piv]] = h[[piv, rank]]
        # swap this column into pivot position `rank`
        perm[[rank, col]] = perm[[col, rank]]
        # eliminate everywhere else
        hits = np.nonzero(h[:, perm[rank]])[0]
        hits = hits[hits != rank]
        h[hits] ^= h[rank]
        rank += 1
    return h, perm, rank


def ldpc_generator(h: np.ndarray) -> np.ndarray:
    """Systematic generator ``G [k, n]`` for parity-check ``h [m, n]``,
    ``k = n - rank(h)`` (dependent check rows — standard in structured
    ensembles — just mean a few extra info bits). Satisfies
    ``(G @ h.T) % 2 == 0``; info bits land on the non-pivot columns of
    the reduction (systematic up to a column permutation — the decoder
    returns full codewords, ``info_indices`` of the build says where the
    message bits live)."""
    g, idx = _generator_and_info(np.asarray(h, np.uint8))
    del idx
    return g


def _generator_and_info(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    red, perm, rank = _gf2_row_reduce(h)
    _, n = h.shape
    k = n - rank
    # reduced system: bit at perm[j] (j < rank) = sum_i P[j, i] * info_i,
    # info_i = bit at perm[rank + i]. Rows beyond `rank` are zero in the
    # reduction (dependent checks) — automatically satisfied.
    p = red[:rank][:, perm[rank:]]  # [rank, k]
    g = np.zeros((k, n), np.uint8)
    g[np.arange(k), perm[rank:]] = 1
    g[:, perm[:rank]] = p.T
    return g, perm[rank:].copy()


@functools.lru_cache(maxsize=None)
def make_regular_ldpc(
    n: int = 648, dv: int = 3, dc: int = 6, seed: int = 7
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gallager ``(dv, dc)``-regular LDPC code: returns ``(H, G,
    info_indices)`` with ``H [m, n]`` (``m = n*dv/dc``), ``G [k, n]``,
    and the ``k`` codeword positions carrying the message bits.

    Construction: ``dv`` bands of ``m/dv`` rows; band 0 assigns variable
    ``v`` to check ``v // dc``; each further band applies a fixed-seed
    column permutation. Deterministic for a given ``(n, dv, dc, seed)``.
    Band sums are all-ones, so rank(H) ≤ m - (dv-1) by construction —
    ``k = n - rank`` is slightly above the nominal ``n - m`` (e.g. 326
    for the default 648/324 code); the dependent checks still
    participate in decoding.
    """
    if (n * dv) % dc:
        raise ValueError("n*dv must divide by dc")
    m = n * dv // dc
    if m % dv:
        raise ValueError("m must divide by dv (bands)")
    band_rows = m // dv
    if band_rows * dc != n:
        raise ValueError("inconsistent regular parameters")
    rng = np.random.default_rng(seed)
    h = np.zeros((m, n), np.uint8)
    for band in range(dv):
        cols = np.arange(n) if band == 0 else rng.permutation(n)
        for r in range(band_rows):
            h[band * band_rows + r, cols[r * dc : (r + 1) * dc]] = 1
    g, info = _generator_and_info(h)
    return h, g, info


# --------------------------------------------------------- QC-LDPC (802.11n)


def qc_expand(base: np.ndarray, z: int) -> np.ndarray:
    """Expand a QC-LDPC base matrix of circulant shifts into the full
    binary parity-check matrix.

    ``base[i, j] == -1`` becomes a ``[z, z]`` zero block; ``s >= 0``
    becomes the identity cyclically right-shifted by ``s`` columns —
    i.e. block-row ``i`` checks bit ``(t + s) mod z`` of block-column
    ``j``. The block-circulant structure is exactly the dense-friendly
    form: expansion is ``np.roll`` of an identity (host-side, once), and
    the decoder's dense masked plane never needs gathers.
    """
    base = np.asarray(base, np.int64)
    mb, nb = base.shape
    h = np.zeros((mb * z, nb * z), np.uint8)
    eye = np.eye(z, dtype=np.uint8)
    for i in range(mb):
        for j in range(nb):
            s = int(base[i, j])
            if s >= 0:
                h[i * z : (i + 1) * z, j * z : (j + 1) * z] = np.roll(
                    eye, -(s % z), axis=0
                )
    return h


#: IEEE 802.11n (Wi-Fi) rate-1/2 base matrix for n=648, Z=27
#: (IEEE Std 802.11-2012 Annex F, Table F-1). 12 block rows x 24 block
#: columns; the right 12 block columns are the standard dual-diagonal
#: parity structure. -1 = zero block, otherwise circulant shift.
_WIFI_648_R12 = np.array([
    [ 0, -1, -1, -1,  0,  0, -1, -1,  0, -1, -1,  0,  1,  0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [22,  0, -1, -1, 17, -1,  0,  0, 12, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [ 6, -1,  0, -1, 10, -1, -1, -1, 24, -1,  0, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1, -1, -1],
    [ 2, -1, -1,  0, 20, -1, -1, -1, 25,  0, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1, -1],
    [23, -1, -1, -1,  3, -1, -1, -1,  0, -1,  9, 11, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1, -1],
    [24, -1, 23,  1, 17, -1,  3, -1, 10, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1, -1],
    [25, -1, -1, -1,  8, -1, -1, -1,  7, 18, -1, -1,  0, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1, -1],
    [13, 24, -1, -1,  0, -1,  8, -1,  6, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1, -1, -1],
    [ 7, 20, -1, 16, 22, 10, -1, -1, 23, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1, -1],
    [11, -1, -1, -1, 19, -1, -1, -1, 13, -1,  3, 17, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0, -1],
    [25, -1,  8, -1, 23, 18, -1, 14,  9, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0,  0],
    [ 3, -1, -1, -1, 16, -1, -1,  2, 25,  5, -1, -1,  1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,  0],
], np.int64)


def _gf2_solve_parity(h: np.ndarray, k: int) -> np.ndarray:
    """For systematic ``h = [A | B]`` (``A [m, k]``, ``B [m, m]``
    invertible over GF(2)), return ``P = B^{-1} A  [m, k]`` so that
    parity ``p = P @ u (mod 2)`` completes ``[u | p]`` to a codeword."""
    m = h.shape[0]
    a = h[:, :k].astype(np.uint8).copy()
    b = h[:, k:].astype(np.uint8).copy()
    assert b.shape == (m, m)
    # Gauss-Jordan on [B | A] -> [I | B^{-1}A]
    for col in range(m):
        piv = col + np.nonzero(b[col:, col])[0]
        if piv.size == 0:
            raise ValueError("parity block is singular over GF(2)")
        p = piv[0]
        if p != col:
            b[[col, p]] = b[[p, col]]
            a[[col, p]] = a[[p, col]]
        hits = np.nonzero(b[:, col])[0]
        hits = hits[hits != col]
        b[hits] ^= b[col]
        a[hits] ^= a[col]
    return a


@functools.lru_cache(maxsize=None)
def wifi_ldpc(rate: str = "1/2") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IEEE 802.11n QC-LDPC, n=648, Z=27: returns ``(H, G, info_indices)``.

    Unlike :func:`make_regular_ldpc`'s random Gallager ensemble, this is
    the deployed standard code (802.11n Annex F), so
    ``PacketModem(fec="ldpc11n")`` interoperates at the codeword level
    with any compliant implementation. ``G = [I_k | P^T]`` is TRUE
    systematic (codeword = message bits followed by parity), derived by
    GF(2) elimination of the dual-diagonal parity block; encoding stays
    one f32 matmul mod 2 and :func:`ldpc_decode`'s dense masked plane
    handles H unchanged (324 x 648 ≈ 840 KB/codeword f32).
    """
    if rate != "1/2":
        raise ValueError("only the rate-1/2 n=648 code is built in; expand "
                         "any published base matrix with qc_expand")
    z = 27
    h = qc_expand(_WIFI_648_R12, z)
    m, n = h.shape
    k = n - m
    p = _gf2_solve_parity(h, k)  # [m, k]
    g = np.concatenate([np.eye(k, dtype=np.uint8), p.T], axis=1)  # [k, n]
    assert ((g @ h.T) % 2 == 0).all()
    return h, g, np.arange(k, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _qc_edges(base_key) -> tuple:
    """Edge tables for the QC decoder: edges sorted by block-row.

    Returns ``(rows, cols, shifts, row_slices)`` — numpy arrays over the
    ``E`` base-matrix edges plus per-block-row ``(start, stop)`` spans.
    """
    base = np.asarray(base_key, np.int64)
    rows, cols, shifts = [], [], []
    for i in range(base.shape[0]):
        for j in range(base.shape[1]):
            if base[i, j] >= 0:
                rows.append(i)
                cols.append(j)
                shifts.append(int(base[i, j]))
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    shifts = np.asarray(shifts)
    row_slices = []
    e0 = 0
    for i in range(base.shape[0]):
        e1 = e0 + int((rows == i).sum())
        row_slices.append((e0, e1))
        e0 = e1
    return rows, cols, shifts, tuple(row_slices)


def qc_ldpc_decode(
    llrs,
    base,
    z: int,
    iters: int = 25,
    alpha: float = 0.75,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Normalized min-sum decode exploiting the QC (block-circulant)
    structure: messages live per base-matrix EDGE (``[E, z, batch]``)
    instead of on the dense ``[m, n]`` plane.

    For the 802.11n n=648 code the dense plane holds 324*648 = 210k
    entries per codeword where only 88 edges * 27 = 2376 messages exist —
    the dense decoder moves ~88x redundant memory traffic. Runs the same min-sum update over the edge tensor with
    circulant alignment as static per-edge rolls. Same LLR convention
    and ``(hard, syndrome_ok)`` contract as :func:`ldpc_decode`; both
    converge to the same codeword on correctable channels (f32
    column-sum order differs, so marginal undecodable frames may flip
    different bits).

    ``base``: the ``[mb, nb]`` shift matrix (e.g. ``_WIFI_648_R12``),
    ``z``: lifting size. ``llrs [..., nb*z]``.
    """
    base = np.asarray(base, np.int64)
    rows_np, cols_np, shifts_np, row_slices = _qc_edges(
        tuple(map(tuple, base.tolist()))
    )
    mb, nb = base.shape
    n = nb * z
    lam = jnp.asarray(llrs, jnp.float32)
    if lam.shape[-1] != n:
        raise ValueError(f"LLR length {lam.shape[-1]} != code length {n}")
    bshape = lam.shape[:-1]
    # internal layout: [nb, z, B] — batch minor
    lam_v = jnp.moveaxis(lam.reshape(bshape + (nb, z)), tuple(range(len(bshape))),
                         tuple(range(-len(bshape), 0)))  # [nb, z, B...]
    e_count = rows_np.shape[0]
    cols_j = jnp.asarray(cols_np)

    # one-hot column-sum matrix: col_total = Mcol @ c2v (sum over edges)
    mcol = np.zeros((nb, e_count), np.float32)
    mcol[cols_np, np.arange(e_count)] = 1.0
    mcol_j = jnp.asarray(mcol)

    big = jnp.float32(1e30)

    # alignment: qc_expand's block (i, j, s) is np.roll(eye, -s, 0), i.e.
    # check (i, u) touches var (j, (u + s) mod z) -> check view = roll(-s)
    def to_check(v):  # variable -> check alignment
        return jnp.stack(
            [jnp.roll(v[e], -shifts_np[e], axis=0) for e in range(e_count)]
        )

    def to_var(c):  # check -> variable alignment
        return jnp.stack(
            [jnp.roll(c[e], shifts_np[e], axis=0) for e in range(e_count)]
        )

    def check_update(v2c_c):
        """Min-sum over each block-row's edges (check alignment)."""
        outs = []
        for (e0, e1) in row_slices:
            grp = v2c_c[e0:e1]  # [d, z, B...]
            mag = jnp.abs(grp)
            sgn = jnp.where(grp >= 0, 1.0, -1.0)
            row_sign = jnp.prod(sgn, axis=0, keepdims=True)
            m1 = jnp.min(mag, axis=0, keepdims=True)
            a1 = jnp.argmin(mag, axis=0)
            onehot = jax.nn.one_hot(a1, e1 - e0, dtype=jnp.float32)
            onehot = jnp.moveaxis(onehot, -1, 0)
            m2 = jnp.min(jnp.where(onehot == 1, big, mag), axis=0, keepdims=True)
            ext = jnp.where(onehot == 1, m2, m1)
            outs.append(alpha * row_sign * sgn * ext)
        return jnp.concatenate(outs, axis=0)

    def contract_cols(c2v_v):
        """Per-column sums of variable-aligned messages (one-hot matmul)."""
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

    post = lam_v + contract_cols(c2v)  # [nb, z, B...]
    hard_v = (post < 0).astype(jnp.uint8)
    # syndrome: per check bit, XOR of member bits at check alignment
    hard_e = jnp.take(hard_v, cols_j, axis=0)
    hard_c = to_check(hard_e.astype(jnp.float32)).astype(jnp.uint8)
    syn_ok_rows = []
    for i, (e0, e1) in enumerate(row_slices):
        par = jnp.sum(hard_c[e0:e1].astype(jnp.float32), axis=0) % 2
        syn_ok_rows.append(jnp.all(par == 0, axis=0))
    ok = jnp.stack(syn_ok_rows).all(axis=0)  # [B...]

    nb_batch = len(bshape)
    hard = jnp.moveaxis(hard_v, tuple(range(-nb_batch, 0)) if nb_batch else (),
                        tuple(range(nb_batch)) if nb_batch else ())
    hard = hard.reshape(bshape + (n,))
    return hard, ok


def ldpc_encode(bits, g) -> jnp.ndarray:
    """Encode ``[..., k]`` message bits to ``[..., n]`` codewords: one
    f32 matmul mod 2 (exact — 0/1 operands and row sums ≤ k < 2^24, so
    TF32 inputs lose nothing)."""
    u = jnp.asarray(bits).astype(jnp.float32) % 2
    gm = jnp.asarray(np.asarray(g, np.float32))
    return jnp.mod(u @ gm, 2.0).astype(jnp.uint8)


def ldpc_decode(
    llrs,
    h,
    iters: int = 25,
    alpha: float = 0.75,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Normalized min-sum decode. ``llrs [..., n]`` (positive = bit 0),
    ``h [m, n]`` (numpy 0/1). Returns ``(hard_bits [..., n],
    syndrome_ok [...])`` — ``syndrome_ok`` is True where every parity
    check is satisfied (the frame-level CRC-before-the-CRC).

    Each of ``iters`` scan steps does the full check/variable update on
    the dense masked ``[..., m, n]`` message plane:

    - check update: per-row sign product and smallest/second-smallest
      magnitude (the min-sum kernel), normalized by ``alpha`` — three
      masked row reductions;
    - variable update: per-column totals minus the incoming edge — one
      column reduction and a broadcast subtract.

    No gathers, no data-dependent control flow; everything batches over
    leading axes and fuses.
    """
    lam = jnp.asarray(llrs, jnp.float32)
    hm = np.asarray(h, np.float32)
    m, n = hm.shape
    if lam.shape[-1] != n:
        raise ValueError(f"LLR length {lam.shape[-1]} != code length {n}")
    mask = jnp.asarray(hm)  # [m, n]
    big = jnp.float32(1e30)
    lam_e = lam[..., None, :]  # [..., 1, n]
    v2c0 = lam_e * mask  # initial messages

    def bp_iter(v2c, _):
        # ---- check node update (rows)
        mag = jnp.where(mask == 1, jnp.abs(v2c), big)
        sgn = jnp.where(v2c >= 0, 1.0, -1.0)
        sgn = jnp.where(mask == 1, sgn, 1.0)
        row_sign = jnp.prod(sgn, axis=-1, keepdims=True)  # [..., m, 1]
        min1 = jnp.min(mag, axis=-1, keepdims=True)
        arg1 = jnp.argmin(mag, axis=-1)  # [..., m]
        onehot = jax.nn.one_hot(arg1, n, dtype=jnp.float32)  # [..., m, n]
        min2 = jnp.min(jnp.where(onehot == 1, big, mag), axis=-1, keepdims=True)
        ext_min = jnp.where(onehot == 1, min2, min1)
        c2v = alpha * row_sign * sgn * ext_min * mask
        # ---- variable node update (columns)
        total = lam_e + jnp.sum(c2v, axis=-2, keepdims=True)  # [..., 1, n]
        v2c_next = (total - c2v) * mask
        return v2c_next, None

    v2c, _ = jax.lax.scan(bp_iter, v2c0, None, length=int(iters))
    # final posterior from the last check update
    mag = jnp.where(mask == 1, jnp.abs(v2c), big)
    sgn = jnp.where(v2c >= 0, 1.0, -1.0)
    sgn = jnp.where(mask == 1, sgn, 1.0)
    row_sign = jnp.prod(sgn, axis=-1, keepdims=True)
    min1 = jnp.min(mag, axis=-1, keepdims=True)
    arg1 = jnp.argmin(mag, axis=-1)
    onehot = jax.nn.one_hot(arg1, n, dtype=jnp.float32)
    min2 = jnp.min(jnp.where(onehot == 1, big, mag), axis=-1, keepdims=True)
    c2v = alpha * row_sign * sgn * jnp.where(onehot == 1, min2, min1) * mask
    post = lam + jnp.sum(c2v, axis=-2)  # [..., n]
    hard = (post < 0).astype(jnp.uint8)
    syn = jnp.mod(hard.astype(jnp.float32) @ jnp.asarray(hm.T), 2.0)
    ok = jnp.all(syn == 0, axis=-1)
    return hard, ok


def extract_info(codeword_bits, info_indices) -> jnp.ndarray:
    """Pull the ``k`` message bits back out of decoded codewords
    (``info_indices`` from :func:`make_regular_ldpc`). One static
    gather on the last axis."""
    idx = jnp.asarray(np.asarray(info_indices, np.int32))
    return jnp.take(jnp.asarray(codeword_bits), idx, axis=-1)
