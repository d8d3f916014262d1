"""Binary BCH codes — every decoder step as GF(2) linear algebra.

The classical random-error bit-level block code (satellite TC/TM
uplinks, flash/ECC, DVB-S2 outer code, the (63,51)/(15,11) short codes
of control channels) — completing the classical FEC family alongside
:mod:`.fec` (convolutional/Viterbi), :mod:`.rs` (symbol/burst errors),
:mod:`.ldpc` / :mod:`.nr_ldpc` (modern random-error), :mod:`.turbo` and
:mod:`.polar`. The reference has no channel coding
(`/root/reference/src/lib.rs` scope ends at modulation); this extends
the capability surface the same way those modules did.

BCH is Reed–Solomon's binary little sibling: codeword symbols are BITS,
the syndromes/locator algebra lives in GF(2^m), and the error magnitude
is always 1 — so the whole Forney stage of :mod:`.rs` disappears
(a located error is just a bit flip). The design follows
``rs.py``'s no-lookup-table rule, parametric in the field degree m:

- *encoding* (systematic cyclic: ``m(x)·x^{n-k} mod g(x)``) is ONE
  ``[k, n-k]`` binary matmul mod 2 — the generator polynomial is
  derived at construction from the cyclotomic cosets of
  ``α, α^3, …, α^{2t-1}`` (product of distinct minimal polynomials),
  in exact host integer arithmetic;
- *syndromes* ``S_i = r(α^i), i = 1..2t`` are one ``[n, 2t·m]`` matmul
  mod 2 (each received BIT contributes the bit-plane vector of
  ``α^{i·d}`` at its degree d);
- *Berlekamp–Massey* runs inversionless (Burton) for exactly ``2t``
  iterations as a ``lax.scan`` over ``[t+1, m]`` bit-plane locator
  state — static shapes, conditional updates as ``jnp.where``, the
  variable×variable GF products via the precomputed ``[m, m, m]``
  bilinear tensor (``c_j = Σ_{i,k} a_i M[i,j,k] b_k``);
- *Chien search* evaluates Λ at all n inverse locators with one
  ``[(t+1)·m, n·m]`` matmul mod 2; a zero evaluation IS the
  correction (XOR the bit) — no Forney, no field inversion anywhere
  in the binary decode path.

Decode failure is detected exactly (root count vs locator degree, BM
register length ≤ t, plus a re-syndrome check — one more matmul), so
``ok`` means "the output IS a codeword", the strongest claim a
bounded-distance decoder can make. Everything batches over leading
axes and jits to a handful of f32 matmuls plus one tiny scan — the
matrix-unit shape, not the bit-twiddling shift-register shape CPU BCH
uses.

Shortened codes come free exactly as in :mod:`.rs`: ``n`` below
``2^m - 1`` is the virtual-full-length code with leading zeros, and
because every matrix is built only over the n real positions, the
zeros never materialize.

Field polynomials are validated for primitivity at construction (all
``2^m - 1`` powers of α distinct), so a wrong table entry fails loudly
instead of mis-decoding. Bit order: index 0 = highest-degree
coefficient = transmitted first, systematic ``[message | parity]`` —
the same convention as :class:`~.rs.ReedSolomon`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BCH", "PRIMITIVE_POLYS", "bch_15_7", "bch_63_45", "bch_255_t"]


# Conway-style default primitive polynomials per field degree m.
# Primitivity is CHECKED in _field_tables (order of alpha == 2^m - 1),
# so these are conveniences, not trusted constants.
PRIMITIVE_POLYS: Dict[int, int] = {
    2: 0x7,      # x^2 + x + 1
    3: 0xB,      # x^3 + x + 1
    4: 0x13,     # x^4 + x + 1
    5: 0x25,     # x^5 + x^2 + 1
    6: 0x43,     # x^6 + x + 1
    7: 0x89,     # x^7 + x^3 + 1
    8: 0x11D,    # x^8 + x^4 + x^3 + x^2 + 1 (same field as ops.rs)
    9: 0x211,    # x^9 + x^4 + 1
    10: 0x409,   # x^10 + x^3 + 1
    11: 0x805,   # x^11 + x^2 + 1
    12: 0x1053,  # x^12 + x^6 + x^4 + x + 1
}


# ---------------------------------------------------------------- host field math


def _field_tables(m: int, poly: int) -> Tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^m); raises if ``poly`` is not primitive."""
    q = (1 << m) - 1
    exp = np.zeros(2 * q, np.int64)
    log = np.full(1 << m, -1, np.int64)
    v = 1
    for i in range(q):
        if log[v] >= 0:
            raise ValueError(
                f"0x{poly:X} is not primitive over GF(2^{m}): "
                f"alpha^{i} repeats alpha^{log[v]}"
            )
        exp[i] = v
        log[v] = i
        v <<= 1
        if v >> m:
            v ^= poly
    if v != 1:
        raise ValueError(f"0x{poly:X} does not generate GF(2^{m})")
    exp[q:] = exp[:q]
    return exp, log


def _mul_matrix(c: int, m: int, poly: int) -> np.ndarray:
    """m x m GF(2) matrix of multiplication by the constant ``c``:
    column i = bits of ``c * x^i`` (LSB-first rows)."""
    out = np.zeros((m, m), np.uint8)
    for i in range(m):
        v = c
        for _ in range(i):
            v <<= 1
            if v >> m:
                v ^= poly
        for j in range(m):
            out[j, i] = (v >> j) & 1
    return out


def _cyclotomic_coset(i: int, q: int) -> Tuple[int, ...]:
    """{i·2^j mod q} — the conjugacy class of alpha^i, canonical order."""
    out, s = [], i % q
    while s not in out:
        out.append(s)
        s = (2 * s) % q
    return tuple(sorted(out))


def _minimal_poly(coset, exp, log, m, poly) -> int:
    """Minimal polynomial of alpha^i over GF(2) as an int bitmask
    (bit d = coefficient of x^d): prod_{s in coset} (x - alpha^s),
    verified to land in GF(2)."""
    q = (1 << m) - 1
    # coefficients over GF(2^m), lowest-degree-first
    coeffs = [1]
    for s in coset:
        root = int(exp[s % q])
        new = [0] * (len(coeffs) + 1)
        for d, c in enumerate(coeffs):
            new[d + 1] ^= c  # c * x
            if c and root:
                new[d] ^= int(exp[(log[c] + log[root]) % q])
        coeffs = new
    mask = 0
    for d, c in enumerate(coeffs):
        if c not in (0, 1):
            raise AssertionError(
                f"minimal polynomial coefficient {c} not in GF(2) — "
                "field table bug"
            )
        mask |= c << d
    return mask


def _gf2_poly_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        b >>= 1
    return out


def _gf2_poly_mod(a: int, b: int) -> int:
    db = b.bit_length() - 1
    while a.bit_length() - 1 >= db and a:
        a ^= b << (a.bit_length() - 1 - db)
    return a


def _gf2_rank(a: np.ndarray) -> int:
    """Rank of a 0/1 matrix over GF(2) (host, exact)."""
    a = a.copy() % 2
    rank = 0
    rows, cols = a.shape
    for c in range(cols):
        piv = None
        for r in range(rank, rows):
            if a[r, c]:
                piv = r
                break
        if piv is None:
            continue
        a[[rank, piv]] = a[[piv, rank]]
        for r in range(rows):
            if r != rank and a[r, c]:
                a[r] = (a[r] + a[rank]) % 2
        rank += 1
    return rank


def _gf2_left_inverse(c: np.ndarray) -> np.ndarray:
    """For full-column-rank ``c [m, r]`` over GF(2), a ``[r, m]`` matrix
    P with ``P c = I_r`` (host Gaussian elimination on [c | I])."""
    m, r = c.shape
    aug = np.concatenate([c.copy() % 2, np.eye(m, dtype=np.int64)], axis=1)
    row = 0
    for col in range(r):
        piv = None
        for rr in range(row, m):
            if aug[rr, col]:
                piv = rr
                break
        if piv is None:
            raise AssertionError("column-rank deficiency in GF(2) inverse")
        aug[[row, piv]] = aug[[piv, row]]
        for rr in range(m):
            if rr != row and aug[rr, col]:
                aug[rr] = (aug[rr] + aug[row]) % 2
        row += 1
    # after reduction the first r rows have C-part I_r; their E-part is P
    assert np.array_equal(aug[:r, :r] % 2, np.eye(r, dtype=np.int64))
    return aug[:r, c.shape[1]:] % 2


class BCH:
    """Narrow-sense binary BCH over GF(2^m): ``t`` correctable bit errors.

    Parameters
    ----------
    n : code length in bits. ``m`` is inferred as the smallest field
        degree with ``2^m - 1 >= n``; ``n < 2^m - 1`` is the shortened
        code (virtual leading zeros, never materialized).
    t : designed error-correction capability. The message length ``k``
        falls out of the generator-polynomial degree
        (``k = n - deg g``); the true minimum distance is >= 2t+1.
    m, primitive_poly : override the inferred field / default
        polynomial (validated for primitivity either way).

    All matrices are precomputed host-side in exact integer arithmetic;
    :meth:`encode` / :meth:`decode` are pure jittable functions of
    their inputs, batched over arbitrary leading axes.
    """

    def __init__(self, n: int, t: int, m: int | None = None,
                 primitive_poly: int | None = None):
        n, t = int(n), int(t)
        if m is None:
            m = max(2, n.bit_length())  # smallest m with 2^m - 1 >= n
        if not (3 <= n <= (1 << m) - 1):
            raise ValueError(f"need 3 <= n <= 2^{m}-1 = {(1 << m) - 1}, got n={n}")
        if primitive_poly is None:
            if m not in PRIMITIVE_POLYS:
                raise ValueError(
                    f"no built-in primitive polynomial for GF(2^{m}) "
                    f"(n={n} needs m={m}; built-ins cover m in "
                    f"{sorted(PRIMITIVE_POLYS)}) — pass primitive_poly="
                )
            poly = PRIMITIVE_POLYS[m]
        else:
            poly = int(primitive_poly)
        exp, log = _field_tables(m, poly)
        q = (1 << m) - 1
        self.n, self.t, self.m = n, t, m
        self.primitive_poly = poly
        self._exp, self._log = exp, log

        # generator = product of distinct minimal polys of alpha^1..alpha^2t
        seen, g = set(), 1
        for i in range(1, 2 * t + 1):
            coset = _cyclotomic_coset(i, q)
            if coset in seen:
                continue
            seen.add(coset)
            g = _gf2_poly_mul(g, _minimal_poly(coset, exp, log, m, poly))
        self.generator = g  # int bitmask, bit d = coeff of x^d
        nsym = g.bit_length() - 1
        if nsym >= n:
            raise ValueError(
                f"t={t} needs {nsym} parity bits but n={n}; no message room"
            )
        self.nsym = nsym
        self.k = n - nsym

        # ---- encoder matrix: parity = msg_bits @ A (mod 2) ----------------
        # msg bit j sits at degree n-1-j; row j = bits of x^{n-1-j} mod g,
        # highest-degree-first across the nsym parity positions.
        a = np.zeros((self.k, nsym), np.float32)
        r = _gf2_poly_mod(1 << nsym, g)  # x^nsym mod g
        for deg in range(nsym, n):       # deg = nsym + mth step
            j = n - 1 - deg              # message bit index with that degree
            a[j] = [(r >> (nsym - 1 - s)) & 1 for s in range(nsym)]
            r = _gf2_poly_mod(r << 1, g)
        self._enc = a

        # ---- syndrome matrix: synd_bits = cw_bits @ B (mod 2) -------------
        # S_i = sum_j r_j alpha^{i (n-1-j)}, i = 1..2t
        b = np.zeros((n, 2 * t * m), np.float32)
        for j in range(n):
            d = n - 1 - j
            for i in range(1, 2 * t + 1):
                v = int(exp[(i * d) % q])
                b[j, (i - 1) * m: i * m] = [(v >> bit) & 1 for bit in range(m)]
        self._synd = b

        # ---- bilinear GF(2^m) multiply tensor ------------------------------
        x_comp = _mul_matrix(2, m, poly)
        mt = np.zeros((m, m, m), np.uint8)
        p = np.eye(m, dtype=np.uint8)
        for i in range(m):
            mt[i] = p
            p = (x_comp @ p) % 2
        self._mul3 = mt.astype(np.float32)

        # ---- Chien evaluation matrix ---------------------------------------
        # position j (degree d = n-1-j): val_j = sum_l Lam_l alpha^{-d l};
        # block (l, j) = transpose mul-matrix of alpha^{(-d l) mod q}.
        el = np.zeros(((t + 1) * m, n * m), np.uint8)
        for j in range(n):
            inv = (-(n - 1 - j)) % q
            for l in range(t + 1):
                c = int(exp[(inv * l) % q])
                el[l * m: (l + 1) * m, j * m: (j + 1) * m] = _mul_matrix(
                    c, m, poly
                ).T
        self._ev_lam = el.astype(np.float32)

        # ---- closed-form decode tables (t <= 2): no BM scan, no Chien ------
        # t=1: the S1 syndrome IS the locator (match it against the n
        # position vectors — the TPC SISO trick, 25x there). t=2: the
        # locator pair solves x^2 + S1 x + (S3 + S1^3)/S1 = 0, which the
        # substitution x = S1 y turns into y^2 + y = c with
        # c = (S3 + S1^3) / S1^3 — and y -> y^2 + y is GF(2)-LINEAR, so
        # the quadratic solver is ONE precomputed matmul (the half-trace
        # map), gated by the trace solvability bit. Everything stays
        # matmuls + the tiny bilinear einsum.
        if t <= 2:
            pos = np.zeros((n, m), np.float32)
            for j in range(n):
                v = int(exp[(n - 1 - j) % q])
                pos[j] = [(v >> bit) & 1 for bit in range(m)]
            # GF(2) distance match via one matmul: dist(x, pos_j) =
            # x . (1 - 2 pos_j) + sum(pos_j); == 0 iff x == pos_j
            self._loc_w = (1.0 - 2.0 * pos.T).astype(np.float32)  # [m, n]
            self._loc_b = pos.sum(axis=1).astype(np.float32)      # [n]
            sq = np.zeros((m, m), np.uint8)
            for i2 in range(m):
                v = int(exp[(2 * i2) % q])
                sq[:, i2] = [(v >> bit) & 1 for bit in range(m)]
            self._sqm = sq.astype(np.float32)
            if t == 2:
                # trace functional: Tr(c) = tvec . c (bit 0 of sum SQ^i c)
                tmat = np.zeros((m, m), np.int64)
                p2 = np.eye(m, dtype=np.int64)
                for _ in range(m):
                    tmat = (tmat + p2) % 2
                    p2 = (sq.astype(np.int64) @ p2) % 2
                self._trv = tmat[0].astype(np.float32)  # [m]
                # half-trace-style solver H with (SQ+I) H c = c on the
                # image of y -> y^2 + y: columns of L = SQ + I span the
                # image with known preimages (the basis vectors); pick an
                # independent subset C (rank m-1), left-invert over GF(2),
                # H = Y P. For Tr(c) = 0, y0 = H c solves y^2 + y = c.
                lmap = (sq.astype(np.int64) + np.eye(m, dtype=np.int64)) % 2
                cols, pre = [], []
                rank_rows = np.zeros((0, m), np.int64)
                for b2 in range(m):
                    cand = np.vstack([rank_rows, lmap[:, b2][None]])
                    if _gf2_rank(cand) > rank_rows.shape[0]:
                        rank_rows = cand
                        cols.append(lmap[:, b2])
                        pre.append(np.eye(m, dtype=np.int64)[b2])
                cmat = np.stack(cols, axis=1)   # [m, m-1]
                ymat = np.stack(pre, axis=1)    # [m, m-1]
                pmat = _gf2_left_inverse(cmat)  # [m-1, m]
                self._ht = ((ymat @ pmat) % 2).astype(np.float32)  # [m, m]

    # ------------------------------------------------------------------ encode

    def encode(self, msg) -> jnp.ndarray:
        """Systematic encode: bits ``[..., k]`` -> bits ``[..., n]``
        (= ``[message | parity]``). One f32 matmul mod 2."""
        msg = jnp.asarray(msg)
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} message bits, got {msg.shape[-1]}")
        mb = msg.astype(jnp.float32)
        par = jnp.mod(mb @ jnp.asarray(self._enc), 2.0)
        return jnp.concatenate([mb, par], axis=-1).astype(jnp.uint8)

    # ------------------------------------------------------------------ decode

    def decode(self, rx) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Correct up to ``t`` bit errors in hard bits ``[..., n]``.

        Returns ``(msg, ok, n_errors)``: decoded bits ``[..., k]``
        (uint8), a bool (the corrected word re-syndromes to zero AND
        the error locator's root count matches its degree AND the BM
        register length is <= t — i.e. the output is a codeword), and
        the number of corrected bit errors (int32, -1 where not ok).
        Batched over leading axes.
        """
        rx = jnp.asarray(rx)
        if rx.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} received bits, got {rx.shape[-1]}")
        lead = rx.shape[:-1]
        corr, ok, nerr = self._decode_full(rx.astype(jnp.float32).reshape((-1, self.n)))
        msg = corr[..., : self.k].astype(jnp.uint8).reshape(lead + (self.k,))
        return msg, ok.reshape(lead), nerr.reshape(lead)

    def _decode_full(self, rbits: jnp.ndarray):
        """Core decode on f32 bit rows ``[B, n]`` -> (corrected ``[B, n]``
        f32, ok ``[B]``, n_errors ``[B]``). t <= 2 dispatches to the
        scan-free closed form (bit-identical for correctable words; the
        exact ``ok`` re-syndrome semantics hold on both paths)."""
        if self.t <= 2:
            return self._decode_closed(rbits)
        return self._decode_bm(rbits)

    def _decode_bm(self, rbits: jnp.ndarray):
        """The general BM+Chien pipeline regardless of t (kept callable
        for the closed-form equivalence regression tests)."""
        synd = jnp.mod(rbits @ jnp.asarray(self._synd), 2.0)
        synd = synd.reshape((-1, 2 * self.t, self.m))
        lam, ell = jax.vmap(self._berlekamp_massey)(synd)
        return jax.vmap(self._chien_flip)(lam, ell, rbits)

    # ------------------------------------------------------ closed-form t<=2

    def _gmul(self, a, b):
        """Element-wise GF(2^m) product on bit-plane rows [..., m]."""
        return jnp.mod(
            jnp.einsum("...i,ijk,...k->...j", a, jnp.asarray(self._mul3), b),
            2.0,
        )

    def _gsq(self, a):
        return jnp.mod(a @ jnp.asarray(self._sqm).T, 2.0)

    def _ginv(self, a):
        """Fermat inverse a^(2^m - 2); 0 -> 0 (masked by callers)."""
        p = self._gsq(a)
        acc = p
        for _ in range(self.m - 2):
            p = self._gsq(p)
            acc = self._gmul(acc, p)
        return acc

    def _loc_match(self, x):
        """Locator bits [B, m] -> one-hot [B, n] over code positions
        (all-zero row when the locator is outside the code — shortened
        virtual positions land here and fail the re-syndrome check)."""
        dist = x @ jnp.asarray(self._loc_w) + jnp.asarray(self._loc_b)
        return (dist == 0.0).astype(jnp.float32)

    def _decode_closed(self, rbits: jnp.ndarray):
        """Scan-free decode for t <= 2 (see __init__ notes): syndromes,
        locators, and the quadratic solver are all matmuls."""
        m = self.m
        synd = jnp.mod(rbits @ jnp.asarray(self._synd), 2.0)
        s1 = synd[:, :m]
        s1z = jnp.all(s1 == 0.0, axis=-1, keepdims=True)
        if self.t == 1:
            flips = self._loc_match(s1) * (1.0 - s1z)
        else:
            s3 = synd[:, 2 * m: 3 * m]
            s1cu = self._gmul(self._gsq(s1), s1)  # S1^3
            delta = jnp.mod(s3 + s1cu, 2.0)
            dz = jnp.all(delta == 0.0, axis=-1, keepdims=True)
            # c = (S3 + S1^3) / S1^3; y^2 + y = c; x = S1 y
            c = self._gmul(delta, self._ginv(s1cu))
            solvable = (
                jnp.mod(c @ jnp.asarray(self._trv), 2.0) == 0.0
            )[:, None]
            y0 = jnp.mod(c @ jnp.asarray(self._ht).T, 2.0)
            x1 = self._gmul(s1, y0)
            x2 = jnp.mod(x1 + s1, 2.0)
            single = (1.0 - s1z) * dz
            double = (1.0 - s1z) * (1.0 - dz) * solvable
            flips = (
                single * self._loc_match(s1)
                + double
                * jnp.mod(self._loc_match(x1) + self._loc_match(x2), 2.0)
            )
        corrected = jnp.mod(rbits + flips, 2.0)
        resyn = jnp.mod(corrected @ jnp.asarray(self._synd), 2.0)
        ok = jnp.all(resyn == 0.0, axis=-1)
        nerr = jnp.sum(flips, axis=-1).astype(jnp.int32)
        return corrected, ok, jnp.where(ok, nerr, jnp.int32(-1))

    def _berlekamp_massey(self, synd: jnp.ndarray):
        """Inversionless BM over one codeword's syndromes ``[2t, m]`` ->
        (error locator ``[t+1, m]`` bit planes, register length L)."""
        tt, m = self.t, self.m
        nsyn = 2 * tt
        # windows[r, i] = S_{r-i} for i = 0..t (zeros for r-i < 0)
        pad = jnp.concatenate([jnp.zeros((tt, m), jnp.float32), synd], axis=0)
        windows = jnp.stack(
            [pad[r: r + tt + 1][::-1] for r in range(nsyn)], axis=0
        )  # [2t, t+1, m]
        m3 = jnp.asarray(self._mul3)

        one = jnp.zeros((tt + 1, m), jnp.float32).at[0, 0].set(1.0)
        e_one = jnp.zeros(m, jnp.float32).at[0].set(1.0)

        def const_times(c, p):  # c [m] x polynomial [t+1, m]
            return jnp.mod(jnp.einsum("i,ijk,tk->tj", c, m3, p), 2.0)

        def step(carry, wr):
            lam, bpoly, bdisc, ell, r = carry
            delta = jnp.mod(jnp.einsum("ti,ijk,tk->j", lam, m3, wr), 2.0)
            nz = jnp.any(delta > 0)
            xb = jnp.concatenate([jnp.zeros((1, m), jnp.float32), bpoly[:-1]], axis=0)
            lam_n = jnp.mod(const_times(bdisc, lam) + const_times(delta, xb), 2.0)
            upd = nz & (2 * ell <= r)
            bpoly_n = jnp.where(upd, lam, xb)
            bdisc_n = jnp.where(upd, delta, bdisc)
            ell_n = jnp.where(upd, r + 1 - ell, ell)
            return (lam_n, bpoly_n, bdisc_n, ell_n, r + 1), None

        carry0 = (one, one, e_one, jnp.int32(0), jnp.int32(0))
        (lam, _, _, ell, _), _ = jax.lax.scan(step, carry0, windows)
        return lam, ell

    def _chien_flip(self, lam, ell, rbits):
        """Chien search + binary correction for one codeword: flip every
        bit whose inverse locator is a root of Lam."""
        tt, n, m = self.t, self.n, self.m
        val = jnp.mod(
            lam.reshape((tt + 1) * m) @ jnp.asarray(self._ev_lam), 2.0
        ).reshape(n, m)
        is_root = jnp.all(val == 0.0, axis=-1)  # [n]
        corrected = jnp.mod(rbits + is_root.astype(jnp.float32), 2.0)

        n_roots = jnp.sum(is_root.astype(jnp.int32))
        nz = jnp.any(lam > 0, axis=-1)
        deg = jnp.max(jnp.where(nz, jnp.arange(tt + 1), -1))
        resyn = jnp.mod(corrected @ jnp.asarray(self._synd), 2.0)
        ok = (n_roots == deg) & (ell <= tt) & jnp.all(resyn == 0.0)
        return corrected, ok, jnp.where(ok, n_roots, jnp.int32(-1))


    # ------------------------------------------------------------- soft decode

    def decode_soft(self, llr, p: int = 4):
        """Chase-2 soft-decision decode of channel LLRs ``[..., n]``
        (positive = bit 0, the framework's convention).

        Flips every subset of the ``p`` least-reliable bit positions
        (``2^p`` test patterns), hard-decodes ALL patterns as one
        batched :meth:`decode` call — the serial CPU Chase loop becomes
        a single wider matmul batch, which is exactly what this
        backend's decoder shape wants — and returns the candidate
        codeword with the smallest analog distance
        ``Σ |llr|·[codeword ≠ hard decision]`` among those that decoded
        to a genuine codeword. Buys the classic ~1.5-2 dB of soft gain
        over hard BCH decoding at ``2^p`` times the (cheap, batched)
        hard-decode work; falls back to the no-flip hard decode when no
        pattern lands on a codeword (``ok`` False).

        Returns ``(msg [..., k] uint8, ok [...] bool)``; batched over
        leading axes.
        """
        p = int(p)
        llr = jnp.asarray(llr, jnp.float32)
        if llr.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llr.shape[-1]}")
        lead = llr.shape[:-1]
        flat = llr.reshape((-1, self.n))
        hard = (flat < 0).astype(jnp.float32)
        rel = jnp.abs(flat)
        _, idx = jax.lax.top_k(-rel, p)  # p least reliable positions [B, p]
        combos = ((np.arange(1 << p)[:, None] >> np.arange(p)) & 1).astype(
            np.float32
        )  # [2^p, p]; row 0 = no flips (the fallback candidate)
        onehot = jax.nn.one_hot(idx, self.n, dtype=jnp.float32)  # [B, p, n]
        flips = jnp.einsum("cp,bpn->bcn", jnp.asarray(combos), onehot)
        trial = jnp.mod(hard[:, None, :] + flips, 2.0)  # [B, 2^p, n]
        corr, ok, _ = self._decode_full(trial.reshape((-1, self.n)))
        corr = corr.reshape((-1, 1 << p, self.n))
        ok = ok.reshape((-1, 1 << p))
        diff = jnp.mod(corr + hard[:, None, :], 2.0)
        metric = jnp.sum(diff * rel[:, None, :], axis=-1)  # [B, 2^p]
        metric = jnp.where(ok, metric, jnp.inf)
        best = jnp.argmin(metric, axis=-1)  # all-inf -> 0 = no-flip trial
        chosen = jnp.take_along_axis(corr, best[:, None, None], axis=1)[:, 0]
        msg = chosen[..., : self.k].astype(jnp.uint8).reshape(lead + (self.k,))
        return msg, jnp.any(ok, axis=-1).reshape(lead)


# -------------------------------------------------------------- constructions


def bch_15_7() -> BCH:
    """The textbook double-error-correcting BCH(15, 7, t=2)."""
    return BCH(15, 2)


def bch_63_45() -> BCH:
    """BCH(63, 45, t=3) — the classic telecommand-class short code."""
    return BCH(63, 3)


def bch_255_t(t: int) -> BCH:
    """Full-length m=8 code (same field as :mod:`.rs`) at capability t."""
    return BCH(255, t, m=8)
