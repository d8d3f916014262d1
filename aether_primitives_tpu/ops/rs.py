"""Reed–Solomon codes over GF(2^8) — every field operation as GF(2) linear algebra.

The classic symbol-level block code (CCSDS/DVB RS(255,223), storage, FEC
for bursty channels) — the burst-error complement to :mod:`.fec`'s
convolutional/Viterbi pair and :mod:`.ldpc`'s random-error codes (the
reference has no channel coding; this extends the capability surface the
same way those modules did).

CPU/ASIC Reed–Solomon lives on 256-entry log/antilog table lookups —
gathers, which break XLA's fusion on accelerators. This design
eliminates every table:

- A GF(2^8) element is its 8 polynomial coefficients — one bit-plane
  vector. **Multiplication by a constant is GF(2)-linear**, so every
  fixed-operand product in the codec becomes a precomputed binary matrix:

  - *encoding* (message -> parity, i.e. ``m(x)·x^{n-k} mod g(x)``) is ONE
    ``[k·8, (n-k)·8]`` f32 matmul mod 2 — the same companion-matrix trick
    as :func:`~.fec._crc_matrices` / :func:`~.sequence.lfsr_matrix_generate`;
  - *syndromes* (evaluations at ``α^{fcr+i}``) are one ``[n·8, (n-k)·8]``
    matmul mod 2;
  - *Chien search + Forney evaluations* (Λ, Ω, Λ' at all n inverse
    locators, with the ``X^{1-fcr}`` Forney factor folded in) are three
    small matmuls against host-precomputed evaluation matrices.

- **Variable × variable products** (Berlekamp–Massey discrepancies, the
  Forney quotient) use the bilinear form ``c_j = Σ_i a_i (X^i b)_j`` with
  ``X`` the 8×8 companion matrix of the field polynomial — one tiny
  einsum over a precomputed ``[8, 8, 8]`` tensor, no lookups.
- **Inversion** is Fermat: ``a^{-1} = a^254 = a^2·a^4·…·a^128`` — seven
  squarings (squaring is linear: one 8×8 matrix) and six products,
  batched over all n positions at once. ``0^{-1} = 0`` falls out, which
  Forney masks anyway.
- **Berlekamp–Massey** runs inversionless (Burton) for exactly ``n-k``
  iterations as a ``lax.scan`` — static shapes, no data-dependent control
  flow; the conditional update is a ``jnp.where``. Scaling Λ by the last
  discrepancy leaves its roots (and the Forney ratio) unchanged.

Everything batches over leading axes; decode failure is detected exactly
(root count vs locator degree, plus a re-syndrome check — one more
matmul), so ``ok`` is "the output IS a codeword", the strongest claim a
bounded-distance decoder can make.

Shortened codes come free: ``n < 255`` is the virtual-length-255 code
with leading zeros, and because every matrix is built only over the n
real positions, the zeros never materialize.

Symbols are uint8 at the API boundary (index 0 = highest-degree
coefficient = transmitted first, systematic ``[message | parity]``);
:func:`bits_to_symbols` / :func:`symbols_to_bits` bridge to the
framework's LSB-first bit streams.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ReedSolomon",
    "rs_255_223",
    "symbols_to_bits",
    "bits_to_symbols",
]


# ---------------------------------------------------------------- host field math


def _field_tables(primitive_poly: int) -> Tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^8) host-side precompute (never on device)."""
    exp = np.zeros(510, np.int64)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= primitive_poly
    exp[255:510] = exp[:255]
    return exp, log


def _mul_matrix(c: int, primitive_poly: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication by the constant ``c``:
    column i = bits of ``c * x^i``."""
    m = np.zeros((8, 8), np.uint8)
    for i in range(8):
        v = c
        for _ in range(i):  # multiply by x, reduce
            v <<= 1
            if v & 0x100:
                v ^= primitive_poly
        for j in range(8):
            m[j, i] = (v >> j) & 1
    return m


def _gf_mul_int(a: int, b: int, exp: np.ndarray, log: np.ndarray) -> int:
    if a == 0 or b == 0:
        return 0
    return int(exp[log[a] + log[b]])


def _poly_mod(num: list, den: list, exp, log) -> list:
    """Remainder of polynomial division over GF(2^8); coefficient lists are
    highest-degree-first, ``den`` monic."""
    out = list(num)
    for i in range(len(num) - len(den) + 1):
        c = out[i]
        if c:
            for j in range(1, len(den)):
                out[i + j] ^= _gf_mul_int(c, den[j], exp, log)
    return out[-(len(den) - 1):]


class ReedSolomon:
    """RS(n, k) over GF(2^8): ``t = (n-k)//2`` correctable symbol errors.

    Parameters
    ----------
    n, k : code length / message length in symbols, ``k < n <= 255``.
    fcr : first consecutive root exponent (1 for CCSDS-style, 0 for some
        standards); generator ``g(x) = Π_{i} (x - α^{fcr+i})``.
    primitive_poly : field polynomial (default ``0x11D``, the usual
        ``x^8+x^4+x^3+x^2+1``).

    All matrices are precomputed host-side in ``__init__`` (exact integer
    arithmetic); :meth:`encode`/:meth:`decode` are pure jittable functions
    of their inputs, batched over arbitrary leading axes.
    """

    def __init__(self, n: int, k: int, fcr: int = 1, primitive_poly: int = 0x11D):
        n, k = int(n), int(k)
        if not (0 < k < n <= 255):
            raise ValueError(f"need 0 < k < n <= 255, got n={n} k={k}")
        self.n, self.k, self.fcr = n, k, int(fcr)
        self.nsym = n - k
        self.t = self.nsym // 2
        self.primitive_poly = int(primitive_poly)
        exp, log = _field_tables(self.primitive_poly)
        self._exp, self._log = exp, log

        # generator polynomial g(x) = prod (x - alpha^(fcr+i)), monic,
        # highest-degree-first (-root == root in char 2)
        g = [1]
        for i in range(self.nsym):
            root = int(exp[(self.fcr + i) % 255])
            # (g(x)) * (x + root), coefficients highest-degree-first
            new = [0] * (len(g) + 1)
            for d, c in enumerate(g):
                new[d] ^= c  # c * x
                new[d + 1] ^= _gf_mul_int(c, root, exp, log)
            g = new
        self.generator = np.array(g, np.int64)  # degree nsym, monic

        bits8 = np.arange(8)

        def elem_bits(v: int) -> np.ndarray:
            return ((v >> bits8) & 1).astype(np.uint8)

        # ---- encoder matrix: parity_bits = msg_bits @ A  (mod 2) ----------
        # msg symbol j sits at degree nsym + (k-1-j); its remainder basis
        # r_m(x) = x^(nsym+m) mod g for m = k-1-j. Column block for (j, bit
        # b) = bits of alpha^b * r_{k-1-j}, a length-nsym symbol vector.
        rems = []  # rems[m] = x^(nsym+m) mod g, list of nsym ints (high-first)
        r = _poly_mod([1] + [0] * self.nsym, list(self.generator), exp, log)
        rems.append(list(r))
        for _ in range(1, k):
            r = _poly_mod(list(r) + [0], list(self.generator), exp, log)
            rems.append(list(r))
        a = np.zeros((k * 8, self.nsym * 8), np.uint8)
        for j in range(k):
            rm = rems[k - 1 - j]
            for b in range(8):
                ab = 1 << b  # the basis element x^b (< 256, no reduction)
                for s in range(self.nsym):
                    prod = _gf_mul_int(ab, rm[s], exp, log)
                    a[j * 8 + b, s * 8: s * 8 + 8] = elem_bits(prod)
        self._enc = a.astype(np.float32)

        # ---- syndrome matrix: synd_bits = cw_bits @ B  (mod 2) ------------
        # S_i = sum_j c_j * alpha^{(fcr+i)(n-1-j)}
        b = np.zeros((n * 8, self.nsym * 8), np.uint8)
        for j in range(n):
            d = n - 1 - j
            for i in range(self.nsym):
                c = int(exp[((self.fcr + i) * d) % 255])
                # block (row = input bit, col = output bit) = transpose of
                # _mul_matrix's (out_bit, in_bit) layout
                b[j * 8: j * 8 + 8, i * 8: i * 8 + 8] = _mul_matrix(
                    c, self.primitive_poly
                ).T
        self._synd = b.astype(np.float32)

        # ---- bilinear GF multiply tensor & squaring matrix ----------------
        x_comp = _mul_matrix(2, self.primitive_poly)  # multiplication by alpha=x
        mt = np.zeros((8, 8, 8), np.uint8)
        p = np.eye(8, dtype=np.uint8)
        for i in range(8):
            mt[i] = p
            p = (x_comp @ p) % 2
        self._mul3 = mt.astype(np.float32)  # c_j = sum_{i,k} a_i M[i,j,k] b_k
        sq = np.zeros((8, 8), np.uint8)
        for i in range(8):
            # column i = bits of (x^i)^2 = x^(2i), reduced when 2i >= 8
            v = 1 << (2 * i) if 2 * i < 8 else int(exp[(2 * log[1 << i]) % 255])
            sq[:, i] = elem_bits(v)
        self._sq = sq.astype(np.float32)

        # ---- Chien/Forney evaluation matrices ------------------------------
        # position j (degree d = n-1-j), locator X_j = alpha^d:
        #   valL_bits  = lam_bits  @ EL   with EL[(t+1)*8, n*8]
        #   valO_bits  = omg_bits  @ EO   with EO[nsym*8, n*8]  (X^{1-fcr} folded)
        #   valLd_bits = lam_bits  @ ELD  (formal derivative, odd coeffs)
        tt = self.t
        el = np.zeros(((tt + 1) * 8, n * 8), np.uint8)
        eld = np.zeros(((tt + 1) * 8, n * 8), np.uint8)
        eo = np.zeros((self.nsym * 8, n * 8), np.uint8)
        for j in range(n):
            d = n - 1 - j
            inv = (-d) % 255  # alpha^{-d} exponent
            for l in range(tt + 1):
                c = int(exp[(inv * l) % 255])
                el[l * 8: l * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(
                    c, self.primitive_poly
                ).T
                if l % 2 == 1:  # derivative term Lam_l x^{l-1}
                    cd = int(exp[(inv * (l - 1)) % 255])
                    eld[l * 8: l * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(
                        cd, self.primitive_poly
                    ).T
            forney = int(exp[(d * (1 - self.fcr)) % 255])
            for i in range(self.nsym):
                c = _gf_mul_int(int(exp[(inv * i) % 255]), forney, exp, log)
                eo[i * 8: i * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(
                    c, self.primitive_poly
                ).T
        self._ev_lam = el.astype(np.float32)
        self._ev_lamd = eld.astype(np.float32)
        self._ev_omg = eo.astype(np.float32)

        # Omega = S(x) * Lam(x) mod x^nsym, as a one-hot contraction tensor:
        # C[j, i, l] = 1 iff i + l == j (i < nsym syndromes, l <= t)
        c3 = np.zeros((self.nsym, self.nsym, tt + 1), np.float32)
        for i in range(self.nsym):
            for l in range(tt + 1):
                if i + l < self.nsym:
                    c3[i + l, i, l] = 1.0
        self._conv = c3

    # ------------------------------------------------------------------ utils

    @staticmethod
    def _to_bits(sym: jnp.ndarray) -> jnp.ndarray:
        """uint8 symbols [..., m] -> bit planes [..., m, 8] (f32, LSB-first)."""
        s = jnp.asarray(sym).astype(jnp.int32)
        return ((s[..., None] >> jnp.arange(8)) & 1).astype(jnp.float32)

    @staticmethod
    def _to_syms(bits: jnp.ndarray) -> jnp.ndarray:
        """bit planes [..., m, 8] -> uint8 symbols [..., m]."""
        w = jnp.asarray(2 ** np.arange(8), jnp.int32)
        return jnp.sum(bits.astype(jnp.int32) * w, axis=-1).astype(jnp.uint8)

    def _gfmul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Element-wise GF(2^8) product of bit-plane tensors [..., 8]."""
        m = jnp.asarray(self._mul3)
        return jnp.mod(jnp.einsum("...i,ijk,...k->...j", a, m, b), 2.0)

    def _gfinv(self, a: jnp.ndarray) -> jnp.ndarray:
        """Batched Fermat inverse a^254 on bit planes [..., 8]; 0 -> 0."""
        sq = jnp.asarray(self._sq)

        def square(v):
            return jnp.mod(jnp.einsum("...k,jk->...j", v, sq), 2.0)

        p = square(a)  # a^2
        acc = p
        for _ in range(6):  # a^4 ... a^128
            p = square(p)
            acc = self._gfmul(acc, p)
        return acc

    # ------------------------------------------------------------------ encode

    def encode(self, msg) -> jnp.ndarray:
        """Systematic encode: uint8 ``[..., k]`` -> uint8 ``[..., n]``
        (= ``[message | parity]``). One f32 matmul mod 2."""
        msg = jnp.asarray(msg)
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} message symbols, got {msg.shape[-1]}")
        bits = self._to_bits(msg).reshape(msg.shape[:-1] + (self.k * 8,))
        par = jnp.mod(bits @ jnp.asarray(self._enc), 2.0)
        par_syms = self._to_syms(par.reshape(msg.shape[:-1] + (self.nsym, 8)))
        return jnp.concatenate([msg.astype(jnp.uint8), par_syms], axis=-1)

    # ------------------------------------------------------------------ decode

    def decode(self, rx) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Correct up to ``t`` symbol errors.

        Returns ``(msg, ok, n_errors)``: decoded uint8 ``[..., k]``, a bool
        (the corrected word re-syndromes to zero AND the error locator's
        root count matches its degree — i.e. the output is a codeword), and
        the number of corrected symbol errors (int32). Batched over leading
        axes.
        """
        rx = jnp.asarray(rx)
        if rx.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} received symbols, got {rx.shape[-1]}")
        lead = rx.shape[:-1]
        rbits = self._to_bits(rx).reshape(lead + (self.n * 8,))
        synd_m = jnp.asarray(self._synd)
        synd = jnp.mod(rbits @ synd_m, 2.0).reshape(lead + (self.nsym, 8))

        flat_syn = synd.reshape((-1, self.nsym, 8))
        flat_rb = rbits.reshape((-1, self.n * 8))
        lam, n_err = jax.vmap(self._berlekamp_massey)(flat_syn)
        corr, ok, nerr_out = jax.vmap(self._chien_forney)(flat_syn, lam, flat_rb, n_err)
        corr = corr.reshape(lead + (self.n, 8))
        msg = self._to_syms(corr[..., : self.k, :])
        return msg, ok.reshape(lead), nerr_out.reshape(lead)

    def _berlekamp_massey(self, synd: jnp.ndarray):
        """Inversionless BM over one codeword's syndromes ``[nsym, 8]`` ->
        error locator ``Lam [t+1, 8]`` (bit planes) and its register length
        L (int32, = number of errors when <= t)."""
        tt = self.t
        nsym = self.nsym
        # windows[r, i] = S_{r-i} for i = 0..t (zeros for r-i < 0)
        pad = jnp.concatenate([jnp.zeros((tt, 8), jnp.float32), synd], axis=0)
        windows = jnp.stack(
            [pad[r: r + tt + 1][::-1] for r in range(nsym)], axis=0
        )  # [nsym, t+1, 8]
        m3 = jnp.asarray(self._mul3)

        one = jnp.zeros((tt + 1, 8), jnp.float32).at[0, 0].set(1.0)
        e_one = jnp.zeros(8, jnp.float32).at[0].set(1.0)

        def const_times(c, poly):  # c [8] x poly [t+1, 8]
            return jnp.mod(jnp.einsum("i,ijk,tk->tj", c, m3, poly), 2.0)

        def step(carry, wr):
            lam, bpoly, bdisc, ell, r = carry
            # discrepancy: sum_i gfmul(Lam_i, S_{r-i})
            delta = jnp.mod(jnp.einsum("ti,ijk,tk->j", lam, m3, wr), 2.0)
            nz = jnp.any(delta > 0)
            xb = jnp.concatenate([jnp.zeros((1, 8), jnp.float32), bpoly[:-1]], axis=0)
            t_new = jnp.mod(const_times(bdisc, lam) + const_times(delta, xb), 2.0)
            upd = nz & (2 * ell <= r)
            bpoly_n = jnp.where(upd, lam, xb)
            bdisc_n = jnp.where(upd, delta, bdisc)
            ell_n = jnp.where(upd, r + 1 - ell, ell)
            return (t_new, bpoly_n, bdisc_n, ell_n, r + 1), None

        carry0 = (one, one, e_one, jnp.int32(0), jnp.int32(0))
        (lam, _, _, ell, _), _ = jax.lax.scan(step, carry0, windows)
        return lam, ell

    def _chien_forney(self, synd, lam, rbits, n_err):
        """Chien search + Forney correction for one codeword."""
        tt, nsym, n = self.t, self.nsym, self.n
        m3 = jnp.asarray(self._mul3)
        # Omega = S * Lam mod x^nsym
        prod = jnp.mod(jnp.einsum("ic,cjk,lk->ilj", synd, m3, lam), 2.0)
        omega = jnp.mod(jnp.einsum("jil,ilb->jb", jnp.asarray(self._conv), prod), 2.0)

        lam_flat = lam.reshape((tt + 1) * 8)
        omg_flat = omega.reshape(nsym * 8)
        val_lam = jnp.mod(lam_flat @ jnp.asarray(self._ev_lam), 2.0).reshape(n, 8)
        val_lamd = jnp.mod(lam_flat @ jnp.asarray(self._ev_lamd), 2.0).reshape(n, 8)
        val_omg = jnp.mod(omg_flat @ jnp.asarray(self._ev_omg), 2.0).reshape(n, 8)

        is_root = jnp.all(val_lam == 0.0, axis=-1)  # [n]
        e = self._gfmul(val_omg, self._gfinv(val_lamd))  # [n, 8]
        e = e * is_root[:, None]
        corrected = jnp.mod(rbits.reshape(n, 8) + e, 2.0)

        # exact failure detection
        n_roots = jnp.sum(is_root.astype(jnp.int32))
        nz = jnp.any(lam > 0, axis=-1)  # [t+1] nonzero coefficients
        deg = jnp.max(jnp.where(nz, jnp.arange(tt + 1), -1))
        resyn = jnp.mod(corrected.reshape(n * 8) @ jnp.asarray(self._synd), 2.0)
        ok = (n_roots == deg) & jnp.all(resyn == 0.0)
        return corrected, ok, jnp.where(ok, n_roots, jnp.int32(-1))


    # -------------------------------------------------------- erasure decoding

    def _erasure_tables(self):
        """Lazy host precompute for errors-AND-erasures decoding: the
        locator-building constants and degree-``nsym`` evaluation matrices
        (the errors-only path keeps its smaller degree-``t`` ones)."""
        if getattr(self, "_era", None) is not None:
            return self._era
        exp, log = self._exp, self._log
        n, nsym = self.n, self.nsym
        bits8 = np.arange(8)
        # X_j = alpha^{n-1-j} bit vectors, per received position
        xloc = np.zeros((n, 8), np.float32)
        for j in range(n):
            v = int(exp[(n - 1 - j) % 255])
            xloc[j] = ((v >> bits8) & 1).astype(np.float32)
        # evaluation matrices for polynomials of degree <= nsym
        el = np.zeros(((nsym + 1) * 8, n * 8), np.uint8)
        eld = np.zeros(((nsym + 1) * 8, n * 8), np.uint8)
        eo = np.zeros((nsym * 8, n * 8), np.uint8)
        for j in range(n):
            d = n - 1 - j
            inv = (-d) % 255
            for l in range(nsym + 1):
                c = int(exp[(inv * l) % 255])
                el[l * 8: l * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(
                    c, self.primitive_poly
                ).T
                if l % 2 == 1:
                    cd = int(exp[(inv * (l - 1)) % 255])
                    eld[l * 8: l * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(
                        cd, self.primitive_poly
                    ).T
            forney = int(exp[(d * (1 - self.fcr)) % 255])
            for i in range(nsym):
                c = _gf_mul_int(int(exp[(inv * i) % 255]), forney, exp, log)
                eo[i * 8: i * 8 + 8, j * 8: j * 8 + 8] = _mul_matrix(
                    c, self.primitive_poly
                ).T
        c3 = np.zeros((nsym, nsym, nsym + 1), np.float32)
        for i in range(nsym):
            for l in range(nsym + 1):
                if i + l < nsym:
                    c3[i + l, i, l] = 1.0
        self._era = (
            xloc,
            el.astype(np.float32),
            eld.astype(np.float32),
            eo.astype(np.float32),
            c3,
        )
        return self._era

    def decode_erasures(self, rx, erased) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Errors-AND-erasures decode: corrects ``nu`` unknown errors plus
        ``rho`` caller-flagged erasures whenever ``2*nu + rho <= n - k`` —
        up to twice :meth:`decode`'s budget when the demodulator can flag
        its own unreliable symbols (fade detector, soft-demod confidence).

        ``erased``: bool/int mask ``[..., n]``, nonzero = treat that symbol
        as an erasure (its value is ignored). Returns ``(msg, ok,
        n_corrected)`` like :meth:`decode` (``n_corrected`` counts errors +
        erasures actually corrected).

        Data-parallel form: the erasure locator builds in one ``lax.scan`` over
        positions (masked companion-shift products — no data-dependent
        shapes), Berlekamp-Massey runs all ``n-k`` iterations with a
        ``r >= rho`` enable flag instead of a dynamic start, and the
        Chien/Forney stage is the same matmul set at locator degree
        ``n-k``.
        """
        rx = jnp.asarray(rx)
        if rx.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} received symbols, got {rx.shape[-1]}")
        mask = jnp.asarray(erased)
        if mask.shape[-1] != self.n:
            raise ValueError("erasure mask must match the codeword length")
        mask = (mask != 0)
        lead = rx.shape[:-1]
        rbits = self._to_bits(rx).reshape(lead + (self.n * 8,))
        # erased symbols contribute nothing: zero them so a garbage value
        # cannot corrupt the syndromes beyond what the erasure absorbs
        rbits = rbits * (1.0 - mask.astype(jnp.float32))[..., None].repeat(8, -1).reshape(
            lead + (self.n * 8,)
        )
        synd = jnp.mod(rbits @ jnp.asarray(self._synd), 2.0).reshape(
            lead + (self.nsym, 8)
        )
        flat_syn = synd.reshape((-1, self.nsym, 8))
        flat_rb = rbits.reshape((-1, self.n * 8))
        flat_mask = mask.reshape((-1, self.n)).astype(jnp.float32)
        corr, ok, ncorr = jax.vmap(self._decode_one_erasures)(
            flat_syn, flat_rb, flat_mask
        )
        corr = corr.reshape(lead + (self.n, 8))
        msg = self._to_syms(corr[..., : self.k, :])
        return msg, ok.reshape(lead), ncorr.reshape(lead)

    def _decode_one_erasures(self, synd, rbits, mask):
        nsym, n = self.nsym, self.n
        xloc, el, eld, eo, c3 = self._erasure_tables()
        m3 = jnp.asarray(self._mul3)
        rho = jnp.sum(mask).astype(jnp.int32)

        # ---- erasure locator Gamma(x) = prod_{erased j} (1 - X_j x)
        def gstep(gam, inp):
            xj, mj = inp
            prod = jnp.mod(jnp.einsum("i,ijk,tk->tj", xj, m3, gam), 2.0)
            shifted = jnp.concatenate(
                [jnp.zeros((1, 8), jnp.float32), prod[:-1]], axis=0
            )
            gam_new = jnp.mod(gam + shifted, 2.0)
            return jnp.where(mj > 0, gam_new, gam), None

        gamma0 = jnp.zeros((nsym + 1, 8), jnp.float32).at[0, 0].set(1.0)
        gamma, _ = jax.lax.scan(gstep, gamma0, (jnp.asarray(xloc), mask))

        # ---- BM from Lam = B = Gamma, L = rho, enabled for r >= rho
        pad = jnp.concatenate([jnp.zeros((nsym, 8), jnp.float32), synd], axis=0)
        windows = jnp.stack(
            [pad[r: r + nsym + 1][::-1] for r in range(nsym)], axis=0
        )  # [nsym, nsym+1, 8]
        e_one = jnp.zeros(8, jnp.float32).at[0].set(1.0)

        def const_times(c, poly):
            return jnp.mod(jnp.einsum("i,ijk,tk->tj", c, m3, poly), 2.0)

        def step(carry, wr):
            lam, bpoly, bdisc, ell, r = carry
            delta = jnp.mod(jnp.einsum("ti,ijk,tk->j", lam, m3, wr), 2.0)
            nz = jnp.any(delta > 0)
            active = r >= rho
            xb = jnp.concatenate(
                [jnp.zeros((1, 8), jnp.float32), bpoly[:-1]], axis=0
            )
            t_new = jnp.mod(const_times(bdisc, lam) + const_times(delta, xb), 2.0)
            upd = active & nz & (2 * ell <= r + rho)
            lam_n = jnp.where(active, t_new, lam)
            bpoly_n = jnp.where(upd, lam, jnp.where(active, xb, bpoly))
            bdisc_n = jnp.where(upd, delta, bdisc)
            ell_n = jnp.where(upd, r + 1 - ell + rho, ell)
            return (lam_n, bpoly_n, bdisc_n, ell_n, r + 1), None

        carry0 = (gamma, gamma, e_one, rho, jnp.int32(0))
        (psi, _, _, _, _), _ = jax.lax.scan(step, carry0, windows)

        # ---- Chien + Forney at locator degree nsym
        prod = jnp.mod(jnp.einsum("ic,cjk,lk->ilj", synd, m3, psi), 2.0)
        omega = jnp.mod(jnp.einsum("jil,ilb->jb", jnp.asarray(c3), prod), 2.0)
        psi_flat = psi.reshape((nsym + 1) * 8)
        omg_flat = omega.reshape(nsym * 8)
        val_psi = jnp.mod(psi_flat @ jnp.asarray(el), 2.0).reshape(n, 8)
        val_psid = jnp.mod(psi_flat @ jnp.asarray(eld), 2.0).reshape(n, 8)
        val_omg = jnp.mod(omg_flat @ jnp.asarray(eo), 2.0).reshape(n, 8)
        is_root = jnp.all(val_psi == 0.0, axis=-1)
        e = self._gfmul(val_omg, self._gfinv(val_psid)) * is_root[:, None]
        corrected = jnp.mod(rbits.reshape(n, 8) + e, 2.0)

        n_roots = jnp.sum(is_root.astype(jnp.int32))
        nz = jnp.any(psi > 0, axis=-1)
        deg = jnp.max(jnp.where(nz, jnp.arange(nsym + 1), -1))
        resyn = jnp.mod(corrected.reshape(n * 8) @ jnp.asarray(self._synd), 2.0)
        ok = (n_roots == deg) & jnp.all(resyn == 0.0) & (rho <= nsym)
        return corrected, ok, jnp.where(ok, n_roots, jnp.int32(-1))


def rs_255_223(fcr: int = 1) -> ReedSolomon:
    """The CCSDS-style RS(255, 223), t = 16."""
    return ReedSolomon(255, 223, fcr=fcr)


def symbols_to_bits(sym) -> jnp.ndarray:
    """uint8 symbols ``[..., m]`` -> LSB-first {0,1} bit stream ``[..., m*8]``
    (the framework's bit convention, cf. ``Modulation.index``)."""
    s = jnp.asarray(sym).astype(jnp.int32)
    bits = ((s[..., None] >> jnp.arange(8)) & 1).astype(jnp.uint8)
    return bits.reshape(bits.shape[:-2] + (bits.shape[-2] * 8,))


def bits_to_symbols(bits) -> jnp.ndarray:
    """Inverse of :func:`symbols_to_bits`."""
    b = jnp.asarray(bits)
    if b.shape[-1] % 8:
        raise ValueError("bit count must be a multiple of 8")
    b = b.reshape(b.shape[:-1] + (b.shape[-1] // 8, 8)).astype(jnp.int32)
    w = jnp.asarray(2 ** np.arange(8), jnp.int32)
    return jnp.sum((b % 2) * w, axis=-1).astype(jnp.uint8)
