"""5G-NR-style QC-LDPC: lifting, structured encoding, rate matching, and
edge-message decoding (the flooding-decoder fast path extended along the
dominant modern standard's machinery).

What is implemented EXACTLY per TS 38.212 (the algorithmic spec):

- the **lifting-size table** (§5.3.2, Table 5.3.2-1): the 51 values
  ``Zc = a * 2^j`` for ``a in {2,3,5,7,9,11,13,15}``, set index ``iLS``
  = index of ``a`` (:data:`LIFTING_SIZES`, :func:`lifting_set`);
- **base-graph dimensions and topology class**: BG1 = 46 x 68 blocks with
  ``kb = 22`` systematic block-columns, BG2 = 42 x 52 with ``kb = 10``;
  4 core parity columns (one weight-3 column + a double diagonal, the
  structure that makes encoding a telescoping XOR) and an identity
  extension for the remaining parity rows; the 2 leading systematic
  block-columns are ALWAYS punctured (never transmitted);
- **filler bits** (§5.2.2 / §5.3.2): payload shorter than ``kb * Zc``
  pads with known zeros that are skipped by bit selection and pinned to
  +inf LLR at the decoder;
- **rate matching** (§5.4.2): the circular buffer of length
  ``Ncb = (nb - 2) * Zc``, redundancy-version start offsets ``k0(rv)``
  with the standard ``{0, 17, 33, 56}/66`` (BG1) and ``{0, 13, 25, 43}/50``
  (BG2) fractions, filler skipping, wrap-around repetition, and
  soft-combining de-rate-matching (repeated positions accumulate LLR,
  untransmitted positions get 0);
- **encoding** (§5.3.2's implicit procedure): core parity by the
  telescoping row-sum trick (the weight-3 column's shifts are chosen so
  three of its terms cancel to one cyclic shift), extension parity as
  single-row XORs — ``O(edges)`` cyclic rolls, no dense generator;
- **decoding**: the framework's QC edge-message normalized min-sum
  (:func:`~aether_primitives_tpu.ops.ldpc.qc_ldpc_decode`), batched over
  frames.

What is NOT the 3GPP standard: the **shift coefficients**. TS 38.212
Tables 5.3.2-2/-3 are ~1500 tabulated integers per base graph (8 shift
sets x 316/197 edges); this build environment has no network access and
no copy of the spec, and shipping misremembered values *as* the standard
would create silent non-interoperability. The built-in default is
therefore an **NR-structured** graph (:func:`make_nr_base_graph`): same
dimensions, same puncturing, same core/extension topology, same degree
profile class, shifts chosen by a greedy 4-cycle-free (girth >= 6)
search — the same design rule the standard's tables satisfy, so the
waterfall lands in the published BG1/BG2 performance band (tested).
For codeword-level interop with a 5G stack, pass the standard table:
``NrLdpc(z, bg=2, base_graph=<TS 38.212 Table 5.3.2-3 as [42, 52]
ndarray>)`` — every other byte of the chain (lifting, fillers, rv
offsets, bit selection) already follows the spec.

LLR convention matches the framework: positive = bit 0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import ldpc as _ldpc


# ------------------------------------------------------------- lifting sizes

#: TS 38.212 Table 5.3.2-1: Zc = a * 2^j, a in {2,3,5,7,9,11,13,15},
#: all values <= 384. Set index iLS = index of a.
_A_VALUES = (2, 3, 5, 7, 9, 11, 13, 15)
LIFTING_SIZES: Tuple[int, ...] = tuple(sorted(
    a * (1 << j)
    for a in _A_VALUES
    for j in range(8)
    if a * (1 << j) <= 384
))


def lifting_set(z: int) -> int:
    """Set index ``iLS`` (0-7) of lifting size ``z`` — the index of the
    odd part ``a`` in ``{2,3,5,7,9,11,13,15}`` (TS 38.212 §5.3.2)."""
    if z not in LIFTING_SIZES:
        raise ValueError(f"{z} is not an NR lifting size")
    a = z
    while a % 2 == 0:
        a //= 2
    if a == 1:  # pure powers of two have odd part 1 -> a = 2 branch
        a = 2
    return _A_VALUES.index(a)


_BG_DIMS = {1: (46, 68, 22), 2: (42, 52, 10)}  # bg -> (mb, nb, kb)

#: rv -> k0 numerator fraction (x Ncb / (66 or 50 Zc), floored to a
#: multiple of Zc) — TS 38.212 Table 5.4.2.1-2
_RV_NUM = {1: {0: 0, 1: 17, 2: 33, 3: 56}, 2: {0: 0, 1: 13, 2: 25, 3: 43}}
_RV_DEN = {1: 66, 2: 50}


def rv_start(bg: int, z: int, rv: int, ncb: Optional[int] = None) -> int:
    """Circular-buffer start ``k0`` for redundancy version ``rv``
    (TS 38.212 Table 5.4.2.1-2; ``ncb`` defaults to the full buffer)."""
    mb, nb, _kb = _BG_DIMS[bg]
    if ncb is None:
        ncb = (nb - 2) * z
    num = _RV_NUM[bg][int(rv)]
    return (num * ncb // (_RV_DEN[bg] * z)) * z


# --------------------------------------------------------- base-graph design


def _four_cycle_free_shift(base, i, j, z, rng):
    """Greedy shift pick for edge (i, j): avoid creating a lifted 4-cycle
    with any already-assigned 2x2 all-edges submatrix. A 4-cycle through
    blocks (i,j),(i,j'),(i',j),(i',j') exists iff
    ``(s_ij - s_ij' + s_i'j' - s_i'j) mod z == 0``."""
    mb, nb = base.shape
    forbidden = set()
    rows = np.nonzero(base[:, j] >= 0)[0]
    for jp in range(nb):
        if jp == j or base[i, jp] < 0:
            continue
        for ip in rows:
            if ip == i or base[ip, jp] < 0:
                continue
            # need s_ij != s_ijp - s_ipjp + s_ipj (mod z)
            forbidden.add(
                (base[i, jp] - base[ip, jp] + base[ip, j]) % z
            )
    choices = [s for s in range(z) if s not in forbidden]
    if not choices:  # fully blocked (tiny z, dense row) — accept a 4-cycle
        return int(rng.integers(z))
    return int(choices[rng.integers(len(choices))])


@functools.lru_cache(maxsize=None)
def make_nr_base_graph(bg: int = 2, z: int = 128, seed: int = 1) -> np.ndarray:
    """NR-structured base graph ``[mb, nb]`` (shifts; -1 = zero block).

    Topology (the class TS 38.212's graphs belong to):

    - block-columns ``0..kb-1``: systematic (first two punctured);
    - columns ``kb..kb+3``: core parity. Column ``kb`` has weight 3 on
      rows (0, 1, 3) with shifts ``(1, 0, 0)`` — summing the four core
      rows then telescopes every other parity term away and leaves
      ``P^1 p0 = sum_i(A_i u)``, the single-shift solve the standard's
      encoder uses; columns ``kb+1..kb+3`` are the zero-shift double
      diagonal;
    - rows ``4..mb-1``: extension — a few systematic/core-parity
      connections plus one zero-shift identity column each (parity by
      direct XOR).

    Degree profile: core rows touch most systematic columns (high-degree
    checks protect the punctured columns); extension rows have 3-4
    connections, denser toward the top (higher-rate prefix) — the BG1/BG2
    profile shape. Shifts are greedy 4-cycle-free for the given ``z``
    (girth >= 6 where the topology allows, like the standard tables).

    NOT the 3GPP shift table — see the module docstring for why and for
    the drop-in slot that takes the real one.
    """
    if bg not in _BG_DIMS:
        raise ValueError("bg must be 1 or 2")
    mb, nb, kb = _BG_DIMS[bg]
    rng = np.random.default_rng(seed + 1000 * bg + z)
    base = np.full((mb, nb), -1, np.int64)

    # ---- core rows: dense over systematic columns
    core_sys = {
        0: list(range(kb)),
        1: list(range(kb)),
        2: [c for c in range(kb) if c % 2 == 0 or c < 4],
        3: [c for c in range(kb) if c % 2 == 1 or c < 4],
    }
    # core parity structure (weight-3 col kb + dual diagonal)
    base[0, kb] = 1   # the single non-zero shift of the weight-3 column
    base[1, kb] = 0
    base[3, kb] = 0
    base[0, kb + 1] = 0
    base[1, kb + 1] = 0
    base[1, kb + 2] = 0
    base[2, kb + 2] = 0
    base[2, kb + 3] = 0
    base[3, kb + 3] = 0
    # ---- extension rows: 3-4 connections into cols 0..kb+3 + identity
    for i in range(4, mb):
        deg = 4 if i < 4 + (mb - 4) // 2 else 3
        # always protect the two punctured columns with regular coverage
        cols = {(i - 4) % 2}
        while len(cols) < deg:
            cols.add(int(rng.integers(kb + 4)))
        for j in sorted(cols):
            base[i, j] = 0  # placeholder; shift assigned below
        base[i, kb + 4 + (i - 4)] = 0  # identity extension column
    # ---- assign shifts greedily (4-cycle-free where possible)
    for i in range(mb):
        sys_cols = core_sys.get(i, None)
        if sys_cols is not None:
            for j in sys_cols:
                base[i, j] = 0  # mark as edge first
        for j in range(kb + 4):
            if base[i, j] >= 0 and not (i <= 3 and j >= kb) \
                    and not (i >= 4 and j == kb + 4 + (i - 4)):
                base[i, j] = _four_cycle_free_shift(base, i, j, z, rng)
    return base


# ------------------------------------------------------------------ the code


@dataclass(frozen=True)
class NrLdpc:
    """A concrete NR(-structured) LDPC code at lifting size ``z``.

    ``k``: information bits carried per codeword (``<= kb * z``; the
    difference is filler bits, zeros known to both ends). ``base_graph``:
    optional ``[mb, nb]`` shift table overriding the built-in
    NR-structured one — pass TS 38.212 Table 5.3.2-2 (BG1) / 5.3.2-3
    (BG2) here for standard interop.

    ``encode(bits, e, rv)``: ``[..., k]`` -> ``[..., e]`` rate-matched
    channel bits. ``decode(llrs, e, rv)``: soft inverse ->
    ``(info [..., k], ok [...])``. Multiple rv transmissions soft-combine
    by summing their de-rate-matched LLR buffers before :meth:`decode_buffer`.
    """

    z: int
    bg: int = 2
    k: Optional[int] = None
    base_graph: Optional[tuple] = None  # hashable: tuple of tuples
    seed: int = 1

    def __post_init__(self):
        if self.z not in LIFTING_SIZES:
            raise ValueError(
                f"z={self.z} is not an NR lifting size {LIFTING_SIZES}"
            )
        mb, nb, kb = _BG_DIMS[self.bg]
        if self.base_graph is not None:
            base = np.asarray(self.base_graph, np.int64)
            if base.shape != (mb, nb):
                raise ValueError(
                    f"base graph must be [{mb}, {nb}] for BG{self.bg}"
                )
            # shifts are defined mod z
            base = np.where(base >= 0, base % self.z, -1)
            # normalize the FIELD to a hashable tuple-of-tuples: the
            # frozen-dataclass hash backs the lru_cache on _selection,
            # and an ndarray field would crash it at first encode/decode
            # (review finding r4) — docstrings tell users to pass the
            # TS 38.212 tables as ndarrays, so accept both
            object.__setattr__(
                self, "base_graph", tuple(map(tuple, base.tolist()))
            )
        else:
            base = make_nr_base_graph(self.bg, self.z, self.seed)
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "mb", mb)
        object.__setattr__(self, "nb", nb)
        object.__setattr__(self, "kb", kb)
        k_max = kb * self.z
        k = self.k if self.k is not None else k_max
        if not 0 < k <= k_max:
            raise ValueError(f"k must be in (0, {k_max}], got {k}")
        object.__setattr__(self, "k", k)
        object.__setattr__(self, "n_filler", k_max - k)
        # circular buffer: codeword minus the 2 punctured leading blocks
        object.__setattr__(self, "ncb", (nb - 2) * self.z)
        # filler positions inside the circular buffer (they sit at
        # systematic positions k..kb*z, which shift left by 2z after
        # puncturing)
        f0, f1 = k - 2 * self.z, k_max - 2 * self.z
        object.__setattr__(self, "_filler_span", (max(f0, 0), max(f1, 0)))

    # ------------------------------------------------------------ encode

    def _roll(self, blocks, j, s):
        # qc_expand block (i, j, s): check (i, t) touches var (j, (t+s)%z)
        # -> row i's contribution from block column j is roll(v_j, -s)
        return jnp.roll(blocks[..., j, :], -int(s), axis=-1)

    def codeword(self, bits) -> jnp.ndarray:
        """``[..., k]`` info bits -> FULL ``[..., nb*z]`` codeword
        (fillers included, nothing punctured) — the testing/entry surface;
        :meth:`encode` applies puncturing + rate matching on top."""
        base, z, kb, mb = self._base, self.z, self.kb, self.mb
        b = jnp.asarray(bits, jnp.uint8)
        if b.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} info bits, got {b.shape[-1]}")
        lead = b.shape[:-1]
        if self.n_filler:
            b = jnp.concatenate(
                [b, jnp.zeros(lead + (self.n_filler,), jnp.uint8)], axis=-1
            )
        u = b.reshape(lead + (kb, z))
        # core row sums over systematic columns
        t = []
        for i in range(4):
            acc = jnp.zeros(lead + (z,), jnp.uint8)
            for j in range(kb):
                if base[i, j] >= 0:
                    acc = acc ^ self._roll(u, j, base[i, j])
            t.append(acc)
        # telescoping solve: P^1 p0 = t0 ^ t1 ^ t2 ^ t3
        s_all = t[0] ^ t[1] ^ t[2] ^ t[3]
        p0 = jnp.roll(s_all, 1, axis=-1)  # inverse of roll(-1)
        # row 0: t0 ^ roll(p0, -1) ^ p1 = 0
        p1 = t[0] ^ jnp.roll(p0, -1, axis=-1)
        # row 1: t1 ^ p0 ^ p1 ^ p2 = 0
        p2 = t[1] ^ p0 ^ p1
        # row 3: t3 ^ p0 ^ p3 = 0
        p3 = t[3] ^ p0
        core = jnp.stack([p0, p1, p2, p3], axis=-2)  # [..., 4, z]
        vars_ = jnp.concatenate([u, core], axis=-2)  # [..., kb+4, z]
        # extension rows: direct XOR
        ext = []
        for i in range(4, mb):
            acc = jnp.zeros(lead + (z,), jnp.uint8)
            for j in range(kb + 4):
                if base[i, j] >= 0:
                    acc = acc ^ self._roll(vars_, j, base[i, j])
            ext.append(acc)
        ext = jnp.stack(ext, axis=-2) if ext else jnp.zeros(
            lead + (0, z), jnp.uint8
        )
        cw = jnp.concatenate([vars_, ext], axis=-2)
        return cw.reshape(lead + (self.nb * z,))

    @functools.lru_cache(maxsize=8)
    def _selection(self, e: int, rv: int) -> np.ndarray:
        """Static bit-selection index list (positions in the circular
        buffer) for ``e`` output bits starting at ``k0(rv)``, skipping
        fillers, wrapping (TS 38.212 §5.4.2.1)."""
        f0, f1 = self._filler_span
        k0 = rv_start(self.bg, self.z, rv, self.ncb)
        idx, pos = [], k0
        while len(idx) < e:
            if not (f0 <= pos < f1):
                idx.append(pos)
            pos = (pos + 1) % self.ncb
        return np.asarray(idx, np.int32)

    def encode(self, bits, e: int, rv: int = 0) -> jnp.ndarray:
        """``[..., k]`` info bits -> ``[..., e]`` rate-matched channel
        bits (redundancy version ``rv``)."""
        cw = self.codeword(bits)
        buf = cw[..., 2 * self.z :]  # puncture the 2 leading blocks
        sel = jnp.asarray(self._selection(int(e), int(rv)))
        return jnp.take(buf, sel, axis=-1)

    # ------------------------------------------------------------ decode

    def dematch(self, llrs, rv: int = 0) -> jnp.ndarray:
        """De-rate-match ``[..., e]`` channel LLRs into the ``[..., ncb]``
        circular-buffer LLR (repetitions accumulate; untransmitted = 0).
        Sum several calls' outputs to soft-combine rv retransmissions."""
        lam = jnp.asarray(llrs, jnp.float32)
        sel = jnp.asarray(self._selection(int(lam.shape[-1]), int(rv)))
        buf = jnp.zeros(lam.shape[:-1] + (self.ncb,), jnp.float32)
        return buf.at[..., sel].add(lam)

    def decode_buffer(self, buffer_llrs, iters: int = 25):
        """Decode ``[..., ncb]`` de-rate-matched LLRs ->
        ``(info [..., k], syndrome_ok [...])``."""
        lam = jnp.asarray(buffer_llrs, jnp.float32)
        lead = lam.shape[:-1]
        big = jnp.float32(1e9)
        f0, f1 = self._filler_span
        full = jnp.concatenate(
            [jnp.zeros(lead + (2 * self.z,), jnp.float32), lam], axis=-1
        )
        if f1 > f0:  # fillers are known zeros
            fidx = jnp.arange(f0 + 2 * self.z, f1 + 2 * self.z)
            full = full.at[..., fidx].set(big)
        hard, ok = _ldpc.qc_ldpc_decode(
            full, self._base, self.z, iters=int(iters)
        )
        return hard[..., : self.k], ok

    def decode(self, llrs, rv: int = 0, iters: int = 25):
        """``[..., e]`` channel LLRs -> ``(info [..., k], ok [...])``."""
        return self.decode_buffer(self.dematch(llrs, rv), iters)

    # convenience: parity-check matrix for tests / external tooling
    def parity_check(self) -> np.ndarray:
        """Full binary ``[mb*z, nb*z]`` parity-check matrix."""
        return _ldpc.qc_expand(self._base, self.z)


# -------------------------------------------------- transport-block chain

#: TS 38.212 §5.2.2: maximum code-block size per base graph
_KCB = {1: 8448, 2: 3840}


@dataclass(frozen=True)
class NrTransportBlock:
    """The full TS 38.212 §5.2.2/§5.3.2 transport-block chain: TB CRC24A
    -> segmentation into C code blocks with per-block CRC24B -> one
    :class:`NrLdpc` codec per (equal-sized) block, batched.

    ``tb_bits``: payload size. The chain computes, per the spec's
    procedure: ``B = tb_bits + 24`` (CRC24A); if ``B <= Kcb`` one block
    with no CRC24B, else ``C = ceil(B / (Kcb - 24))`` blocks each
    carrying CRC24B; ``K' = ceil(B' / C)``; lifting size = smallest
    ``Zc`` with ``kb * Zc >= K'``; fillers absorb ``kb * Zc - K'``.

    ``encode(payload, e, rv)`` -> ``[..., C * e]`` channel bits (equal
    ``e`` per block — the per-block E-distribution rule collapses for
    equal blocks); ``decode(llrs, rv)`` -> ``(payload, ok)`` with ``ok``
    = TB CRC24A verdict (per-block CRC24B + LDPC syndromes are the inner
    checks). The base-graph provenance note on :class:`NrLdpc` applies.
    """

    tb_bits: int
    bg: int = 2
    base_graph: Optional[tuple] = None
    seed: int = 1

    def __post_init__(self):
        kcb = _KCB[self.bg]
        b = self.tb_bits + 24  # TB CRC24A
        if b <= kcb:
            c, b_prime = 1, b
            k_per = b
        else:
            c = -(-b // (kcb - 24))
            b_prime = b + 24 * c  # CRC24B per block
            k_per = -(-b_prime // c)
        object.__setattr__(self, "n_blocks", c)
        object.__setattr__(self, "k_per_block", k_per)
        code = NrLdpc(
            z=min(s for s in LIFTING_SIZES
                  if _BG_DIMS[self.bg][2] * s >= k_per),
            bg=self.bg, k=k_per, base_graph=self.base_graph, seed=self.seed,
        )
        object.__setattr__(self, "code", code)
        # leading block carries any shortfall as leading zero pad
        object.__setattr__(self, "pad", c * k_per - b_prime if c > 1
                           else 0)

    def _segments(self, payload) -> jnp.ndarray:
        from . import fec as _fec

        p = jnp.asarray(payload, jnp.uint8)
        if p.shape[-1] != self.tb_bits:
            raise ValueError(
                f"payload must be {self.tb_bits} bits, got {p.shape[-1]}"
            )
        lead = p.shape[:-1]
        flat = p.reshape((-1, self.tb_bits))
        tb = jax.vmap(lambda r: _fec.crc_append(r, "crc24a"))(flat)
        if self.n_blocks == 1:
            return tb.reshape(lead + (1, self.k_per_block))
        if self.pad:
            tb = jnp.concatenate(
                [jnp.zeros(tb.shape[:-1] + (self.pad,), jnp.uint8), tb],
                axis=-1,
            )
        segs = tb.reshape((-1, self.n_blocks, self.k_per_block - 24))
        segs = jax.vmap(jax.vmap(lambda r: _fec.crc_append(r, "crc24b")))(
            segs
        )
        return segs.reshape(lead + (self.n_blocks, self.k_per_block))

    def encode(self, payload, e: int, rv: int = 0) -> jnp.ndarray:
        """``[..., tb_bits]`` -> ``[..., n_blocks * e]`` channel bits."""
        segs = self._segments(payload)
        coded = self.code.encode(segs, e, rv)  # [..., C, e]
        return coded.reshape(coded.shape[:-2] + (self.n_blocks * int(e),))

    def decode(self, llrs, rv: int = 0, iters: int = 25):
        """``[..., n_blocks * e]`` LLRs -> ``(payload [..., tb_bits],
        ok [...])`` — ``ok`` is the transport-block CRC24A verdict."""
        from . import fec as _fec

        lam = jnp.asarray(llrs, jnp.float32)
        if lam.shape[-1] % self.n_blocks:
            raise ValueError(
                f"LLR count {lam.shape[-1]} not divisible by "
                f"{self.n_blocks} blocks"
            )
        e = lam.shape[-1] // self.n_blocks
        lead = lam.shape[:-1]
        segs, _syn_ok = self.code.decode(
            lam.reshape(lead + (self.n_blocks, e)), rv=rv, iters=iters
        )  # [..., C, k_per]
        if self.n_blocks > 1:
            segs = segs[..., : self.k_per_block - 24]  # strip CRC24B
        tb = segs.reshape(lead + (-1,))
        if self.pad:
            tb = tb[..., self.pad :]
        flat = tb.reshape((-1, self.tb_bits + 24))
        ok = jax.vmap(lambda r: _fec.crc_check(r, "crc24a"))(flat)
        return tb[..., : self.tb_bits], ok.reshape(lead)
