"""Turbo product codes (TPC) — iterative Chase–Pyndiah decoding as
batched matmul sweeps.

The block-turbo family (IEEE 802.16, satellite modems, optical/storage
links): a two-dimensional product of extended Hamming codes, decoded by
exchanging extrinsic information between row and column soft-input
soft-output (SISO) Chase decoders [Pyndiah, IEEE Trans. Comm. 46(8),
1998]. Completes the iterative-FEC trio next to :mod:`.turbo`
(convolutional turbo) and :mod:`.ldpc` — near-capacity performance at
high code rates (e.g. (32,26)^2 -> rate 0.66, (64,57)^2 -> 0.79)
where convolutional turbo codes need heavy puncturing.

Why this is accelerator-shaped: a CPU TPC decoder walks row-by-row running a
serial Chase loop per row. Here one half-iteration decodes ALL rows of
ALL blocks in the batch as a single elementary-decoder call —
``[B·n, n]`` Chase trials expand to ``[B·n·2^p, n-1]`` Hamming decodes,
which is just :class:`~.bch.BCH`'s matmul/scan pipeline at a wider
batch. The per-bit competitor search of Pyndiah's soft output is one
masked ``min`` over the candidate axis. Row and column halves alternate
under a static ``lax.scan``; there is no data-dependent control flow
anywhere.

Elementary SISO decoder (per code word, all batched):

1. hard-decide the current LLRs, take the ``p`` least-reliable
   positions, form all ``2^p`` test patterns (:mod:`.bch`'s Chase);
2. Hamming-decode every pattern (the (2^m-1, 2^m-1-m) base code is
   PERFECT, so every trial lands on a codeword — no ok-masking), then
   recompute the extension parity bit -> valid extended codewords;
3. candidate metric = analog distance ``Σ |llr|·[cand ≠ hard]``; the
   decision d is the minimum-metric candidate;
4. soft output per bit j: ``λ_j = (metric(best competitor with
   opposite bit j) - metric(d)) / 2 · d̃_j`` where ``d̃ = 1-2d``; when
   no competitor differs at j, ``λ_j = β·r̄·d̃_j`` (β the Pyndiah
   reliability schedule, ``r̄`` the word's mean |llr| — the scale-free
   form of his normalized constant);
5. extrinsic ``w = λ - r`` feeds the other dimension scaled by the α
   schedule.

``decode`` returns ``(data, ok)`` with ``ok`` the exact product-code
membership check of the final hard decision (all row AND column
syndromes zero — two matmuls).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .bch import BCH

__all__ = ["TPC"]

# Pyndiah's published half-iteration schedules (alpha: extrinsic
# weight, beta: no-competitor reliability), extended flat beyond six.
_ALPHA = (0.2, 0.3, 0.5, 0.7, 0.9, 1.0)
_BETA = (0.2, 0.4, 0.6, 0.8, 1.0, 1.0)


class TPC:
    """(2^m, 2^m-1-m)^2 extended-Hamming turbo product code.

    Parameters
    ----------
    m : base field degree — code is the two-dimensional product of the
        extended Hamming code of length ``n = 2^m`` (m=5 -> (32,26)^2,
        rate 0.66; m=6 -> (64,57)^2, rate 0.79).
    p : Chase test-pattern bits per elementary decode (2^p trials).
    iters : full iterations (each = a row half + a column half).

    ``encode`` maps data ``[..., k, k]`` -> codeword bits
    ``[..., n, n]``; ``decode`` maps channel LLRs ``[..., n, n]``
    (positive = bit 0) -> ``(data [..., k, k], ok [...])``. Batched
    over leading axes, jittable throughout.
    """

    def __init__(self, m: int = 5, p: int = 4, iters: int = 4,
                 t_component: int = 1):
        if t_component not in (1, 2):
            raise ValueError(
                "t_component must be 1 (extended Hamming) or 2 "
                "(extended BCH-2, the 802.16-class stronger squares)"
            )
        self.t_component = int(t_component)
        self.base = BCH((1 << m) - 1, t_component)
        self.n = 1 << m
        self.k = self.base.k
        self.p = int(p)
        self.iters = int(iters)
        self.rate = (self.k / self.n) ** 2
        # fast t=1 correction tables: for a perfect Hamming code the S1
        # syndrome IS the error locator (S1 = alpha^{degree of the hit
        # bit}), so correction needs no BM scan and no Chien search —
        # just match S1 against the n position vectors. base._synd's
        # first m columns are the S1 map; row j is also exactly the
        # pattern S1 takes when bit j is in error.
        s1 = self.base._synd[:, :m].astype(np.float32)  # [nb, m]
        self._s1 = s1
        # GF(2) Hamming distance via one matmul: dist(s, row_j) =
        # s · (1 - 2 row_j) + sum(row_j); == 0 iff s == row_j
        self._match_w = (1.0 - 2.0 * s1.T).astype(np.float32)  # [m, nb]
        self._match_b = s1.sum(axis=1).astype(np.float32)      # [nb]

    # ------------------------------------------------------------------ encode

    def encode(self, data) -> jnp.ndarray:
        """Systematic product encode: ``[..., k, k]`` -> ``[..., n, n]``
        (rows then columns; checks-on-checks are consistent because the
        component codes are linear)."""
        data = jnp.asarray(data)
        if data.shape[-2:] != (self.k, self.k):
            raise ValueError(
                f"expected [..., {self.k}, {self.k}] data, got {data.shape}"
            )

        def ext_encode(rows):  # [..., k] -> [..., n]
            cw = self.base.encode(rows).astype(jnp.float32)
            par = jnp.mod(jnp.sum(cw, axis=-1, keepdims=True), 2.0)
            return jnp.concatenate([cw, par], axis=-1)

        rows = ext_encode(data)                       # [..., k, n]
        cols = ext_encode(jnp.swapaxes(rows, -1, -2))  # [..., n, n]
        return jnp.swapaxes(cols, -1, -2).astype(jnp.uint8)

    # ------------------------------------------------------------ elementary

    def _siso(self, r: jnp.ndarray, beta: float,
              rbar: jnp.ndarray) -> jnp.ndarray:
        """Chase–Pyndiah elementary decode of extended-Hamming words:
        LLRs ``[Q, n]`` -> soft output ``[Q, n]`` (same sign convention).
        ``rbar [Q, 1]`` is the CHANNEL-scale anchor (mean |channel LLR|
        of the word's block) for the no-competitor reliability.
        """
        nfull, nb, p = self.n, self.n - 1, self.p
        q = r.shape[0]
        hard = (r < 0.0).astype(jnp.float32)
        rel = jnp.abs(r)
        _, idx = jax.lax.top_k(-rel, p)  # [Q, p] least reliable
        combos = ((np.arange(1 << p)[:, None] >> np.arange(p)) & 1).astype(
            np.float32
        )
        onehot = jax.nn.one_hot(idx, nfull, dtype=jnp.float32)  # [Q, p, n]
        flips = jnp.einsum("cp,bpn->bcn", jnp.asarray(combos), onehot)
        trial = jnp.mod(hard[:, None, :] + flips, 2.0)  # [Q, 2^p, n]

        # Correct the first n-1 bits (t=1 fast path: S1 IS the locator —
        # syndrome-matmul -> distance-match-matmul -> XOR, no BM scan,
        # no Chien, and a perfect code always lands on a codeword; t=2:
        # the half-trace closed form in ops/bch.py, with its exact ok
        # verdict masking the trials that decode to no codeword), then
        # recompute the extension parity bit.
        tb = trial[..., :nb]
        if self.t_component == 1:
            s1 = jnp.mod(tb @ jnp.asarray(self._s1), 2.0)  # [Q, 2^p, m]
            dist = (s1 @ jnp.asarray(self._match_w)
                    + jnp.asarray(self._match_b))
            body = jnp.mod(tb + (dist == 0.0).astype(jnp.float32), 2.0)
            body = body.reshape((q, 1 << p, nb))
            cand_ok = jnp.ones((q, 1 << p), bool)
        else:
            body, okf, _ = self.base._decode_full(tb.reshape((-1, nb)))
            body = body.reshape((q, 1 << p, nb))
            cand_ok = okf.reshape((q, 1 << p))
        par = jnp.mod(jnp.sum(body, axis=-1, keepdims=True), 2.0)
        cand = jnp.concatenate([body, par], axis=-1)  # [Q, 2^p, n]

        diff = jnp.mod(cand + hard[:, None, :], 2.0)
        metric = jnp.sum(diff * rel[:, None, :], axis=-1)  # [Q, 2^p]
        # failed trials (t=2 only) leave the candidate pool via a big
        # finite penalty — inf would poison comp - bm below with nans
        metric = jnp.where(cand_ok, metric, jnp.float32(1e9))
        best = jnp.argmin(metric, axis=-1)
        bm = jnp.take_along_axis(metric, best[:, None], axis=-1)  # [Q, 1]
        d = jnp.take_along_axis(
            cand, best[:, None, None], axis=1
        )[:, 0]  # [Q, n]

        # per-bit best competitor: min metric among candidates whose bit
        # j differs from the decision's bit j
        differs = cand != d[:, None, :]  # [Q, 2^p, n]
        comp = jnp.min(
            jnp.where(differs, metric[:, :, None], jnp.inf), axis=1
        )  # [Q, n]
        # a competitor must be a genuine codeword candidate: the 1e9
        # failed-trial penalty (and inf = none at all) both disqualify
        has = comp < jnp.float32(1e8)
        d_sign = 1.0 - 2.0 * d
        # max-log APP on the LLR scale: with the analog-weight metric
        # M = sum |r| over mismatches, lambda_j = (M_comp - M_best) *
        # d_sign exactly (the Pyndiah /2 belongs to his squared-
        # Euclidean ±1-amplitude convention, not this one). For the
        # no-competitor bits — the MAJORITY at p=4, since only flip-set
        # and Hamming-corrected positions ever differ across candidates
        # — the decoder CONFIRMS the current belief and adds beta on
        # the CHANNEL scale: lambda = d * (|r_in| + beta * rbar), i.e.
        # extrinsic = +-beta*rbar. Two observed failure modes led here
        # (tests/test_tpc.py): anchoring the fallback
        # to the boosted |r_in| scale diverges after ~4 half-iterations
        # (BER 0.017 -> 0.15) because the fallback magnitude inflates
        # with each exchange; replacing the belief with beta alone
        # discards the channel value of 28/32 bits per word and
        # oscillates the same way.
        lam = jnp.where(
            has, (comp - bm) * d_sign, d_sign * (rel + beta * rbar)
        )
        return lam

    # ------------------------------------------------------------------ decode

    def decode(self, llr) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Iterative Chase–Pyndiah decode of channel LLRs ``[..., n, n]``
        -> ``(data [..., k, k] uint8, ok [...])``."""
        llr = jnp.asarray(llr, jnp.float32)
        if llr.shape[-2:] != (self.n, self.n):
            raise ValueError(
                f"expected [..., {self.n}, {self.n}] LLRs, got {llr.shape}"
            )
        lead = llr.shape[:-2]
        r = llr.reshape((-1, self.n, self.n))
        b = r.shape[0]
        n = self.n

        sched = []
        for it in range(self.iters):
            for half in range(2):
                hi = min(2 * it + half, len(_ALPHA) - 1)
                sched.append((_ALPHA[hi], _BETA[hi]))
        sched = np.asarray(sched, np.float32)  # [2*iters, 2]

        # channel-scale anchor for the no-competitor reliability, fixed
        # across iterations (see _siso)
        rbar = jnp.mean(jnp.abs(r), axis=(-1, -2), keepdims=True)  # [b,1,1]
        rbar_words = jnp.broadcast_to(rbar, (b, n, 1)).reshape((-1, 1))

        def half_step(w_other, ab, axis):
            """One half-iteration along ``axis`` (0 = columns as words,
            1 = rows as words): returns (extrinsic, full soft output),
            both in the codeword's [n, n] orientation."""
            alpha, beta = ab[0], ab[1]
            rin = r + alpha * w_other
            words = rin if axis == 1 else jnp.swapaxes(rin, -1, -2)
            lam = self._siso(
                words.reshape((-1, n)), beta, rbar_words
            ).reshape((b, n, n))
            w = lam - words.reshape((b, n, n))
            if axis == 0:
                w, lam = jnp.swapaxes(w, -1, -2), jnp.swapaxes(lam, -1, -2)
            return w, lam

        def body(carry, ab_pair):
            w_row, w_col, _ = carry
            w_row, _lam_r = half_step(w_col, ab_pair[0], axis=1)
            w_col, lam_c = half_step(w_row, ab_pair[1], axis=0)
            return (w_row, w_col, lam_c), None

        # derive the zero carry from r (not jnp.zeros) so its sharding
        # "varying" axes match the body outputs under shard_map
        zeros = r * 0.0
        (_, _, final), _ = jax.lax.scan(
            body, (zeros, zeros, zeros), sched.reshape((self.iters, 2, 2))
        )
        # decision = the last elementary decoder's full soft output
        hard = (final < 0.0).astype(jnp.float32)

        # exact membership: every row and column of the hard decision is
        # an extended codeword (base syndromes zero + even parity)
        def all_codewords(words):  # [b, n, n] words on last axis
            syn = jnp.mod(
                words[..., : n - 1] @ jnp.asarray(self.base._synd), 2.0
            )
            even = jnp.mod(jnp.sum(words, axis=-1), 2.0) == 0.0
            return jnp.all(syn == 0.0, axis=-1) & even

        ok = jnp.all(
            all_codewords(hard) & all_codewords(jnp.swapaxes(hard, -1, -2)),
            axis=-1,
        )
        data = hard[..., : self.k, : self.k].astype(jnp.uint8)
        return data.reshape(lead + (self.k, self.k)), ok.reshape(lead)

    def sharded_decode(self, llr, mesh, axis_name: str = "channel"):
        """:meth:`decode` with the block batch sharded over ``mesh`` —
        pure data parallel (blocks are independent; no collectives), the
        same scan-mode form as ``doa.sharded_estimate_doa`` /
        ``PacketModem.rx_batch_sharded``. ``llr [B, n, n]`` with ``B``
        divisible by the mesh axis; returns the same ``(data, ok)`` as
        the unsharded call (identical bits, tested)."""
        llr = jnp.asarray(llr, jnp.float32)
        if llr.ndim != 3:
            raise ValueError(f"expected [B, n, n] LLRs, got {llr.shape}")
        n_dev = mesh.shape[axis_name]
        if llr.shape[0] % n_dev:
            raise ValueError(
                f"{llr.shape[0]} blocks do not divide over {n_dev} devices"
            )
        p = jax.sharding.PartitionSpec
        fn = jax.shard_map(
            self.decode,
            mesh=mesh,
            in_specs=p(axis_name, None, None),
            out_specs=(p(axis_name, None, None), p(axis_name)),
        )
        return fn(llr)
