"""Forward error correction: convolutional encoding and Viterbi decoding.

The channel-coding layer every deployed modem pairs with the modulation
stack (the reference stops at uncoded PSK — src/modulation.rs). Data-parallel
realizations of the classic pair:

- :func:`conv_encode` — a rate-``1/n`` convolutional code is ``n`` binary
  convolutions mod 2, so encoding is the FIR shift-and-add pattern on
  uint8 planes with XOR accumulation: ``K`` static stride-1 slices per
  generator, fully parallel over the block (no scan, no state machine).
- :func:`viterbi_decode` — maximum-likelihood sequence decoding as a
  ``lax.scan`` over time carrying the ``[2^(K-1)]`` path-metric vector:
  each step is one vectorized add-compare-select over all states (the
  trellis butterflies are two static gathers of a tiny vector), emitting
  one decision bit per state; a second scan walks the traceback. Accepts
  hard bits or soft LLRs (the convention of
  :meth:`~aether_primitives_tpu.ops.modulation.Modulation.demod_soft`:
  positive = bit 0) — soft decisions buy the textbook ~2 dB.

Default generators: the ubiquitous K=7 rate-1/2 code (171, 133 octal —
Voyager/802.11/CCSDS).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


DEFAULT_POLYS = (0o171, 0o133)
DEFAULT_K = 7


def _poly_taps(poly: int, k: int) -> np.ndarray:
    """Generator polynomial -> [k] tap array, taps[j] multiplies x[i-j].

    Convention: the MSB of the ``k``-bit octal generator weights the
    CURRENT input bit (tap 0) — e.g. 0o7 = 111 with K=3 is 1+D+D^2.
    """
    return np.array([(poly >> (k - 1 - j)) & 1 for j in range(k)], np.uint8)


def conv_encode(
    bits,
    polys: Sequence[int] = DEFAULT_POLYS,
    constraint: int = DEFAULT_K,
    terminate: bool = True,
) -> jnp.ndarray:
    """Rate-``1/len(polys)`` convolutional encoder.

    ``terminate=True`` appends ``constraint-1`` zero flush bits so the
    trellis ends in state 0 (the decoder exploits this). Output is
    interleaved ``[..., n_out * len(polys)]`` uint8: per input bit, one
    parity bit per generator. Encoder state starts at 0 (zero history).
    Batched over leading axes; the whole block encodes as ``K`` XOR
    shift-adds per generator — no sequential state machine.
    """
    x = jnp.asarray(bits).astype(jnp.uint8) % 2
    k = int(constraint)
    if terminate:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, k - 1)])
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(k - 1, 0)])
    n = x.shape[-1]
    outs = []
    for poly in polys:
        taps = _poly_taps(int(poly), k)
        acc = jnp.zeros_like(x)
        for j in range(k):
            if taps[j]:
                acc = acc ^ jax.lax.slice_in_dim(
                    xp, k - 1 - j, k - 1 - j + n, axis=-1
                )
        outs.append(acc)
    y = jnp.stack(outs, axis=-1)  # [..., n, n_polys]
    return y.reshape(y.shape[:-2] + (n * len(polys),))


@functools.lru_cache(maxsize=None)
def _trellis(polys: Tuple[int, ...], k: int):
    """Static trellis tables for the scan.

    States are the ``K-1`` most recent input bits (newest in the LSB):
    ``next = ((s << 1) | b) & (2^(K-1) - 1)``. Returns, for each next
    state ``ns`` (with implied input bit ``b = ns & 1``):

    - ``pred [S, 2]``: its two predecessor states (differing in their
      oldest bit);
    - ``outs [S, 2, n]``: the encoder output bits of each transition.
    """
    s_count = 1 << (k - 1)
    half = s_count >> 1
    n = len(polys)
    taps = [_poly_taps(p, k) for p in polys]
    pred = np.zeros((s_count, 2), np.int32)
    outs = np.zeros((s_count, 2, n), np.float32)
    for ns in range(s_count):
        b = ns & 1
        base = ns >> 1
        for which, s in enumerate((base, base | half)):
            pred[ns, which] = s
            # register contents during this transition: input bit b then
            # state bits (newest..oldest) = b, s[0], s[1], ...
            reg = [(b if j == 0 else (s >> (j - 1)) & 1) for j in range(k)]
            for gi in range(n):
                outs[ns, which, gi] = float(
                    int(np.sum(taps[gi] * np.array(reg, np.uint8))) % 2
                )
    return pred, outs


def viterbi_decode(
    llrs,
    polys: Sequence[int] = DEFAULT_POLYS,
    constraint: int = DEFAULT_K,
    terminated: bool = True,
    window: int = 0,
    guard: int = 48,
    backend: str = "auto",
) -> jnp.ndarray:
    """Maximum-likelihood decode of a rate-``1/n`` convolutional code.

    ``llrs``: ``[n_sym * n]`` soft inputs in the framework's LLR
    convention (positive = bit 0 likelier; hard bits map via
    ``1 - 2*bit``). Returns the ``n_sym - (K-1)`` information bits when
    ``terminated`` (flush bits stripped), else ``n_sym``.

    The forward pass scans time with a ``[S]`` path-metric carry: per
    step, each next state gathers its two predecessors' metrics (static
    index vectors), adds the branch costs ``sum_j o_j * llr_j`` (affine-
    equivalent to negative log-likelihood), keeps the min, and records
    the surviving predecessor; the backward pass scans the recorded
    ``[T, S]`` decisions from the final state (0 when terminated, argmin
    otherwise). 1-D input (the metric recursion is a stream property).

    ``window > 0`` selects the WINDOWED truncated-traceback decoder (the
    streaming-receiver idiom): the block splits into parallel windows
    extended by ``guard`` warmup/merge steps each side (``guard`` of
    ~5-7 constraint lengths makes survivor paths merge, so the core
    decisions equal the full-block decode with overwhelming
    probability); both scans shrink from ``T`` to ``window + 2*guard``
    steps with the windows batched. The windowed mode is for LONG
    streams, where the full-block scan's serial length is prohibitive
    (a 1M-bit stream is a million serial ACS steps full-block but ~224
    batched steps windowed).
    """
    llr = jnp.asarray(llrs, jnp.float32)
    n = len(polys)
    k = int(constraint)
    if llr.shape[-1] % n:
        raise ValueError(f"LLR count must be a multiple of n = {n}")
    if backend not in ("auto", "xla"):
        # a typo would silently select the XLA path and invalidate any
        # comparison (the polar_decoder review-finding class)
        raise ValueError(f"unknown backend {backend!r}")
    if llr.ndim != 1:
        # the XLA scans are single-stream; batch via vmap
        fn = lambda v: viterbi_decode(  # noqa: E731
            v, polys, constraint, terminated, window, guard, backend="xla"
        )
        lead = llr.shape[:-1]
        flat = llr.reshape((-1, llr.shape[-1]))
        out = jax.vmap(fn)(flat)
        return out.reshape(lead + out.shape[-1:])
    t_steps = llr.shape[-1] // n
    if window:
        return _viterbi_windowed(
            llr, tuple(int(p) for p in polys), k, terminated, window, guard
        )
    pred, outs = _trellis(tuple(int(p) for p in polys), k)
    s_count = pred.shape[0]
    pred_j = jnp.asarray(pred)  # [S, 2]
    outs_j = jnp.asarray(outs)  # [S, 2, n]
    sym = llr.reshape(t_steps, n)

    init = jnp.full((s_count,), 1e9, jnp.float32).at[0].set(0.0)

    def acs(pm, llr_t):
        # branch cost of transition (pred -> ns): sum_j outs * llr_t[j]
        bm = jnp.sum(outs_j * llr_t[None, None, :], axis=-1)  # [S, 2]
        cand = pm[pred_j] + bm  # [S, 2]
        which = jnp.argmin(cand, axis=-1)  # [S]
        pm_next = jnp.min(cand, axis=-1)
        # metric renormalization keeps f32 finite on long streams
        pm_next = pm_next - jnp.min(pm_next)
        return pm_next, which.astype(jnp.uint8)

    pm, decisions = jax.lax.scan(acs, init, sym)  # decisions [T, S]

    end_state = jnp.where(
        terminated, jnp.int32(0), jnp.argmin(pm).astype(jnp.int32)
    )

    def back(state, dec_t):
        which = dec_t[state]
        prev = pred_j[state, which]
        bit = (state & 1).astype(jnp.uint8)
        return prev, bit

    _, bits_rev = jax.lax.scan(back, end_state, decisions, reverse=True)
    bits = bits_rev  # scan(reverse=True) emits in forward order
    if terminated:
        bits = bits[: t_steps - (k - 1)]
    return bits


def _viterbi_windowed(llr, polys, k, terminated, window, guard):
    """Windowed parallel ACS + truncated traceback (see viterbi_decode).

    Interior windows start with uniform metrics and trace back from the
    argmin state ``guard`` steps past the core — both converge onto the
    maximum-likelihood path within the guard (survivor-merge depth
    ~5-7 K). The stream HEAD and (terminated) TAIL are exact, not
    probabilistic: the pads carry the known state-0 boundary constraints
    as forced LLRs (see below).
    """
    n = len(polys)
    t_steps = llr.shape[-1] // n
    pred, outs = _trellis(polys, k)
    s_count = pred.shape[0]
    pred_j = jnp.asarray(pred)
    outs_j = jnp.asarray(outs)
    sym = llr.reshape(t_steps, n)

    n_win = -(-t_steps // window)
    t_pad = n_win * window
    lw = window + 2 * guard
    # Boundary-state constraints ride in the pad LLRs (advisor finding r3:
    # uniform initial metrics + argmin traceback made the head/tail bits
    # only probabilistically ML). The encoder ALWAYS starts at state 0, and
    # a terminated stream ends flushed to state 0; a huge positive pad LLR
    # (positive = bit 0) makes every pre-stream/post-stream survivor the
    # all-zeros state-0 path — window 0 then starts exactly like the
    # full-block decoder's e0 init, and the last window's argmin traceback
    # lands on the state-0-terminated path. Interior windows never see the
    # pad (their guards are real symbols), so nothing else changes.
    big = jnp.float32(1e6)
    head = jnp.full((guard, n), big)
    tail_len = guard + (t_pad - t_steps)
    tail = jnp.full((tail_len, n), big if terminated else jnp.float32(0.0))
    symp = jnp.concatenate([head, sym, tail], axis=0)
    wins = jnp.stack(
        [
            jax.lax.dynamic_slice_in_dim(symp, w * window, lw, axis=0)
            for w in range(n_win)
        ],
        axis=1,
    )  # [Lw, W, n]

    pm0 = jnp.zeros((n_win, s_count), jnp.float32)

    def acs(pm, llr_t):  # pm [W, S]; llr_t [W, n]
        bm = jnp.sum(outs_j[None] * llr_t[:, None, None, :], axis=-1)  # [W, S, 2]
        cand = pm[:, pred_j] + bm
        which = jnp.argmin(cand, axis=-1)
        pm_next = jnp.min(cand, axis=-1)
        pm_next = pm_next - jnp.min(pm_next, axis=-1, keepdims=True)
        return pm_next, which.astype(jnp.uint8)

    pm, decisions = jax.lax.scan(acs, pm0, wins)  # decisions [Lw, W, S]

    end_state = jnp.argmin(pm, axis=-1).astype(jnp.int32)  # [W]

    def back(state, dec_t):  # state [W]; dec_t [W, S]
        which = jnp.take_along_axis(dec_t, state[:, None], axis=-1)[:, 0]
        prev = pred_j[state, which.astype(jnp.int32)]
        bit = (state & 1).astype(jnp.uint8)
        return prev, bit

    _, bits_rev = jax.lax.scan(back, end_state, decisions, reverse=True)
    # bits_rev [Lw, W] in forward order; keep each window's core
    core = bits_rev[guard : guard + window]  # [window, W]
    bits = core.T.reshape(t_pad)[:t_steps]
    if terminated:
        bits = bits[: t_steps - (k - 1)]
    return bits


@functools.lru_cache(maxsize=None)
def _trellis_fwd(polys: Tuple[int, ...], k: int):
    """Forward-indexed trellis tables for the BCJR recursions: for each
    CURRENT state ``s`` and input ``u``, the next state ``nxt[s, u]``
    and encoder output signs ``sgn[s, u, n] = 1 - 2*out`` (so the
    branch log-likelihood is ``0.5 * sgn · llr``)."""
    s_count = 1 << (k - 1)
    n = len(polys)
    taps = [_poly_taps(p, k) for p in polys]
    nxt = np.zeros((s_count, 2), np.int32)
    sgn = np.zeros((s_count, 2, n), np.float32)
    for s in range(s_count):
        for u in (0, 1):
            nxt[s, u] = ((s << 1) | u) & (s_count - 1)
            reg = np.array(
                [u if j == 0 else (s >> (j - 1)) & 1 for j in range(k)],
                np.uint8,
            )
            for gi in range(n):
                sgn[s, u, gi] = 1.0 - 2.0 * float(
                    int(np.sum(taps[gi] * reg)) % 2
                )
    return nxt, sgn


@functools.lru_cache(maxsize=None)
def _conv_soft_coeffs(polys: Tuple[int, ...], k: int):
    """The rate-1/2 feedforward trellis as the generic hashable
    ``(nxt, prev_s, fw0, fw1, bw0, bw1)`` coefficient tables the Pallas
    BCJR kernel and the windowed scan consume: ``bw_m[s][u] = 0.5 *
    sgn[s, u, m]`` (the conv branch metric ``0.5 Σ_m sgn·llr_m``), and
    the forward entries re-read through the predecessor structure
    ``prev_s[s', j] = (s' >> 1) | (j << (K-2))``, ``prev_u = s' & 1``."""
    if len(polys) != 2:
        raise ValueError(
            "windowed soft decode supports rate-1/2 codes (two LLR "
            f"streams); got {len(polys)} generators"
        )
    nxt, sgn = _trellis_fwd(polys, k)
    s_count = nxt.shape[0]
    half = s_count >> 1
    prev_s = np.array(
        [[(sp >> 1) | (j * half) for j in (0, 1)] for sp in range(s_count)],
        np.int64,
    )
    bw0 = 0.5 * sgn[:, :, 0]
    bw1 = 0.5 * sgn[:, :, 1]
    fw0 = np.array(
        [[bw0[prev_s[sp, j], sp & 1] for j in (0, 1)]
         for sp in range(s_count)], np.float64,
    )
    fw1 = np.array(
        [[bw1[prev_s[sp, j], sp & 1] for j in (0, 1)]
         for sp in range(s_count)], np.float64,
    )
    return (
        tuple(map(tuple, nxt.tolist())),
        tuple(map(tuple, prev_s.tolist())),
        tuple(map(tuple, fw0.tolist())),
        tuple(map(tuple, fw1.tolist())),
        tuple(map(tuple, bw0.tolist())),
        tuple(map(tuple, bw1.tolist())),
    )


def _conv_soft_windowed(llr, polys, k, terminated, window, guard):
    """Windowed parallel max-log BCJR for the feedforward trellis,
    BATCHED: ``llr [B, T*n]`` → a-posteriori LLRs ``[B, T]``. Same
    window construction and boundary-forcing pads as
    :func:`_viterbi_windowed` (head: known state-0 history as huge
    bit-0 LLRs; tail: flush constraints when terminated), uniform
    initial metrics converged by the guards."""
    tables = _conv_soft_coeffs(polys, k)
    nxt, prev_s, fw0, fw1, bw0, bw1 = tables
    s_count = len(nxt)
    b_sz = llr.shape[0]
    n = len(polys)
    t_steps = llr.shape[-1] // n
    sym = llr.reshape(b_sz, t_steps, n)
    n_win = -(-t_steps // window)
    t_pad = n_win * window
    lw = window + 2 * guard
    big = jnp.float32(1e6)
    head = jnp.full((b_sz, guard, n), big)
    tail_len = guard + (t_pad - t_steps)
    tail = jnp.full((b_sz, tail_len, n),
                    big if terminated else jnp.float32(0.0))
    symp = jnp.concatenate([head, sym, tail], axis=1)
    n_cat = -(-lw // window)
    ext_len = (n_win + n_cat) * window
    symp = jnp.pad(symp, [(0, 0), (0, ext_len - symp.shape[1]), (0, 0)])
    segs = [
        symp[:, c * window:(c + n_win) * window].reshape(
            b_sz, n_win, window, n
        )
        for c in range(n_cat)
    ]
    wins = jnp.concatenate(segs, axis=2)[:, :, :lw]  # [B, W, Lw, n]

    l0 = jnp.transpose(wins[..., 0], (2, 1, 0))  # [Lw, W, B]
    l1 = jnp.transpose(wins[..., 1], (2, 1, 0))

    def step(carry, inp):
        alpha, beta = carry  # [S, W, B]
        l0t, l1t, l0r, l1r = inp
        a_new = jnp.stack([
            jnp.maximum(
                alpha[prev_s[sp][0]] + (fw0[sp][0] * l0t + fw1[sp][0] * l1t),
                alpha[prev_s[sp][1]] + (fw0[sp][1] * l0t + fw1[sp][1] * l1t),
            )
            for sp in range(s_count)
        ])
        a_new = a_new - jnp.max(a_new, axis=0, keepdims=True)
        b_new = jnp.stack([
            jnp.maximum(
                beta[nxt[s][0]] + (bw0[s][0] * l0r + bw1[s][0] * l1r),
                beta[nxt[s][1]] + (bw0[s][1] * l0r + bw1[s][1] * l1r),
            )
            for s in range(s_count)
        ])
        b_new = b_new - jnp.max(b_new, axis=0, keepdims=True)
        return (a_new, b_new), (alpha, beta)

    a0 = jnp.zeros((s_count, n_win, b_sz), jnp.float32)
    _, (alphas, betas_rev) = jax.lax.scan(
        step, (a0, a0), (l0, l1, l0[::-1], l1[::-1])
    )
    betas = betas_rev[::-1]
    core = slice(guard, guard + window)
    l0c, l1c = l0[core], l1[core]
    a_c, b_c = alphas[core], betas[core]
    m0 = jnp.max(jnp.stack([
        a_c[:, s] + (bw0[s][0] * l0c + bw1[s][0] * l1c) + b_c[:, nxt[s][0]]
        for s in range(s_count)
    ]), axis=0)
    m1 = jnp.max(jnp.stack([
        a_c[:, s] + (bw0[s][1] * l0c + bw1[s][1] * l1c) + b_c[:, nxt[s][1]]
        for s in range(s_count)
    ]), axis=0)
    out = jnp.transpose(m0 - m1, (2, 1, 0)).reshape(b_sz, t_pad)
    return out[:, :t_steps]


def conv_decode_soft(
    llrs,
    polys: Sequence[int] = DEFAULT_POLYS,
    constraint: int = DEFAULT_K,
    terminated: bool = True,
    window: int = 0,
    guard: int = 64,
    backend: str = "auto",
) -> jnp.ndarray:
    """Soft-OUTPUT decode of a rate-``1/n`` convolutional code: per-bit
    a-posteriori LLRs via max-log BCJR over the feedforward trellis.

    Same input contract as :func:`viterbi_decode` (flat ``[n_sym * n]``
    channel LLRs, positive = bit 0); returns ``[n_sym - (K-1)]`` (when
    ``terminated``, flush positions stripped) a-posteriori LLRs whose
    SIGNS are the decoded bits and whose MAGNITUDES are genuine per-bit
    reliabilities — the thing hard Viterbi cannot produce, and exactly
    what an outer errors-and-erasures Reed-Solomon stage needs to flag
    the inner decoder's characteristic burst errors (the concatenated
    chain this enables lives in ``models/packet.py``
    ``fec="ccsds", rs_erasures=True``; the r3 advisor finding recorded
    why hard bits could never drive that heuristic).

    Same scan structure as the RSC BCJR in :mod:`.turbo` (alpha/beta
    ``[S]`` max-log recursions under ``lax.scan``, normalized each
    step) but over the general nonrecursive trellis of
    :func:`conv_encode`'s ``polys``/``constraint``: the branch metric
    is ``0.5 Σ_j sgn_j llr_j`` with no systematic/parity split, and the
    completion maxes ``alpha + gamma + beta(next)`` over the input-0
    vs input-1 transition families.
    """
    llr = jnp.asarray(llrs, jnp.float32)
    n = len(polys)
    k = int(constraint)
    if llr.shape[-1] % n:
        raise ValueError(f"LLR count must be a multiple of n = {n}")
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if window:
        # windowed parallel form (the streaming/batched-throughput mode;
        # guard >= ~8 constraint lengths makes the uniform-init windows
        # converge onto the exact metrics — sign-identical on the test
        # channels, magnitudes approximate only at window seams)
        lead = llr.shape[:-1]
        flat = llr.reshape((-1, llr.shape[-1]))
        out = _conv_soft_windowed(
            flat, tuple(int(p) for p in polys), k, terminated, window,
            guard,
        )
        if terminated:
            out = out[:, : out.shape[-1] - (k - 1)]
        return out.reshape(lead + out.shape[-1:])
    if llr.ndim != 1:
        # full-block exact path is single-stream; batch via vmap (the
        # windowed mode is the batched-throughput form)
        fn = lambda v: conv_decode_soft(  # noqa: E731
            v, polys, constraint, terminated
        )
        lead = llr.shape[:-1]
        out = jax.vmap(fn)(llr.reshape((-1, llr.shape[-1])))
        return out.reshape(lead + out.shape[-1:])
    t_steps = llr.shape[-1] // n
    nxt, sgn = _trellis_fwd(tuple(int(p) for p in polys), k)
    s_count = nxt.shape[0]
    nxt_j = jnp.asarray(nxt)  # [S, 2]
    sgn_j = jnp.asarray(sgn)  # [S, 2, n]
    sym = llr.reshape(t_steps, n)

    # gamma[t, s, u] = 0.5 * sum_j sgn[s, u, j] * llr[t, j]
    gamma = 0.5 * jnp.einsum("sun,tn->tsu", sgn_j, sym)

    neg = jnp.float32(-1e9)
    pinned = jnp.full((s_count,), neg).at[0].set(0.0)

    def fwd(alpha, g_t):
        # alpha'[s'] = max over incoming (s, u) with nxt[s,u] == s'.
        # scatter-max via the dense [S, 2] candidate table: candidates
        # cand[s, u] = alpha[s] + g_t[s, u] land at row nxt[s, u].
        cand = (alpha[:, None] + g_t).reshape(-1)  # [S*2]
        a_new = jnp.full((s_count,), neg).at[nxt_j.reshape(-1)].max(cand)
        a_new = a_new - jnp.max(a_new)
        return a_new, alpha

    _, alphas = jax.lax.scan(fwd, pinned, gamma)  # alphas[t] = before step t

    b_end = pinned if terminated else jnp.zeros((s_count,), jnp.float32)

    def bwd(beta, g_t):
        cand = g_t + beta[nxt_j]  # [S, 2]
        b_new = jnp.max(cand, axis=-1)
        b_new = b_new - jnp.max(b_new)
        return b_new, beta

    _, betas_rev = jax.lax.scan(bwd, b_end, gamma[::-1])
    betas = betas_rev[::-1]  # betas[t] = beta over the step-t NEXT state

    m0 = jnp.max(alphas + gamma[:, :, 0] + betas[:, nxt_j[:, 0]], axis=-1)
    m1 = jnp.max(alphas + gamma[:, :, 1] + betas[:, nxt_j[:, 1]], axis=-1)
    out = m0 - m1  # positive = bit 0
    if terminated:
        out = out[: t_steps - (k - 1)]
    return out


@functools.lru_cache(maxsize=None)
def _crc_matrices(poly: int, width: int, block: int):
    """GF(2) block matrices for the CRC register recurrence.

    State = the ``width`` CRC register bits MSB-first. One message bit
    ``b`` (MSB-first convention) updates ``crc' = (crc << 1) ^ ((crc_msb
    ^ b) ? poly : 0)`` — affine over GF(2):
    ``crc' = A @ crc ⊕ b·p`` with ``A = shift ⊕ p·e0ᵀ`` and ``p`` the
    polynomial bit vector. ``block`` bits therefore advance the state as
    ``state' = A^B @ state ⊕ M @ bits`` with ``M[:, j] = A^(B-1-j) p`` —
    two small matmuls per block instead of a bit-serial loop (the same
    companion-matrix trick as :func:`~..sequence.lfsr_matrix_generate`).
    Exact numpy integer arithmetic here; f32 on device (dot-product sums
    ≤ ``block + width`` < 2^24).
    """
    p = np.array([(poly >> (width - 1 - i)) & 1 for i in range(width)], np.int64)
    a = np.zeros((width, width), np.int64)
    a[: width - 1, 1:] = np.eye(width - 1, dtype=np.int64)  # shift left (MSB out)
    a[:, 0] ^= p  # feedback of the outgoing MSB
    cols = []
    power_p = p.copy()
    for _ in range(block):  # cols[B-1-j] = A^j p, built back to front
        cols.append(power_p.copy())
        power_p = (a @ power_p) % 2
    m = np.stack(cols[::-1], axis=1).astype(np.float32)  # [width, block]
    a_b = np.eye(width, dtype=np.int64)
    base, e = a.copy(), block
    while e:
        if e & 1:
            a_b = (a_b @ base) % 2
        base = (base @ base) % 2
        e >>= 1
    return a_b.astype(np.float32), m


@functools.lru_cache(maxsize=None)
def _crc_matrices_dev(poly: int, width: int, block: int):
    # the first call may happen INSIDE a jit trace; without the
    # guard jnp.asarray would cache a tracer and later escape it
    # (UnexpectedTracerError in the batched burst bench)
    with jax.ensure_compile_time_eval():
        a_b, m = _crc_matrices(poly, width, block)
        return jnp.asarray(a_b), jnp.asarray(m)


def crc_compute(
    bits,
    poly: int,
    width: int,
    init: int = 0,
    xorout: int = 0,
    reflect_out: bool = False,
    block: int = 512,
) -> jnp.ndarray:
    """CRC of a bit stream as a GF(2) matrix scan — returns the ``width``
    check bits MSB-first (uint8).

    The register recurrence is linear, so whole blocks advance with two
    f32 matmuls (see :func:`_crc_matrices`) instead of one step per bit —
    the data-parallel realization of the checksum every deployed framing layer
    pairs with the FEC in this module. Bits are consumed MSB-first
    (Rocksoft ``refin`` is a byte-local bit permutation — apply it when
    unpacking bytes, cf. :func:`crc32`). ``init`` is folded in by the
    standard identity ``crc(init=I, m) = crc(0, m ⊕ I·x^(n-width))``,
    which also makes front zero-padding to a block multiple free.
    """
    x = jnp.asarray(bits).astype(jnp.float32) % 2
    if x.ndim != 1:
        raise ValueError("crc_compute takes a flat bit stream")
    n = int(x.shape[0])
    iv_np = np.array([(init >> (width - 1 - i)) & 1 for i in range(width)], np.float32)
    if n < width:
        # Too short for the init-fold identity (needs n >= width): one
        # exact affine step with matrices sized to the message.
        a_n, m_n = _crc_matrices(int(poly), int(width), n)
        state = jnp.mod(jnp.asarray(a_n) @ jnp.asarray(iv_np) + jnp.asarray(m_n) @ x, 2.0)
        return _crc_finalize(state, width, xorout, reflect_out)
    if init:
        x = x.at[:width].set(jnp.mod(x[:width] + jnp.asarray(iv_np), 2.0))
    pad = (-n) % block
    x = jnp.concatenate([jnp.zeros(pad, jnp.float32), x])  # leading 0s: no-op at state 0
    # module-level jitted scan + cached device constants: a bare eager
    # lax.scan retraces AND recompiles on every call (round-5 TX-loop
    # leak; see sequence._lfsr_scan)
    a_b, m = _crc_matrices_dev(int(poly), int(width), int(block))
    state = _crc_scan(x.reshape(-1, block), a_b, m)
    return _crc_finalize(state, width, xorout, reflect_out)


@jax.jit
def _crc_scan(x_blocks, a_b, m):
    def step(state, blk):
        return jnp.mod(a_b @ state + m @ blk, 2.0), None

    state, _ = jax.lax.scan(step, jnp.zeros(a_b.shape[0], jnp.float32),
                            x_blocks)
    return state


def _crc_finalize(state, width: int, xorout: int, reflect_out: bool) -> jnp.ndarray:
    """Apply Rocksoft ``refout``/``xorout`` to the final register state.
    ``xorout`` is specified on the (possibly reflected) output integer,
    so it is applied AFTER the reflection, LSB of the int = last bit."""
    out = state.astype(jnp.uint8)
    if reflect_out:
        out = out[::-1]
    if xorout:
        xv = jnp.asarray(
            [(xorout >> (width - 1 - i)) & 1 for i in range(width)], jnp.uint8
        )
        out = out ^ xv
    return out


#: Rocksoft parameter sets: (poly, width, init, refin, refout, xorout).
CRC_PARAMS = {
    "crc32": (0x04C11DB7, 32, 0xFFFFFFFF, True, True, 0xFFFFFFFF),  # ISO-HDLC/zlib
    "crc16-ccitt": (0x1021, 16, 0xFFFF, False, False, 0x0),  # CCITT-FALSE
    "crc16-usb": (0x8005, 16, 0xFFFF, True, True, 0xFFFF),
    "crc8": (0x07, 8, 0x00, False, False, 0x00),  # SMBus
    # 3GPP TS 38.212 §5.1: gCRC24A (transport-block CRC) and gCRC24B
    # (code-block CRC) — zero init, no reflection, zero xorout
    "crc24a": (0x864CFB, 24, 0x000000, False, False, 0x000000),
    "crc24b": (0x800063, 24, 0x000000, False, False, 0x000000),
}


def crc_bits(bits, kind: str = "crc32") -> jnp.ndarray:
    """Named-parameter CRC of an MSB-first bit stream (``refin`` does not
    apply to a raw bit stream; for byte inputs use :func:`crc32`).
    Returns check bits in transmission order (MSB-first after ``refout``)."""
    poly, width, init, _refin, refout, xorout = CRC_PARAMS[kind]
    return crc_compute(bits, poly, width, init, xorout, reflect_out=refout)


def crc32(data: bytes) -> int:
    """CRC-32/ISO-HDLC of a byte string — bit-compatible with
    ``zlib.crc32`` (the contract test). Bytes are unpacked LSB-first
    (``refin``), the register runs MSB-first on device, and the output is
    reflected + inverted (``refout``/``xorout``)."""
    arr = np.frombuffer(bytes(data), np.uint8)
    bits = np.unpackbits(arr, bitorder="little")  # refin: LSB of each byte first
    out = np.asarray(crc_bits(bits, "crc32"))
    # transmission order here is reflected -> LSB-first integer assembly
    return int(np.packbits(out[::-1], bitorder="little").view(np.uint32)[0])


def crc_append(bits, kind: str = "crc32") -> jnp.ndarray:
    """Append the ``kind`` check bits to a bit stream (systematic framing:
    ``[info | crc]``, check bits in transmission order)."""
    b = jnp.asarray(bits).astype(jnp.uint8) % 2
    return jnp.concatenate([b, crc_bits(b, kind)])


def crc_check(bits, kind: str = "crc32") -> jnp.ndarray:
    """Verify a ``[info | crc]`` frame produced by :func:`crc_append` —
    recomputes the check over the info bits and compares. Returns a
    scalar bool array (jit-friendly; no data-dependent Python branch)."""
    poly, width, *_ = CRC_PARAMS[kind]
    del poly
    b = jnp.asarray(bits).astype(jnp.uint8) % 2
    want = crc_bits(b[: b.shape[0] - width], kind)
    return jnp.all(want == b[b.shape[0] - width :])


def conv_interleave(x, branches: int = 12, cell: int = 17, state=None):
    """Convolutional (Forney) interleaver — the DVB-class streaming
    complement to the block :func:`interleave`.

    A commutator cycles ``branches`` delay lines; branch ``j`` (hit at
    positions ``t ≡ j mod I``) delays by ``j·cell·I`` samples. Against
    the block form: HALF the end-to-end latency for the same burst-
    spreading power, and the natural shape for continuous streams —
    state threads block-to-block exactly like the FIR ``history=``
    plumbing (chunked == contiguous, tested).

    ``state`` is the ``(I-1)·cell·I``-sample history (None = cold start,
    zeros). Returns ``(y, new_state)``; works on bits or LLRs (any
    dtype), 1-D. Deinterleave with :func:`conv_deinterleave` using the
    same parameters; the cascade is the identity delayed by
    ``(I-1)·cell·I`` samples.
    """
    return _conv_ilv(x, branches, cell, state, deinter=False)


def conv_deinterleave(x, branches: int = 12, cell: int = 17, state=None):
    """Inverse of :func:`conv_interleave`: branch ``j`` delays by
    ``(I-1-j)·cell·I`` samples, so the cascade is a pure
    ``(I-1)·cell·I``-sample delay. Same ``(y, new_state)`` contract."""
    return _conv_ilv(x, branches, cell, state, deinter=True)


def _conv_ilv(x, branches, cell, state, deinter: bool):
    """Shared Forney (de)interleaver core. The delay structure is
    per-residue-class (position ``t`` belongs to class ``t mod I``, and
    every member of class ``j`` is delayed by the same ``d_j·cell·I``),
    so instead of one arbitrary 1-D gather the stream reshapes to
    ``[T/I, I]`` and each class is ONE static row-slice of the
    history-extended column: I static slices, the shift-and-add idiom."""
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError("conv_(de)interleave takes a flat stream")
    i, m = int(branches), int(cell)
    if x.shape[0] % i:
        raise ValueError(
            f"stream length {x.shape[0]} not divisible by branches {i} "
            "(pad the final chunk)"
        )
    depth = (i - 1) * m * i
    if state is None:
        state = jnp.zeros((depth,), x.dtype)
    ext = jnp.concatenate([state, x])
    # one transpose up front so each class is a CONTIGUOUS row rather
    # than a per-class strided column slice (ext2[:, j])
    ext2 = ext.reshape(-1, i).T  # [I, (depth+T)/I]; class j = row j
    rows = x.shape[0] // i
    d0 = depth // i
    cols = []
    for j in range(i):
        dj = (i - 1 - j) if deinter else j
        start = d0 - dj * m
        cols.append(
            jax.lax.slice_in_dim(ext2[j], start, start + rows)
        )
    y = jnp.stack(cols, axis=1).reshape(-1)
    return y, ext[ext.shape[0] - depth:]


def conv_interleave_block(x, branches: int = 12, cell: int = 17):
    """Circular (helical) convolutional interleaver for FRAMED data:
    the branch delays wrap modulo the block length, making the map a
    true permutation (no latency, no flush) — the packet-sized form of
    :func:`conv_interleave`, with the same burst-spreading structure.
    Needs ``branches | len(x)``. Invert with
    :func:`conv_deinterleave_block`."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    i, m = int(branches), int(cell)
    if n % i:
        raise ValueError(f"length {n} not divisible by branches {i}")
    # per-class static rolls, not a gather; the swapaxes keeps each
    # class contiguous (no strided slices)
    x2 = jnp.swapaxes(
        x.reshape(x.shape[:-1] + (n // i, i)), -1, -2
    )  # [..., I, n/I]
    cols = [jnp.roll(x2[..., j, :], j * m, axis=-1) for j in range(i)]
    return jnp.stack(cols, axis=-1).reshape(x.shape)


def conv_deinterleave_block(x, branches: int = 12, cell: int = 17):
    """Inverse permutation of :func:`conv_interleave_block`."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    i, m = int(branches), int(cell)
    if n % i:
        raise ValueError(f"length {n} not divisible by branches {i}")
    x2 = jnp.swapaxes(
        x.reshape(x.shape[:-1] + (n // i, i)), -1, -2
    )
    cols = [jnp.roll(x2[..., j, :], -j * m, axis=-1) for j in range(i)]
    return jnp.stack(cols, axis=-1).reshape(x.shape)


def hard_to_llr(bits) -> jnp.ndarray:
    """Map hard bits {0,1} to the LLR convention (+1 = strong 0)."""
    return (1.0 - 2.0 * jnp.asarray(bits).astype(jnp.float32)).astype(jnp.float32)


def interleave(x, rows: int) -> jnp.ndarray:
    """Block interleaver: write row-wise into a ``[rows, cols]`` matrix,
    read column-wise — a channel-error burst of up to ``rows`` symbols
    lands at least ``cols - 1`` positions apart after deinterleaving,
    i.e. as isolated errors inside the Viterbi decoder's correction span.
    Length must divide by ``rows``. Works on bits or LLRs (any dtype);
    invert with :func:`deinterleave` using the same ``rows``."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n % rows:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    m = x.reshape(x.shape[:-1] + (rows, n // rows))
    return jnp.swapaxes(m, -1, -2).reshape(x.shape)


def deinterleave(x, rows: int) -> jnp.ndarray:
    """Inverse of :func:`interleave` (same ``rows``)."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n % rows:
        raise ValueError(f"length {n} not divisible by rows {rows}")
    m = x.reshape(x.shape[:-1] + (n // rows, rows))
    return jnp.swapaxes(m, -1, -2).reshape(x.shape)
