"""Turbo codes: parallel-concatenated RSC encoders + max-log-MAP (BCJR)
iterative decoding.

Completes the channel-coding family next to :mod:`.fec` (conv/Viterbi),
:mod:`.ldpc`, and :mod:`.rs` — the classic capacity-approaching code of
cellular standards. Shape: the BCJR forward/backward recursions are
``lax.scan``s over ``[8]``-state metric vectors (the same
vectorized-trellis idiom as :func:`~.fec.viterbi_decode`, twice), all
branch metrics precomputed as one batched elementwise pass, and the
interleaver a fixed permutation (`jnp.take`). Iterations exchange
EXTRINSIC information between the two decoders in the standard schedule.

Code: rate 1/3, two identical RSC(1, 15/13) constituents (K = 4, octal
generators 13 feedback / 15 feedforward — the LTE/CCSDS-class memory-3
workhorse), encoder 1 trellis-terminated with 3 tail pairs, encoder 2
left open (its backward recursion starts uniform). Interleaver: a fixed
seeded uniform permutation per block length.

LLR convention matches the framework: POSITIVE = bit 0
(cf. :func:`~.fec.hard_to_llr`, ``demod_soft``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "turbo_encode",
    "turbo_decode",
    "turbo_interleaver",
    "rsc_encode",
]

# RSC(1, 15/13): feedback g0 = 13 octal = 1011, feedforward g1 = 15 = 1101.
# state s = (s1, s2, s3) as the integer s1*4 + s2*2 + s3;
# a = u ^ s2 ^ s3 (feedback), p = a ^ s1 ^ s3, next = (a, s1, s2).
_K = 4
_N_STATES = 8


@functools.lru_cache(maxsize=None)
def _trellis():
    nxt = np.zeros((_N_STATES, 2), np.int64)
    par = np.zeros((_N_STATES, 2), np.int64)
    fb = np.zeros(_N_STATES, np.int64)  # feedback bit that makes a = 0
    for s in range(_N_STATES):
        s1, s2, s3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        fb[s] = s2 ^ s3
        for u in (0, 1):
            a = u ^ s2 ^ s3
            p = a ^ s1 ^ s3
            nxt[s, u] = (a << 2) | (s1 << 1) | s2
            par[s, u] = p
    # predecessor table: prev[s'][j] = (s, u) with nxt[s, u] = s' (exactly 2)
    prev_s = np.zeros((_N_STATES, 2), np.int64)
    prev_u = np.zeros((_N_STATES, 2), np.int64)
    fill = np.zeros(_N_STATES, np.int64)
    for s in range(_N_STATES):
        for u in (0, 1):
            sp = nxt[s, u]
            prev_s[sp, fill[sp]] = s
            prev_u[sp, fill[sp]] = u
            fill[sp] += 1
    assert (fill == 2).all()
    return nxt, par, fb, prev_s, prev_u


@functools.partial(jax.jit, static_argnames=("terminate",))
def rsc_encode(bits, terminate: bool = True):
    """Systematic recursive convolutional encode of a flat {0,1} block:
    returns ``(parity, tail_sys, tail_par)`` (the systematic stream IS the
    input). With ``terminate`` the trellis is driven back to state 0 in
    ``K-1 = 3`` steps whose (data-dependent) systematic bits are returned
    as ``tail_sys``. Jitted at module level so repeated per-burst encodes
    reuse one executable (bare eager scans recompile per call — the
    round-5 TX-loop leak)."""
    nxt, par, fb, _, _ = _trellis()
    u = jnp.asarray(bits).astype(jnp.int32) % 2
    nxt_j = jnp.asarray(nxt)
    par_j = jnp.asarray(par)

    def step(s, ub):
        return nxt_j[s, ub], par_j[s, ub]

    s_end, parity = jax.lax.scan(step, jnp.int32(0), u)
    if not terminate:
        return parity.astype(jnp.uint8), jnp.zeros(0, jnp.uint8), jnp.zeros(0, jnp.uint8)
    fb_j = jnp.asarray(fb)

    def tstep(s, _):
        ub = fb_j[s]
        return nxt_j[s, ub], (ub, par_j[s, ub])

    _, (tail_sys, tail_par) = jax.lax.scan(tstep, s_end, None, length=_K - 1)
    return (
        parity.astype(jnp.uint8),
        tail_sys.astype(jnp.uint8),
        tail_par.astype(jnp.uint8),
    )


@functools.lru_cache(maxsize=None)
def turbo_interleaver(n: int, seed: int = 0x5EED) -> np.ndarray:
    """Fixed uniform interleaver permutation for block length ``n``."""
    return np.random.default_rng(seed ^ n).permutation(n)


def turbo_encode(bits, seed: int = 0x5EED):
    """Rate-1/3 turbo encode of ``[n]`` info bits. Returns
    ``(sys, par1, par2, tail_sys, tail_par)``: the systematic stream, the
    two constituent parity streams (``par2`` over the interleaved bits),
    and encoder 1's 3 termination pairs. Transmit all five
    (``3n + 6`` bits total)."""
    u = jnp.asarray(bits).astype(jnp.uint8) % 2
    n = int(u.shape[-1])
    perm = turbo_interleaver(n, seed)
    par1, tail_sys, tail_par = rsc_encode(u, terminate=True)
    par2, _, _ = rsc_encode(jnp.take(u, jnp.asarray(perm)), terminate=False)
    return u, par1, par2, tail_sys, tail_par


def _step_coeffs():
    """Static per-transition branch-metric coefficients, so the scan body
    is pure select + FMA on batch-minor planes: for the forward update of
    state ``s'`` via predecessor slot ``j``, the branch metric is
    ``cu[s',j]*(Ls+La) + cp[s',j]*Lp`` with the predecessor row
    ``prev_s[s',j]``; for the backward update of state ``s`` via input
    ``u`` it is ``du[u]*(Ls+La) + dp[s,u]*Lp`` with successor row
    ``nxt[s,u]``. All four tables are Python floats at trace time —
    nothing indexes a tensor by a tensor inside the scan."""
    nxt, par, _, prev_s, prev_u = _trellis()
    u_sgn = 1.0 - 2.0 * np.arange(2)
    p_sgn = 1.0 - 2.0 * par  # [8, 2]
    cu = 0.5 * u_sgn[prev_u]                       # [8, 2]
    cp = 0.5 * p_sgn[prev_s, prev_u]               # [8, 2]
    du = 0.5 * u_sgn                               # [2]
    dp = 0.5 * p_sgn                               # [8, 2]
    return nxt, prev_s, cu, cp, du, dp


def _bcjr_maxlog(l_sys, l_par, l_apr, terminated: bool):
    """Max-log-MAP for one RSC constituent, BATCHED: ``l_* [B, T]`` →
    a-posteriori LLRs ``[B, T]`` (positive = bit 0). With ``terminated``
    the recursions pin state 0 at both ends.

    Layout: the scan carries ``(alpha, beta) [8, B]`` — states on the
    second-minor axis, batch minor — and the step body is 8 static row
    selects + FMAs per direction (coefficients are trace-time floats).
    The old ``[B, 8]``-minor layout put an 8-wide axis minor on every one
    of the ``2T`` serial steps; forward and time-reversed backward recursions
    advance in ONE scan (half the serial steps, identical output)."""
    nxt, prev_s, cu, cp, du, dp = _step_coeffs()
    b_sz, t_len = l_sys.shape
    ls = (l_sys + l_apr).T  # [T, B]
    lp = l_par.T

    neg = jnp.float32(-1e9)
    a0 = jnp.full((_N_STATES, b_sz), neg).at[0].set(0.0)
    b_end = a0 if terminated else jnp.zeros((_N_STATES, b_sz), jnp.float32)

    def step(carry, inp):
        alpha, beta = carry
        ls_t, lp_t, ls_r, lp_r = inp  # [B] each
        a_new = jnp.stack([
            jnp.maximum(
                alpha[prev_s[sp, 0]] + (cu[sp, 0] * ls_t + cp[sp, 0] * lp_t),
                alpha[prev_s[sp, 1]] + (cu[sp, 1] * ls_t + cp[sp, 1] * lp_t),
            )
            for sp in range(_N_STATES)
        ])
        a_new = a_new - jnp.max(a_new, axis=0, keepdims=True)
        b_new = jnp.stack([
            jnp.maximum(
                beta[nxt[s, 0]] + (du[0] * ls_r + dp[s, 0] * lp_r),
                beta[nxt[s, 1]] + (du[1] * ls_r + dp[s, 1] * lp_r),
            )
            for s in range(_N_STATES)
        ])
        b_new = b_new - jnp.max(b_new, axis=0, keepdims=True)
        return (a_new, b_new), (alpha, beta)

    _, (alphas, betas_rev) = jax.lax.scan(
        step, (a0, b_end), (ls, lp, ls[::-1], lp[::-1])
    )  # alphas[t] = alpha BEFORE step t; [T, 8, B]
    betas = betas_rev[::-1]  # betas[t] = beta AFTER step t (for next state)

    # LLR[t] = max_s [alpha + gamma(u=0) + beta(next)] - same for u=1
    m0 = jnp.max(jnp.stack([
        alphas[:, s] + (du[0] * ls + dp[s, 0] * lp) + betas[:, nxt[s, 0]]
        for s in range(_N_STATES)
    ]), axis=0)
    m1 = jnp.max(jnp.stack([
        alphas[:, s] + (du[1] * ls + dp[s, 1] * lp) + betas[:, nxt[s, 1]]
        for s in range(_N_STATES)
    ]), axis=0)
    return (m0 - m1).T  # [B, T], positive = bit 0


def _bcjr_maxlog_windowed(l_sys, l_par, l_apr, window: int, guard: int):
    """Windowed parallel max-log-MAP, BATCHED: ``l_* [B, T]`` →
    ``[B, T]`` — the hardware-decoder idiom: the block splits into
    ``T/window`` windows, each extended by ``guard`` warmup steps on both
    sides; forward/backward recursions run over ALL windows in parallel
    (scan length ``window + 2*guard`` instead of ``T``), initialized
    uniform and converged by the warmup. Approximation vs the exact
    recursion: window-edge metrics lose the propagated state pinning
    (measured: no BER change at guard >= 16 on the test channels, and the
    tail LLRs still bias decoder 1's end states through gamma).

    Layout: scan carry ``(alpha, beta) [8, W, B]`` — states on the
    leading axis (static row selects), windows second-minor, BATCH
    minor. Unlike the old per-codeword ``[W, 8]``-minor form, this one
    is the same combined fwd+rev scan (half the serial steps) with every
    step op batch-wide on the minor axis."""
    nxt, prev_s, cu, cp, du, dp = _step_coeffs()
    b_sz, t_len = l_sys.shape
    n_win = -(-t_len // window)
    t_pad = n_win * window
    lw = window + 2 * guard
    lsum = l_sys + l_apr

    def windows(x):  # [B, T] -> [Lw, W, B] overlapped spans
        xp = jnp.pad(x, [(0, 0), (guard, guard + (t_pad - t_len))])
        s = jnp.stack(
            [
                jax.lax.dynamic_slice_in_dim(xp, w * window, lw, axis=1)
                for w in range(n_win)
            ],
            axis=1,
        )  # [B, W, Lw]
        return jnp.transpose(s, (2, 1, 0))

    ls = windows(lsum)
    lp = windows(l_par)

    def step(carry, inp):
        alpha, beta = carry  # [8, W, B]
        ls_t, lp_t, ls_r, lp_r = inp  # [W, B]
        a_new = jnp.stack([
            jnp.maximum(
                alpha[prev_s[sp, 0]] + (cu[sp, 0] * ls_t + cp[sp, 0] * lp_t),
                alpha[prev_s[sp, 1]] + (cu[sp, 1] * ls_t + cp[sp, 1] * lp_t),
            )
            for sp in range(_N_STATES)
        ])
        a_new = a_new - jnp.max(a_new, axis=0, keepdims=True)
        b_new = jnp.stack([
            jnp.maximum(
                beta[nxt[s, 0]] + (du[0] * ls_r + dp[s, 0] * lp_r),
                beta[nxt[s, 1]] + (du[1] * ls_r + dp[s, 1] * lp_r),
            )
            for s in range(_N_STATES)
        ])
        b_new = b_new - jnp.max(b_new, axis=0, keepdims=True)
        return (a_new, b_new), (alpha, beta)

    a0 = jnp.zeros((_N_STATES, n_win, b_sz), jnp.float32)
    _, (alphas, betas_rev) = jax.lax.scan(
        step, (a0, a0), (ls, lp, ls[::-1], lp[::-1])
    )  # [Lw, 8, W, B] each
    betas = betas_rev[::-1]

    core = slice(guard, guard + window)
    ls_c, lp_c = ls[core], lp[core]  # [window, W, B]
    a_c, b_c = alphas[core], betas[core]
    m0 = jnp.max(jnp.stack([
        a_c[:, s] + (du[0] * ls_c + dp[s, 0] * lp_c) + b_c[:, nxt[s, 0]]
        for s in range(_N_STATES)
    ]), axis=0)
    m1 = jnp.max(jnp.stack([
        a_c[:, s] + (du[1] * ls_c + dp[s, 1] * lp_c) + b_c[:, nxt[s, 1]]
        for s in range(_N_STATES)
    ]), axis=0)
    llr = m0 - m1  # [window, W, B]
    llr = jnp.transpose(llr, (2, 1, 0)).reshape(b_sz, t_pad)  # time order
    return llr[:, :t_len]


def turbo_decode(
    llr_sys,
    llr_par1,
    llr_par2,
    llr_tail_sys=None,
    llr_tail_par=None,
    iterations: int = 6,
    seed: int = 0x5EED,
    window: int = 0,
    guard: int = 24,
    bcjr_backend: str = "auto",
):
    """Iterative turbo decode, batched over arbitrary leading axes.
    Inputs are channel LLRs (positive = bit 0) for the streams
    :func:`turbo_encode` emits — ``[..., n]`` / tails ``[..., 3]`` —
    tail LLRs terminate decoder 1 exactly (pass None to decode
    open-ended). Returns ``(bits, llr)`` — hard decisions and final
    a-posteriori LLRs for the ``n`` info bits, same leading shape.

    ``window > 0`` switches both constituents to the WINDOWED parallel
    BCJR (:func:`_bcjr_maxlog_windowed`): scan length drops from ``T`` to
    ``window + 2*guard`` with the windows batched — the throughput mode
    on accelerators; ``window = 0`` is the exact recursion. Pass the
    batch HERE rather than vmapping: the BCJR layouts put the batch on
    the minor axis, which vmap (batch axis 0) cannot."""
    if bcjr_backend not in ("auto", "xla"):
        raise ValueError(f"unknown bcjr_backend {bcjr_backend!r}")
    ls = jnp.asarray(llr_sys, jnp.float32)
    lp1 = jnp.asarray(llr_par1, jnp.float32)
    lp2 = jnp.asarray(llr_par2, jnp.float32)
    lead = ls.shape[:-1]
    n = int(ls.shape[-1])
    ls = ls.reshape(-1, n)
    lp1 = lp1.reshape(-1, n)
    lp2 = lp2.reshape(-1, n)
    b_sz = ls.shape[0]
    perm = jnp.asarray(turbo_interleaver(n, seed))
    inv = jnp.asarray(np.argsort(turbo_interleaver(n, seed)))
    if llr_tail_sys is not None:
        lts = jnp.asarray(llr_tail_sys, jnp.float32).reshape(b_sz, -1)
        ltp = jnp.asarray(llr_tail_par, jnp.float32).reshape(b_sz, -1)
        ls1 = jnp.concatenate([ls, lts], axis=-1)
        lp1e = jnp.concatenate([lp1, ltp], axis=-1)
        terminated = True
    else:
        ls1, lp1e = ls, lp1
        terminated = False
    ls2 = jnp.take(ls, perm, axis=-1)

    if window:
        def _bcjr(ls_, lp_, la_, term_):
            return _bcjr_maxlog_windowed(ls_, lp_, la_, window, guard)
    else:
        _bcjr = _bcjr_maxlog

    def one_iter(la1, _):
        la1_full = (
            jnp.concatenate(
                [la1, jnp.zeros((b_sz, ls1.shape[-1] - n), jnp.float32)],
                axis=-1,
            )
            if ls1.shape[-1] != n
            else la1
        )
        l1 = _bcjr(ls1, lp1e, la1_full, terminated)[:, :n]
        ext1 = l1 - ls - la1
        la2 = jnp.take(ext1, perm, axis=-1)
        l2 = _bcjr(ls2, lp2, la2, False)
        ext2 = l2 - ls2 - la2
        la1_new = jnp.take(ext2, inv, axis=-1)
        llr_final = jnp.take(l2, inv, axis=-1)
        return la1_new, llr_final

    la0 = jnp.zeros((b_sz, n), jnp.float32)
    _, llrs = jax.lax.scan(one_iter, la0, None, length=int(iterations))
    llr = llrs[-1].reshape(lead + (n,))
    return (llr < 0).astype(jnp.uint8), llr
