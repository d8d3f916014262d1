"""Pseudo-random / M-sequence generation.

Data-parallel re-design of reference ``src/sequence.rs``. The reference's
``generate`` is a serial recurrence fed by an arbitrary closure — serial by
definition (SURVEY.md §7 hard part #4). We provide three tiers:

- :func:`expand` / :func:`generate` — exact API parity (host-side; fine for
  the short init/config sequences these are used for);
- :func:`lfsr_generate` — jittable ``lax.scan`` for any linear recurrence
  ``x(n) = sum_k x(n - d_k) mod 2`` expressed by its delay taps;
- :func:`lfsr_matrix_generate` — the parallel fast path: the recurrence
  as a GF(2) companion-matrix system, generating whole blocks with one
  integer matmul per block (exact in f32/int32 since row sums ≤ order) and
  jumping the state with a precomputed matrix power. This is how a long
  scrambling sequence is produced at HBM speed instead of bit-at-a-time.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def expand(seed: int, length: int) -> np.ndarray:
    """LSB-first bit-unpack of ``seed`` into a {0,1} uint8 vector
    (reference ``expand``, src/sequence.rs:18-21; its doctest
    src/sequence.rs:4-17 is the contract below).

    >>> expand(0b1101, 6).tolist()
    [1, 0, 1, 1, 0, 0]
    """
    i = np.arange(length, dtype=np.uint64)
    return ((np.uint64(seed) >> i) & np.uint64(1)).astype(np.uint8)


def generate(
    init: Sequence[int], generator: Callable[[int, np.ndarray], int], length: int
) -> np.ndarray:
    """Grow ``init`` with ``generator(pos, seq_so_far)`` until ``length``
    (exact semantics of reference ``generate``, src/sequence.rs:47-53).

    Host-side and serial — use :func:`lfsr_generate` /
    :func:`lfsr_matrix_generate` for device-rate linear recurrences.

    The LTE TS36.211 §7.2 x1 recurrence from the reference's doctest
    (src/sequence.rs:31-46): ``x(n) = (x(n-28) + x(n-31)) mod 2``:

    >>> x1 = generate([1] + [0] * 30,
    ...               lambda p, s: (s[p - 28] ^ s[p - 31]) & 1, 40)
    >>> bool(x1[:31].tolist() == [1] + [0] * 30 and x1[31] == 1)
    True
    """
    seq = np.asarray(init, dtype=np.uint8).tolist()
    while len(seq) < length:
        seq.append(np.uint8(generator(len(seq), np.asarray(seq, dtype=np.uint8))))
    return np.asarray(seq, dtype=np.uint8)


def lfsr_generate(init, delays: Sequence[int], length: int) -> jnp.ndarray:
    """Jittable LFSR: ``x(n) = sum_k x(n - d_k) mod 2`` via ``lax.scan``.

    ``init`` must have length ``order = max(delays)``. Example — the LTE
    TS36.211 §7.2 x1 recurrence ``x(n) = (x(n-28) + x(n-31)) mod 2`` from
    the reference's doc example (src/sequence.rs:31-46)::

        x1 = lfsr_generate(expand(1, 31), delays=(28, 31), length=1600)
    """
    delays = tuple(int(d) for d in delays)
    order = max(delays)
    init = jnp.asarray(init, dtype=jnp.uint8)
    if init.shape[-1] != order:
        raise ValueError(f"init length {init.shape[-1]} != max delay {order}")
    if length <= order:
        return init[:length]
    picks = jnp.asarray([order - d for d in delays], dtype=jnp.int32)

    def step(state, _):
        new = (jnp.sum(state[picks]) % 2).astype(jnp.uint8)
        return jnp.concatenate([state[1:], new[None]]), new

    _, out = jax.lax.scan(step, init, None, length=length - order)
    return jnp.concatenate([init, out])


@functools.lru_cache(maxsize=None)
def _lfsr_block_matrices(delays: tuple, order: int, block: int):
    """Precompute (out_matrix [block, order], jump_matrix [order, order]) mod 2.

    With state ``s_n = [x(n), ..., x(n+order-1)]``: ``out = M_out @ s_n`` are
    the next ``block`` outputs ``x(n)..x(n+block-1)`` and
    ``s_{n+block} = M_jump @ s_n`` — both over GF(2), computed here with
    exact numpy int arithmetic.
    """
    comp = np.zeros((order, order), dtype=np.int64)
    comp[:-1, 1:] = np.eye(order - 1, dtype=np.int64)
    for d in delays:
        comp[order - 1, order - d] = 1  # x(n+order) = sum x(n + order - d)
    rows = []
    power = np.eye(order, dtype=np.int64)
    for j in range(block):
        # x(n+j) = (C^j s_n)[0]
        rows.append(power[0])
        power = (power @ comp) % 2
    m_out = np.stack(rows).astype(np.float32)  # [block, order]
    # jump: s_{n+block} = C^block s_n
    jump = np.eye(order, dtype=np.int64)
    base = comp.copy()
    e = block
    while e:
        if e & 1:
            jump = (jump @ base) % 2
        base = (base @ base) % 2
        e >>= 1
    return m_out, jump.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("n_blocks",))
def _lfsr_scan(state0, m_out, m_jump, n_blocks: int):
    def step(state, _):
        out = jnp.mod(m_out @ state, 2.0)
        new_state = jnp.mod(m_jump @ state, 2.0)
        return new_state, out

    _, blocks = jax.lax.scan(step, state0, None, length=n_blocks)
    return blocks


@functools.lru_cache(maxsize=None)
def _lfsr_block_matrices_dev(delays: tuple, order: int, block: int):
    # concrete even when first called inside a trace (see
    # fec._crc_matrices_dev)
    with jax.ensure_compile_time_eval():
        m_out, m_jump = _lfsr_block_matrices(delays, order, block)
        return jnp.asarray(m_out), jnp.asarray(m_jump)


def lfsr_matrix_generate(
    init, delays: Sequence[int], length: int, block: int = 1024
) -> jnp.ndarray:
    """Block-parallel LFSR via GF(2) matrix powers (device fast path).

    Produces the same sequence as :func:`lfsr_generate` but ``block`` bits at
    a time with two small f32 matmuls per block (exact: every dot product is
    an integer ≤ order < 2^24 before the mod). For long scrambling sequences
    this runs at matmul rate instead of one scan step per bit.
    """
    delays = tuple(int(d) for d in delays)
    order = max(delays)
    init = jnp.asarray(init, dtype=jnp.uint8)
    if init.shape[-1] != order:
        raise ValueError(f"init length {init.shape[-1]} != max delay {order}")
    n_blocks = -(-length // block)
    # module-level jitted scan: a bare eager lax.scan RETRACES AND
    # RECOMPILES on every call (the trace cache keys on the step
    # closure's identity), leaking ~3.5 MB of executables per call until
    # long TX loops died with 'LLVM compilation error: Cannot allocate
    # memory' (round-5 finding; same fix in fec.crc_compute and
    # scramble_multiplicative)
    m_out, m_jump = _lfsr_block_matrices_dev(delays, order, block)

    state0 = init.astype(jnp.float32)
    blocks = _lfsr_scan(state0, m_out, m_jump, n_blocks)
    return blocks.reshape(-1)[:length].astype(jnp.uint8)


def lte_gold(c_init: int, length: int, nc: int = 1600) -> jnp.ndarray:
    """3GPP TS36.211 §7.2 pseudo-random (Gold) sequence.

    ``c(n) = (x1(n + Nc) + x2(n + Nc)) mod 2`` with the fixed x1 seed
    (x1(0)=1) and ``c_init`` seeding x2 — the complete version of the x1
    recurrence the reference shows in its doc example
    (reference src/sequence.rs:31-46). Both m-sequences run through the
    block-parallel GF(2) matrix path, so initialization (Nc = 1600 steps)
    and generation happen at matmul rate.
    """
    delays = (28, 31)  # x(n) = x(n-28) + x(n-31) for x1
    total = nc + length
    x1 = lfsr_matrix_generate(expand(1, 31), delays, total)
    # x2: x2(n+31) = x2(n+3) + x2(n+2) + x2(n+1) + x2(n)
    #  -> x2(n) = x2(n-28) + x2(n-29) + x2(n-30) + x2(n-31)
    x2 = lfsr_matrix_generate(expand(c_init, 31), (28, 29, 30, 31), total)
    return ((x1[nc:] + x2[nc:]) % 2).astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _scramble_block_matrices(delays: tuple, order: int, block: int):
    """GF(2) block matrices for the multiplicative-scrambler recurrence
    ``y(n) = x(n) ⊕ Σ_d y(n-d)``.

    With state ``s = [y(n-order), ..., y(n-1)]`` and an input block
    ``x = [x(n), ..., x(n+B-1)]``, the outputs and next state are affine:
    ``y = T_s @ s ⊕ T_x @ x`` and ``s' = (last order rows of [s; y])``.
    Built by running the recurrence symbolically over GF(2) coefficient
    vectors (exact numpy ints), consumed on device as f32 matmuls
    (dot-product sums ≤ order + block < 2^24 — exact).
    """
    d = tuple(sorted(delays))
    rows_s = []  # y_j as coefficients over state bits [order]
    rows_x = []  # ... and over input bits [block]
    # history[k] = coefficient vectors of y(n-order+k) for k in 0..order-1
    hist_s = [np.eye(order, dtype=np.int64)[k] for k in range(order)]
    hist_x = [np.zeros(block, np.int64) for _ in range(order)]
    for j in range(block):
        cs = np.zeros(order, np.int64)
        cx = np.zeros(block, np.int64)
        cx[j] = 1  # x(n+j)
        for dd in d:
            cs ^= hist_s[-dd]
            cx ^= hist_x[-dd]
        rows_s.append(cs)
        rows_x.append(cx)
        hist_s.append(cs)
        hist_x.append(cx)
        hist_s.pop(0)
        hist_x.pop(0)
    t_s = np.stack(rows_s).astype(np.float32)  # [block, order]
    t_x = np.stack(rows_x).astype(np.float32)  # [block, block]
    n_s = np.stack(hist_s).astype(np.float32)  # [order, order] state' over s
    n_x = np.stack(hist_x).astype(np.float32)  # [order, block] state' over x
    return t_s, t_x, n_s, n_x


@functools.lru_cache(maxsize=None)
def _scramble_block_matrices_dev(delays: tuple, order: int, block: int):
    # concrete even when first called inside a trace (see
    # fec._crc_matrices_dev)
    with jax.ensure_compile_time_eval():
        return tuple(
            jnp.asarray(m)
            for m in _scramble_block_matrices(delays, order, block)
        )


def scramble_multiplicative(
    bits, delays: Sequence[int] = (14, 15), init=None, block: int = 256
) -> jnp.ndarray:
    """Self-synchronizing (multiplicative) scrambler
    ``y(n) = x(n) ⊕ Σ_d y(n-d)`` — whitens the line bits so clock/DC
    content never depends on the payload. Default taps ``(14, 15)`` =
    the DVB/V.35 polynomial ``1 + x^14 + x^15``.

    The recurrence feeds back its own OUTPUT (unlike the free-running
    LFSR of :func:`lfsr_matrix_generate`), so the serial dependency is
    broken the same way: ``block`` bits per step as two f32 GF(2)
    matmuls from precomputed affine maps (:func:`_scramble_block_matrices`).
    ``init`` is the ``max(delays)`` output-history bits (default zeros).
    Invert with :func:`descramble_multiplicative` — which needs no state
    agreement beyond ``order`` bits (self-synchronizing; a channel bit
    error multiplies into ``1 + len(delays)`` payload errors, the classic
    trade documented in the tests).
    """
    x = jnp.asarray(bits).astype(jnp.float32) % 2
    if x.ndim != 1:
        raise ValueError("scramble_multiplicative takes a flat bit stream")
    delays = tuple(int(v) for v in delays)
    order = max(delays)
    state0 = (
        jnp.zeros(order, jnp.float32)
        if init is None
        else jnp.asarray(init).astype(jnp.float32) % 2
    )
    if state0.shape[-1] != order:
        raise ValueError(f"init length {state0.shape[-1]} != max delay {order}")
    n = int(x.shape[0])
    pad = (-n) % block
    x = jnp.concatenate([x, jnp.zeros(pad, jnp.float32)])
    # cached device constants (same recompile-leak reasoning as
    # _lfsr_block_matrices_dev)
    t_s, t_x, n_s, n_x = _scramble_block_matrices_dev(delays, order, block)

    y = _scramble_scan(x.reshape(-1, block), state0, t_s, t_x, n_s, n_x)
    return y.reshape(-1)[:n].astype(jnp.uint8)


@jax.jit
def _scramble_scan(x_blocks, state0, t_s, t_x, n_s, n_x):
    # module-level jit: bare eager scans retrace+recompile per call
    # (round-5 TX-loop leak; see _lfsr_scan)
    def step(s, blk):
        y = jnp.mod(t_s @ s + t_x @ blk, 2.0)
        s_next = jnp.mod(n_s @ s + n_x @ blk, 2.0)
        return s_next, y

    _, y = jax.lax.scan(step, state0, x_blocks)
    return y


def descramble_multiplicative(
    bits, delays: Sequence[int] = (14, 15), init=None
) -> jnp.ndarray:
    """Inverse of :func:`scramble_multiplicative`:
    ``x(n) = y(n) ⊕ Σ_d y(n-d)`` — feedFORWARD, so it is one fully
    parallel XOR shift-add over the received stream (the
    :func:`~.fec.conv_encode` pattern; no scan at all). ``init`` is the
    pre-stream history (default zeros); any wrong guess corrupts only the
    first ``max(delays)`` bits — the self-synchronizing property."""
    y = jnp.asarray(bits).astype(jnp.uint8) % 2
    delays = tuple(int(v) for v in delays)
    order = max(delays)
    h = (
        jnp.zeros(order, jnp.uint8)
        if init is None
        else jnp.asarray(init).astype(jnp.uint8) % 2
    )
    yp = jnp.concatenate([h, y])
    n = y.shape[-1]
    acc = y
    for d in delays:
        acc = acc ^ jax.lax.slice_in_dim(yp, order - d, order - d + n, axis=-1)
    return acc


def scramble_additive(bits, sequence) -> jnp.ndarray:
    """Additive (synchronous) scrambler: XOR with a free-running PN
    sequence (e.g. :func:`lte_gold`) — self-inverse, no error
    multiplication, but TX/RX must agree on sequence phase. One fused
    elementwise XOR."""
    b = jnp.asarray(bits).astype(jnp.uint8) % 2
    s = jnp.asarray(sequence).astype(jnp.uint8) % 2
    return b ^ s[: b.shape[-1]]


def bits_to_chips(bits) -> jnp.ndarray:
    """{0,1} spreading bits -> antipodal f32 chips {+1, -1} (bit 0 -> +1,
    the standard BPSK chip map)."""
    return (1.0 - 2.0 * jnp.asarray(bits).astype(jnp.float32)).astype(jnp.float32)


def dsss_spread(symbols, chips) -> jnp.ndarray:
    """Direct-sequence spread: each symbol is multiplied by the ``L``-chip
    code — ``[..., n]`` symbols -> ``[..., n * L]`` chips at the chip rate.

    Pure broadcast + reshape (one fused elementwise kernel). Spreading by
    an ``L``-chip code buys ``10*log10(L)`` dB of processing gain on
    despread (the matched accumulation rejects wideband noise/interference)
    — the DSSS/CDMA layer the framework's Gold sequences
    (:func:`lte_gold`) exist to serve.
    """
    s = jnp.asarray(symbols)
    c = jnp.asarray(chips)
    out = s[..., :, None] * c
    return out.reshape(s.shape[:-1] + (s.shape[-1] * c.shape[-1],))


def dsss_despread(x, chips) -> jnp.ndarray:
    """Matched despread: correlate each ``L``-chip span with the code and
    normalize — the inverse of :func:`dsss_spread` (exact on clean input;
    noise is attenuated by the processing gain). ``[..., n*L] -> [..., n]``.
    Realized as a reshape + small matvec against ``conj(chips)/L`` (no
    strided access)."""
    x = jnp.asarray(x)
    c = jnp.asarray(chips)
    ell = c.shape[-1]
    n = x.shape[-1] // ell
    frames = x[..., : n * ell].reshape(x.shape[:-1] + (n, ell))
    w = jnp.conj(c) / (jnp.sum(jnp.abs(c) ** 2))
    return jnp.sum(frames * w, axis=-1)


def zadoff_chu(root: int, length: int, shift: int = 0) -> np.ndarray:
    """Zadoff-Chu CAZAC sequence (host-side table, complex64):
    ``x[n] = e^{-j pi u n (n+1+2q) / L}`` for odd ``L`` — constant
    amplitude, zero cyclic autocorrelation at every nonzero lag, and
    constant cross-correlation ``1/sqrt(L)`` between coprime roots: the
    preamble/pilot family of LTE/5G (PRACH, SRS, PSS). ``root`` must be
    coprime with ``length``. The quadratic phase reduces mod ``2L`` in
    exact integers before the trig (the framework's exact-mod rule), so
    the table is phase-accurate at any length.

    Pair with :func:`~aether_primitives_tpu.models.sync.detect_preamble`
    (ideal flat correlation floor) or cyclic-shift multiplexing
    (``shift`` = the ``q`` parameter): shifted roots are orthogonal.
    """
    length = int(length)
    root = int(root)
    if length % 2 == 0:
        raise ValueError("zadoff_chu: length must be odd")
    if np.gcd(root, length) != 1:
        raise ValueError("root must be coprime with length")
    n = np.arange(length, dtype=np.int64)
    # phase in half-turns: u n (n + 1 + 2 q) / L, reduced mod 2L
    ph = (root * n * (n + 1 + 2 * int(shift))) % (2 * length)
    return np.exp(-1j * np.pi * ph / length).astype(np.complex64)


# ------------------------------------------------------------- GPS C/A codes

#: IS-GPS-200 Table 3-I: PRN -> (G2 phase-select taps), and the published
#: first-10-chip octal of each code. The octal column makes the table
#: SELF-VERIFYING: :func:`gps_ca_code` recomputes the prefix from the LFSRs
#: and refuses to return a code whose prefix disagrees — a transcription
#: error in either column cannot ship silently.
_GPS_CA_TAPS = {
    1: (2, 6, 0o1440), 2: (3, 7, 0o1620), 3: (4, 8, 0o1710),
    4: (5, 9, 0o1744), 5: (1, 9, 0o1133), 6: (2, 10, 0o1455),
    7: (1, 8, 0o1131), 8: (2, 9, 0o1454), 9: (3, 10, 0o1626),
    10: (2, 3, 0o1504), 11: (3, 4, 0o1642), 12: (5, 6, 0o1750),
    13: (6, 7, 0o1764), 14: (7, 8, 0o1772), 15: (8, 9, 0o1775),
    16: (9, 10, 0o1776), 17: (1, 4, 0o1156), 18: (2, 5, 0o1467),
    19: (3, 6, 0o1633), 20: (4, 7, 0o1715), 21: (5, 8, 0o1746),
    22: (6, 9, 0o1763), 23: (1, 3, 0o1063), 24: (4, 6, 0o1706),
    25: (5, 7, 0o1743), 26: (6, 8, 0o1761), 27: (7, 9, 0o1770),
    28: (8, 10, 0o1774), 29: (1, 6, 0o1127), 30: (2, 7, 0o1453),
    31: (3, 8, 0o1625), 32: (4, 9, 0o1712),
}


@functools.lru_cache(maxsize=None)
def gps_ca_code(prn: int) -> np.ndarray:
    """GPS L1 C/A spreading code for satellite ``prn`` (1..32): 1023
    chips in {0, 1} (IS-GPS-200 §3.3.2.3).

    ``G1``: 10-stage LFSR ``1 + x^3 + x^10``; ``G2``: ``1 + x^2 + x^3 +
    x^6 + x^8 + x^9 + x^10`` (both all-ones init); the C/A chip is
    ``G1_out XOR (G2[s1] XOR G2[s2])`` with the PRN's phase-select taps.
    The generated code's first 10 chips are checked against the
    standard's published octal (see ``_GPS_CA_TAPS``) — the two columns
    verify each other. Map to BPSK chips with
    :func:`bits_to_chips`; acquire delay/Doppler with
    :func:`~aether_primitives_tpu.models.caf.ambiguity`.
    """
    if prn not in _GPS_CA_TAPS:
        raise ValueError(f"PRN {prn} not in 1..32")
    s1, s2, octal_ref = _GPS_CA_TAPS[prn]
    g1 = np.ones(10, np.uint8)
    g2 = np.ones(10, np.uint8)
    out = np.zeros(1023, np.uint8)
    for i in range(1023):
        out[i] = g1[9] ^ g2[s1 - 1] ^ g2[s2 - 1]
        f1 = g1[2] ^ g1[9]  # taps 3, 10
        f2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]  # 2,3,6,8,9,10
        g1 = np.concatenate([[f1], g1[:9]])
        g2 = np.concatenate([[f2], g2[:9]])
    prefix = int("".join(str(int(b)) for b in out[:10]), 2)
    if prefix != octal_ref:
        raise AssertionError(
            f"PRN {prn}: generated prefix {oct(prefix)} != standard "
            f"{oct(octal_ref)} — tap/octal table transcription error"
        )
    return out
