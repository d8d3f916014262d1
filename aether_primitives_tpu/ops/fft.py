"""FFT layer: scaling policy, backend protocol, and backends.

Mirrors the reference's three-part FFT design (reference src/fft.rs):

- :class:`Scale` — the four-variant scaling policy (``None``, ``1/sqrt(N)``,
  ``1/N``, user factor; src/fft.rs:5-38). Forward and backward transforms are
  both **unnormalized**; all normalization comes only from the ``Scale``
  argument (src/fft.rs:48-77).
- :class:`Fft` — the backend-agnostic plan protocol (fixed length per
  instance, ``fwd``/``bwd``; src/fft.rs:48-77). The reference's expensive
  ``Cfft::with_len`` planning step (src/fft.rs:147-158) maps to XLA
  compilation: a plan here is a cache of jitted transforms, so the
  ``vec_fft`` (plan-per-call) vs ``vec_rfft`` (reuse) distinction collapses —
  both hit the jit cache after first trace.
- Backends: :class:`XlaFft` (XLA's FFT HLO via ``jnp.fft``; cuFFT on the
  GPU, the default) and :class:`MatmulFft` — a four-step Cooley-Tukey
  factorization computed as batched DFT-factor **matmuls** with
  precomputed twiddles, recursing over the second factor, for devices
  whose matrix units outrun their vector units on large batches
  (SURVEY.md §7 hard part #2).

Conventions: forward = ``e^{-i 2π k n / N}`` DFT; backward = unnormalized
inverse (conjugate kernel), exactly like rustfft.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32

# --------------------------------------------------------------------------
# Scale policy (reference src/fft.rs:5-38)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Scale:
    """FFT scaling policy: ``NONE``, ``SN`` (1/sqrt(N)), ``N`` (1/N), ``X(f)``.

    ``apply(x)`` scales the whole block; N is the transform length = the last
    axis, matching ``Scale::scale`` (src/fft.rs:22-37).
    """

    kind: str  # "none" | "sn" | "n" | "x"
    factor: Optional[float] = None

    # NONE / SN / N singletons are attached after the class definition.

    @staticmethod
    def X(factor: float) -> "Scale":
        return Scale("x", float(factor))

    def factor_for(self, n: int) -> float:
        if self.kind == "none":
            return 1.0
        if self.kind == "sn":
            return 1.0 / float(np.sqrt(np.float32(n), dtype=np.float32))
        if self.kind == "n":
            return 1.0 / float(np.float32(n))
        if self.kind == "x":
            return float(self.factor)
        raise ValueError(f"unknown scale kind {self.kind!r}")

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        f = self.factor_for(x.shape[-1])
        if f == 1.0:
            return x
        return x * jnp.float32(f)


# Pre-built singletons, used like the reference's enum variants.
Scale.NONE = Scale("none")
Scale.SN = Scale("sn")
Scale.N = Scale("n")


# --------------------------------------------------------------------------
# Matmul (four-step Cooley-Tukey) kernel — trace-time recursive builder
# --------------------------------------------------------------------------

# Base-case DFT size: a full [n, n] DFT matmul is used once a factor is at
# most this, bounding the O(n^2) flops of a dense DFT.
_DFT_BASE = 256
# Above this length a prime (unfactorable) size falls back to the XLA FFT.
_DENSE_MAX = 4096

_PREC = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int, sign: int) -> np.ndarray:
    """[n, k] DFT matrix W^{sign * nk}, computed in f64, stored complex64.

    ``sign=-1`` is the forward kernel e^{-i2πnk/N}; ``+1`` the (unnormalized)
    backward kernel.
    """
    k = np.arange(n, dtype=np.float64)
    ang = (2.0 * np.pi / n) * np.outer(k, k)
    m = np.exp(1j * sign * ang)
    return m.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, sign: int) -> np.ndarray:
    """[n1(k1), n2] twiddle W_N^{sign * n2 k1} with N = n1*n2 (f64 → c64)."""
    k1 = np.arange(n1, dtype=np.float64)
    n2i = np.arange(n2, dtype=np.float64)
    ang = (2.0 * np.pi / (n1 * n2)) * np.outer(k1, n2i)
    return np.exp(1j * sign * ang).astype(np.complex64)


#: Per-size stage-1 factor overrides. Consulted before the heuristic;
#: ``set_factor`` updates it (the autotuner's hook).
_FACTOR_OVERRIDES: dict = {}

def set_factor(n: int, n1: Optional[int]) -> None:
    """Override the first-stage Cooley-Tukey factor for length ``n``
    (``None`` removes the override). ``n1 == n`` selects the single-stage
    dense DFT matmul — for small n one [n, n] matmul can beat a
    factorization whose stages leave a small minor dim, despite its
    O(n^2) flop surplus."""
    if n1 is None:
        _FACTOR_OVERRIDES.pop(int(n), None)
    else:
        if n % n1:
            raise ValueError(f"{n1} does not divide {n}")
        if n1 == n and n > _DENSE_MAX:
            raise ValueError(f"dense DFT override capped at {_DENSE_MAX}")
        _FACTOR_OVERRIDES[int(n)] = int(n1)


def _best_factor(n: int) -> Optional[int]:
    ov = _FACTOR_OVERRIDES.get(n)
    if ov is not None:
        return ov
    return _heuristic_factor(n)


def chained_factor(n: int) -> Optional[int]:
    """First-stage factor for FFTs embedded in chained spectral
    compositions (fft -> elementwise -> ifft, e.g. the correlator).

    A dense single-matmul override can win STANDALONE batched FFTs while
    the FACTORED form wins inside a chain — XLA fuses the factored stages
    with the neighboring elementwise work where the dense [n, n] HIGHEST
    matmuls stay fusion barriers. Returns the
    heuristic factor when the table entry is dense, else None (use the
    table). Pass the result as ``mm_fft(..., first_factor=...)``.
    """
    ov = _FACTOR_OVERRIDES.get(n)
    if ov is not None and ov >= n:
        return _heuristic_factor(n)
    return None


@functools.lru_cache(maxsize=None)
def _heuristic_factor(n: int) -> Optional[int]:
    """Pick n1 | n for the first Cooley-Tukey stage.

    *Balanced* factors keep both stages' contractions deep. Heuristic: the
    smallest
    multiple-of-8 divisor >= ceil(sqrt(n)) (so both stages stay near
    sqrt(n)), capped at 128; fall back to the largest divisor <= 128.
    Sizes above 16384 have no balanced divisor <= 128 — the autotuned
    override table (``_FACTOR_OVERRIDES``) decides those from chip
    measurements.
    """
    root = int(np.ceil(np.sqrt(n)))
    best_balanced = None
    best_any = None
    for d in range(2, min(n, 129)):
        if n % d:
            continue
        best_any = d
        if d % 8 == 0 and d >= root and best_balanced is None:
            best_balanced = d
    if best_balanced is not None:
        return best_balanced
    return best_any


def mm_fft(x: jnp.ndarray, sign: int = -1,
           first_factor: Optional[int] = None) -> jnp.ndarray:
    """Batched DFT along the last axis via matmuls (four-step FFT).

    Recursive Cooley-Tukey: with n = n1*n2 and input index n = n1_idx*n2 +
    n2_idx, output index k = k1 + n1*k2:

      1. contract the n1 axis with a DFT_{n1} matrix (matmul),
      2. multiply by twiddles W_N^{n2 k1},
      3. recurse: DFT_{n2} along the last axis,
      4. transpose (k1, k2) -> (k2, k1) and flatten.

    All matrices are f64-precomputed complex64 constants; matmuls run at
    ``Precision.HIGHEST`` so f32 accuracy survives reduced-precision
    matrix units (bf16 passes, TF32).
    ``first_factor`` overrides the top-level stage-1 factor only (see
    :func:`chained_factor`); the recursion keeps the table.
    """
    n = x.shape[-1]
    x = jnp.asarray(x, dtype=cf32)
    if n == 1:
        return x
    if n <= _DFT_BASE and first_factor is None:
        f = jnp.asarray(_dft_matrix(n, sign))
        return jnp.matmul(x, f, precision=_PREC)
    n1 = first_factor if first_factor is not None else _best_factor(n)
    if n1 is not None and n % n1:
        raise ValueError(f"first_factor {n1} does not divide {n}")
    if n1 is not None and n1 >= n:
        # autotuned dense override: single [n, n] DFT matmul (see set_factor)
        f = jnp.asarray(_dft_matrix(n, sign))
        return jnp.matmul(x, f, precision=_PREC)
    if n1 is None:
        if n <= _DENSE_MAX:
            f = jnp.asarray(_dft_matrix(n, sign))
            return jnp.matmul(x, f, precision=_PREC)
        # large prime length: XLA's FFT (Bluestein) handles it
        return _xla_raw(x, sign)
    n2 = n // n1
    batch = x.shape[:-1]
    xv = x.reshape(batch + (n1, n2))
    f1 = jnp.asarray(_dft_matrix(n1, sign))  # [n1, k1]
    # A[..., k1, n2] = sum_{n1} x[..., n1, n2] * F1[n1, k1]
    a = jnp.einsum("...nm,nk->...km", xv, f1, precision=_PREC)
    a = a * jnp.asarray(_twiddle(n1, n2, sign))
    b = mm_fft(a, sign)  # DFT_{n2} along last axis -> [..., k1, k2]
    out = jnp.swapaxes(b, -1, -2)  # [..., k2, k1]; k = k1 + n1*k2
    return out.reshape(batch + (n,))


@functools.lru_cache(maxsize=None)
def _decim_stage2(n1: int, n2: int, dec: int, sign: int):
    """Matrices for the decimating second FFT stage.

    ``t_full [n1, n2*dec]``: twiddles placed at the decimated positions
    (zeros elsewhere); ``d0 [n2*dec, n2]``: DFT_{n2} rows at decimated
    positions (zeros elsewhere). Together they realize
    ``B[k1,k2] = sum_{m2} A[k1, dec*m2] * W_N^{m2 k1} * W_{n2}^{m2 k2}``
    as one dense elementwise multiply + one dense matmul — no strided
    memory access.
    """
    tw = _twiddle(n1, n2, sign)  # [n1, n2]
    f2 = _dft_matrix(n2, sign)  # [n2, n2]
    t_full = np.zeros((n1, n2 * dec), np.complex64)
    d0 = np.zeros((n2 * dec, n2), np.complex64)
    idx = dec * np.arange(n2)
    t_full[:, idx] = tw
    d0[idx, :] = f2
    return t_full, d0


@functools.lru_cache(maxsize=None)
def _best_factor_decim(n: int, dec: int) -> Optional[int]:
    """Factor choice for the *decimating* FFT: the fused second stage needs
    ``n2 * dec <= _DFT_BASE``, so n1 must be at least ``n*dec/_DFT_BASE`` —
    balanced factors (:func:`_best_factor`) alone can violate that and
    silently push callers onto the pathological strided-slice fallback.
    Prefers the smallest multiple-of-8 divisor satisfying both bounds."""
    min_n1 = max(int(np.ceil(np.sqrt(n))), -(-n * dec // _DFT_BASE))
    if min_n1 > 128:
        return None
    best_any = None
    for d in range(min_n1, 129):
        if n % d:
            continue
        if best_any is None:
            best_any = d
        if d % 8 == 0:
            return d
    return best_any


def mm_fft_decimate(x: jnp.ndarray, dec: int, sign: int = -1) -> jnp.ndarray:
    """DFT of the ``dec``-decimated last axis, without ever materializing
    the decimated signal: ``mm_fft_decimate(x, d) == mm_fft(x[..., ::d])``.

    The polyphase trick behind the fused receive chain: with output length
    ``N = x.shape[-1]/dec = n1*n2``, decimated sample ``m = m1*n2 + m2``
    lives at full-rate index ``j = m1*(n2*dec) + dec*m2`` — so the
    *major*-axis reshape ``[..., n1, n2*dec]`` already isolates ``m1``, the
    first-stage DFT matmul is untouched, and phase selection folds into the
    second-stage matrices as a zero pattern (one extra ``dec`` factor of
    flops on the cheap stage). Every access is dense; the strided gather
    of ``x[..., ::d]`` never happens.

    Requires ``n1 = _best_factor(N)`` to exist and ``n2*dec <= 256``; falls
    back to slice-then-FFT otherwise.
    """
    if dec == 1:
        return mm_fft(x, sign)
    n_full = x.shape[-1]
    if n_full % dec != 0:
        raise ValueError(f"length {n_full} not divisible by decimation {dec}")
    n = n_full // dec
    x = jnp.asarray(x, dtype=cf32)
    n1 = _best_factor_decim(n, dec)
    if n1 is None:
        return mm_fft(x[..., ::dec], sign)  # rare fallback
    n2 = n // n1
    batch = x.shape[:-1]
    xv = x.reshape(batch + (n1, n2 * dec))
    f1 = jnp.asarray(_dft_matrix(n1, sign))
    a = jnp.einsum("...nm,nk->...km", xv, f1, precision=_PREC)
    t_full, d0 = _decim_stage2(n1, n2, dec, sign)
    a = a * jnp.asarray(t_full)
    b = jnp.matmul(a, jnp.asarray(d0), precision=_PREC)  # [..., k1, k2]
    out = jnp.swapaxes(b, -1, -2)
    return out.reshape(batch + (n,))


def fft_of_decimated(
    frames_full_rate, dec: int, scale: Scale = Scale.NONE, backend: Optional[str] = None
) -> jnp.ndarray:
    """Forward FFT of the decimated last axis (``fft(x[..., ::dec])``),
    using the fused matmul path on the matmul backend and slice-then-FFT on
    others. ``scale`` applies at the output length."""
    x = jnp.asarray(frames_full_rate, dtype=cf32)
    b = backend or default_backend()
    if b == "matmul":
        return scale.apply(mm_fft_decimate(x, dec, -1))
    return plan(x.shape[-1] // dec, b).fwd(x[..., ::dec], scale)


def _xla_raw(x: jnp.ndarray, sign: int) -> jnp.ndarray:
    """Unnormalized DFT via the XLA FFT HLO (backward = conj∘fft∘conj)."""
    if sign == -1:
        return jnp.fft.fft(x).astype(cf32)
    # unnormalized inverse without the 1/N that ifft applies
    return jnp.conj(jnp.fft.fft(jnp.conj(x))).astype(cf32)


# --------------------------------------------------------------------------
# Plan protocol + backends (reference Fft trait, src/fft.rs:48-77)
# --------------------------------------------------------------------------


class Fft:
    """A fixed-length FFT plan: ``fwd``/``bwd`` with a :class:`Scale` policy.

    Both directions are unnormalized; scaling comes only from ``scale``.
    Input length must equal the plan length (asserted, like reference
    src/fft.rs:163-167). Batched over leading axes.
    """

    def __init__(self, n: int):
        self.n = int(n)
        self._jits: dict = {}

    def __len__(self) -> int:
        return self.n

    def _check(self, x):
        if x.shape[-1] != self.n:
            raise ValueError(
                f"Input and FFT must be the same length ({x.shape[-1]} vs {self.n})"
            )

    def _raw(self, x: jnp.ndarray, sign: int) -> jnp.ndarray:
        raise NotImplementedError

    def _apply(self, x, sign: int, scale: Scale) -> jnp.ndarray:
        # the jit IS the plan: each (direction, scale) pair compiles once
        # per input shape and replays from the executable cache; when called
        # inside an outer trace the jit inlines transparently
        key = (sign, scale)
        f = self._jits.get(key)
        if f is None:
            f = jax.jit(lambda v: scale.apply(self._raw(v, sign)))
            self._jits[key] = f
        return f(x)

    def fwd(self, x, scale: Scale = Scale.NONE) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=cf32)
        self._check(x)
        return self._apply(x, -1, scale)

    def bwd(self, x, scale: Scale = Scale.NONE) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=cf32)
        self._check(x)
        return self._apply(x, +1, scale)

    # Parity aliases for the reference's in-place / into-temp method family
    # (ifwd/ibwd overwrite input, tfwd/tbwd return the internal temp buffer,
    # reference src/fft.rs:57-73). In a functional framework every variant
    # is the same pure transform; under jit with donated inputs, XLA reuses
    # the input HBM — the in-place behavior — without aliasing hazards.
    ifwd = fwd
    ibwd = bwd
    tfwd = fwd
    tbwd = bwd


class MatmulFft(Fft):
    """Four-step matmul FFT plan (see :func:`mm_fft`)."""

    def _raw(self, x, sign):
        return mm_fft(x, sign)


class XlaFft(Fft):
    """XLA FFT HLO plan (``jnp.fft``), unnormalized both directions."""

    def _raw(self, x, sign):
        return _xla_raw(x, sign)


_BACKENDS = {"matmul": MatmulFft, "xla": XlaFft}
_plan_cache: dict = {}


def default_backend() -> str:
    """XLA's FFT (cuFFT on the GPU) unless overridden with
    ``AETHER_FFT_BACKEND=matmul|xla`` (the analog of the reference's
    swappable-backend feature flags, Cargo.toml:39-46).
    """
    import os

    env = os.environ.get("AETHER_FFT_BACKEND")
    if env in _BACKENDS:
        return env
    return "xla"


def plan(n: int, backend: Optional[str] = None) -> Fft:
    """Get (or create) the cached FFT plan for length ``n``.

    Equivalent of ``Cfft::with_len`` (reference src/fft.rs:147-158); cached
    because a plan is just a pair of jit-cached transforms.

    The reference's doctest contract (src/fft.rs:84-120): a constant input
    concentrates all energy in the DC bin under ``Scale.SN``, and
    ``fwd(SN)`` then ``bwd(SN)`` round-trips to the input:

    >>> import numpy as np
    >>> p = plan(8)
    >>> x = np.ones(8, np.complex64)
    >>> spec = np.asarray(p.fwd(x, Scale.SN))
    >>> round(float(abs(spec[0])), 5), round(float(abs(spec[1:]).max()), 5)
    (2.82843, 0.0)
    >>> back = np.asarray(p.bwd(p.fwd(x, Scale.SN), Scale.SN))
    >>> bool(np.allclose(back, x, atol=1e-5))
    True
    """
    b = backend or default_backend()
    key = (int(n), b)
    p = _plan_cache.get(key)
    if p is None:
        p = _BACKENDS[b](n)
        _plan_cache[key] = p
    return p


def fft(x, scale: Scale = Scale.NONE, backend: Optional[str] = None) -> jnp.ndarray:
    """Forward FFT along the last axis (one-shot convenience, like
    ``vec_fft``, reference src/vecops.rs:301-306 — but with no re-planning
    cost thanks to the plan cache)."""
    x = jnp.asarray(x, dtype=cf32)
    return plan(x.shape[-1], backend).fwd(x, scale)


def ifft(x, scale: Scale = Scale.NONE, backend: Optional[str] = None) -> jnp.ndarray:
    """Unnormalized backward FFT along the last axis (``vec_ifft``)."""
    x = jnp.asarray(x, dtype=cf32)
    return plan(x.shape[-1], backend).bwd(x, scale)
