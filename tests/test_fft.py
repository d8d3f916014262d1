"""FFT layer tests: Scale policy arithmetic (reference src/fft.rs:238-270),
rustfft convention parity (unnormalized both ways), round trips, and
golden comparisons of both backends against float64 numpy FFTs."""

import jax.numpy as jnp
import numpy as np
import pytest

from aether_primitives_tpu import assert_evm, cf32
from aether_primitives_tpu.evm import evm_db, evm_rms_db
from aether_primitives_tpu.ops.fft import Scale, fft, ifft, mm_fft, plan

BACKENDS = ["xla", "matmul"]


def rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_scale_policy():
    # reference Scale test: input 4+0j x4 (src/fft.rs:246-270)
    x = jnp.full((4,), 4.0 + 0j, dtype=cf32)
    assert_evm(Scale.NONE.apply(x), x)
    assert_evm(Scale.SN.apply(x), jnp.full((4,), 2.0 + 0j, dtype=cf32))
    assert_evm(Scale.N.apply(x), jnp.full((4,), 1.0 + 0j, dtype=cf32))
    assert_evm(Scale.X(2.0).apply(x), jnp.full((4,), 8.0 + 0j, dtype=cf32))


def test_dc_bin_unscaled():
    # reference doc example: unscaled FFT of all-ones puts all energy in DC
    # (src/fft.rs:101-107)
    # assert_evm's zero-reference elements admit no error at all, and unlike
    # rustfft's radix kernels (which produce exact zeros here) our backends
    # leave ~1e-6 residue in the non-DC bins — so check the DC bin with
    # assert_evm and the zero bins against the vector scale.
    x = jnp.full((128,), 1.0 + 0j, dtype=cf32)
    for b in BACKENDS:
        out = np.asarray(fft(x, Scale.NONE, backend=b))
        assert_evm(out[:1], np.array([128.0 + 0j]), -80.0)
        assert np.max(np.abs(out[1:])) / 128.0 < 1e-6  # < -60 dB of full scale


def test_unnormalized_backward():
    # bwd must NOT divide by N: ifft(fft(x)) == N * x with Scale.NONE
    rng = np.random.default_rng(1)
    x = rand_c(rng, (64,))
    for b in BACKENDS:
        out = ifft(fft(x, backend=b), backend=b)
        ref = 64.0 * x.astype(np.complex128)
        assert evm_db(out, ref) < -40
        assert evm_rms_db(out, ref) < -120


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [4, 100, 128, 512, 1024, 2048])
def test_forward_vs_numpy_golden(backend, n):
    rng = np.random.default_rng(n)
    x = rand_c(rng, (4, n))
    got = fft(x, Scale.NONE, backend=backend)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    # f32 kernels vs f64 golden. Per-element relative EVM on random input is
    # dominated by tiny-magnitude bins (~-45 dB is the f32 floor — XLA's own
    # FFT measures the same); the energy-relative RMS EVM is the meaningful
    # accuracy gate and sits near the f32 noise floor.
    assert evm_db(got, ref) < -38
    assert evm_rms_db(got, ref) < -120


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [4, 100, 512, 2048])
def test_backward_vs_numpy_golden(backend, n):
    rng = np.random.default_rng(n + 7)
    x = rand_c(rng, (3, n))
    got = ifft(x, Scale.N, backend=backend)
    ref = np.fft.ifft(x.astype(np.complex128), axis=-1)
    assert evm_db(got, ref) < -38
    assert evm_rms_db(got, ref) < -120


@pytest.mark.parametrize("backend", BACKENDS)
def test_roundtrip_sn(backend):
    # reference vecops round-trip: fft(SN) -> ifft(SN) ~ identity at -80 dB
    # (src/vecops.rs:443-463). The -80 bound holds for the XLA backend (like
    # rustfft, near-exact on constant input); the matmul backend lands at
    # ~-66 dB (~2x f32 eps — cf. the reference's own -69 dB chain result,
    # src/fft.rs:117-119), so it gets the corresponding bound.
    x = jnp.full((100,), 1.0 + 1.0j, dtype=cf32)
    out = ifft(fft(x, Scale.SN, backend=backend), Scale.SN, backend=backend)
    assert_evm(out, x, -80.0 if backend == "xla" else -64.0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chained_scale_roundtrip(backend):
    # reference doc example: rfft(SN).scale(2).rifft(SN) ~ 2x, -72 dB
    # (src/fft.rs:113-119)
    x = jnp.full((128,), 1.0 + 0j, dtype=cf32)
    p = plan(128, backend)
    out = p.bwd(p.fwd(x, Scale.SN) * 2.0, Scale.SN)
    assert_evm(out, jnp.full((128,), 2.0 + 0j, dtype=cf32), -72.0)


def test_plan_len_check():
    p = plan(128, "matmul")
    assert len(p) == 128
    with pytest.raises(ValueError, match="same length"):
        p.fwd(jnp.zeros((64,), dtype=cf32))


def test_plan_cache_identity():
    assert plan(256, "matmul") is plan(256, "matmul")


def test_mm_fft_large_and_odd_sizes():
    rng = np.random.default_rng(3)
    for n in [8192, 384, 1000, 2401]:  # 2401 = 7^4
        x = rand_c(rng, (2, n))
        got = mm_fft(jnp.asarray(x), -1)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        assert evm_db(got, ref) < -38, f"n={n}"
        assert evm_rms_db(got, ref) < -115, f"n={n}"


def test_mm_fft_prime_size_falls_back():
    rng = np.random.default_rng(4)
    n = 127  # prime, <= dense threshold: dense DFT
    x = rand_c(rng, (n,))
    assert evm_rms_db(mm_fft(jnp.asarray(x), -1), np.fft.fft(x.astype(np.complex128))) < -120


def test_factor_overrides():
    from aether_primitives_tpu.ops import fft as fft_mod

    # set_factor round-trip + validation
    fft_mod.set_factor(1024, 8)
    assert fft_mod._best_factor(1024) == 8
    fft_mod.set_factor(1024, None)
    with pytest.raises(ValueError):
        fft_mod.set_factor(1024, 7)
    # overridden factor changes the computation's factorization but not
    # its result
    rng = np.random.default_rng(50)
    x = (rng.normal(size=(4, 1024)) + 1j * rng.normal(size=(4, 1024))).astype(
        np.complex64
    )
    base = np.asarray(fft_mod.mm_fft(jnp.asarray(x), -1))
    fft_mod.set_factor(1024, 16)
    try:
        alt = np.asarray(fft_mod.mm_fft(jnp.asarray(x), -1))
    finally:
        fft_mod.set_factor(1024, None)
    assert np.allclose(base, alt, atol=2e-2)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    from aether_primitives_tpu.evm import evm_rms_db
    assert evm_rms_db(alt, ref) < -110


def test_dense_and_shallow_factor_overrides():
    """The autotuner's lane-layout candidates: shallow stage-1 factors
    (2/4 — stage-2 minor dim becomes a full 128 lanes) and the
    single-stage dense DFT (``n1 == n``) all compute the same transform."""
    from aether_primitives_tpu.evm import evm_rms_db
    from aether_primitives_tpu.ops import fft as fft_mod

    rng = np.random.default_rng(51)
    x = (rng.normal(size=(3, 512)) + 1j * rng.normal(size=(3, 512))).astype(
        np.complex64
    )
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    for n1 in (2, 4, 512):
        fft_mod.set_factor(512, n1)
        try:
            got = np.asarray(fft_mod.mm_fft(jnp.asarray(x), -1))
        finally:
            fft_mod.set_factor(512, None)
        assert evm_rms_db(got, ref) < -110, n1
    # the dense override is capped: O(n^2) matmuls above _DENSE_MAX are
    # never worth it and the matrix itself would be 512 MB+
    with pytest.raises(ValueError):
        fft_mod.set_factor(8192, 8192)
