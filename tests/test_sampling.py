"""Resampling tests — the reference's exact ramp/decimation vectors
(reference src/sampling.rs:64-170)."""

import numpy as np
import pytest

from aether_primitives_tpu.ops import sampling


def cvec(vals):
    return np.asarray([complex(v, v) for v in vals], dtype=np.complex64)


def test_interpolate_2_between():
    src = cvec([0, 3, 6, 9])
    out = np.asarray(sampling.interpolate(src, 2))
    check = cvec([0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
    assert len(out) == len(src) + (len(src) - 1) * 2
    assert (out == check).all()


def test_interpolate_1_between():
    src = cvec([0, 2, 4, 6])
    out = np.asarray(sampling.interpolate(src, 1))
    assert (out == cvec([0, 1, 2, 3, 4, 5, 6])).all()


def test_interpolate_imaginary_uses_im_base():
    # the deliberate fix of the reference's im-ramp bug (src/sampling.rs:19):
    # a signal with re != im must interpolate both components independently
    src = np.array([0 + 10j, 2 + 12j], np.complex64)
    out = np.asarray(sampling.interpolate(src, 1))
    assert (out == np.array([0 + 10j, 1 + 11j, 2 + 12j], np.complex64)).all()


def test_interpolate_zero_between_is_identity():
    src = cvec([1, 2, 3])
    assert (np.asarray(sampling.interpolate(src, 0)) == src).all()


def test_downsample_21_v_7():
    src = np.arange(21).astype(np.complex64)
    out = np.asarray(sampling.downsample(src, 7))
    assert (out == (np.arange(7) * 3).astype(np.complex64)).all()


def test_downsample_16_v_4():
    src = np.arange(16).astype(np.complex64)
    out = np.asarray(sampling.downsample(src, 4))
    assert (out == (np.arange(4) * 4).astype(np.complex64)).all()


def test_downsample_7_v_3_fails():
    with pytest.raises(ValueError, match="even decimations"):
        sampling.downsample(np.zeros(7, np.complex64), 3)


def test_downsample_by_factor():
    src = np.arange(12).astype(np.complex64)
    assert (np.asarray(sampling.downsample_by(src, 3)) == src[::3]).all()
    with pytest.raises(ValueError):
        sampling.downsample_by(np.zeros(7, np.complex64), 3)


def test_batched():
    src = np.stack([np.arange(16), np.arange(16) + 100]).astype(np.complex64)
    out = np.asarray(sampling.downsample(src, 4))
    assert out.shape == (2, 4)
    up = np.asarray(sampling.interpolate(src, 1))
    assert up.shape == (2, 31)


def test_resample_fft_vs_scipy():
    pytest.importorskip("scipy")
    from scipy import signal

    from aether_primitives_tpu.evm import evm_rms_db
    from aether_primitives_tpu.ops.sampling import resample_fft

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 512)) + 1j * rng.normal(size=(2, 512))).astype(
        np.complex64
    )
    for out_len in (1024, 256, 384, 511, 513):
        got = np.asarray(resample_fft(x, out_len))
        ref = signal.resample(x.astype(np.complex128), out_len, axis=-1)
        assert evm_rms_db(got, ref) < -120, out_len


def test_resample_fft_identity():
    from aether_primitives_tpu.ops.sampling import resample_fft

    x = np.arange(16).astype(np.complex64)
    assert (np.asarray(resample_fft(x, 16)) == x).all()


def test_resample_fft_roundtrip_bandlimited():
    # up 2x then back down recovers a bandlimited signal exactly
    from aether_primitives_tpu.evm import evm_rms_db
    from aether_primitives_tpu.ops.sampling import resample_fft

    rng = np.random.default_rng(1)
    spec = np.zeros(256, np.complex128)
    spec[:40] = rng.normal(size=40) + 1j * rng.normal(size=40)
    spec[-40:] = rng.normal(size=40) + 1j * rng.normal(size=40)
    x = np.fft.ifft(spec).astype(np.complex64)
    up = resample_fft(x, 512)
    back = np.asarray(resample_fft(up, 256))
    assert evm_rms_db(back, x.astype(np.complex128)) < -110


def test_dense_decimate_matches_strided():
    # the matmul formulation must equal the strided slice exactly
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(30)
    for n, out_len in [(30720, 1024), (8096, 506), (4096, 1024), (120, 30)]:
        x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))).astype(
            np.complex64
        )
        a = np.asarray(sampling.downsample(x, out_len, dense=True))
        b = np.asarray(sampling.downsample(x, out_len, dense=False))
        assert a.shape == b.shape == (3, out_len)
        assert np.array_equal(a, b), (n, out_len)
    # real dtype path
    xr = rng.normal(size=1024).astype(np.float32)
    assert np.array_equal(
        np.asarray(sampling.downsample(xr, 256, dense=True)),
        np.asarray(sampling.downsample(xr, 256, dense=False)),
    )
    # downsample_by routes through the same platform-aware path
    assert np.array_equal(
        np.asarray(sampling.downsample_by(xr, 4, dense=True)), xr[::4]
    )


def test_dense_interpolate_matches_broadcast():
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(31)
    for n, between in [(1024, 4), (2048, 4), (400, 3), (129, 2), (9, 5)]:
        x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(
            np.complex64
        )
        a = np.asarray(sampling.interpolate(x, between, dense=True))
        b = np.asarray(sampling.interpolate(x, between, dense=False))
        assert a.shape == b.shape == (2, n + (n - 1) * between)
        assert np.allclose(a, b, atol=2e-6), (n, between)
        # exact at the source points and the final sample
        assert np.array_equal(a[..., :: between + 1][..., : n - 1], x[..., :-1])
        assert np.array_equal(a[..., -1], x[..., -1])


# ---- rational Farrow resampler -----------------------------------------------


def test_resample_poly_identity_and_gcd(rng):
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    assert (np.asarray(sampling.resample_poly(x, 4, 4)) == x).all()
    a = np.asarray(sampling.resample_poly(x, 6, 4))
    b = np.asarray(sampling.resample_poly(x, 3, 2))
    assert (a == b).all()


def test_resample_poly_cubic_exactness():
    # cubic interpolation reproduces a degree-3 polynomial exactly
    n = 128
    t = np.arange(n, dtype=np.float64)
    poly = 0.3 + 0.02 * t - 1e-4 * t**2 + 5e-7 * t**3
    x = poly.astype(np.complex64)
    p, q = 7, 4
    y = np.asarray(sampling.resample_poly(x, p, q))
    m = np.arange(y.size, dtype=np.float64)
    tt = m * q / p
    want = 0.3 + 0.02 * tt - 1e-4 * tt**2 + 5e-7 * tt**3
    inner = (tt >= 1) & (tt <= n - 3)  # skip zero-padded edges
    err = np.abs(y.real[inner] - want[inner])
    assert err.max() < 1e-5


def test_resample_poly_tone_frequency_scales(rng):
    p, q = 160, 147  # classic audio SRC ratio
    n = q * 28  # divisible by q
    f = 0.03
    x = np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)
    y = np.asarray(sampling.resample_poly(x, p, q))
    assert y.size == n * p // q
    core = y[64:-64]
    spec = np.abs(np.fft.fft(core * np.hanning(core.size)))  # window kills
    k = spec.argmax()                                        # leakage skirts
    f_out = k / spec.size
    assert abs(f_out - f * q / p) < 1.0 / spec.size
    # image/spur floor of cubic interp on an oversampled tone
    spur = np.delete(spec, np.arange(k - 3, k + 4)).max()
    assert 20 * np.log10(spur / spec[k]) < -50


def test_resample_poly_matches_fft_resampler_on_oversampled_signal(rng):
    from aether_primitives_tpu.ops import fir as fir_mod

    n = 2048
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    # heavily oversample so cubic error is small: lowpass to 1/8 band
    lp = np.real(fir_mod.rrc_taps(8, span=8, beta=0.3)).astype(np.complex64)
    x = np.asarray(fir_mod.fir_filter(x, lp))
    p, q = 3, 2
    got = np.asarray(sampling.resample_poly(x, p, q))
    ref = np.asarray(sampling.resample_fft(x, n * p // q))
    inner = slice(32, got.size - 32)
    err = np.sqrt(np.mean(np.abs(got[inner] - ref[inner]) ** 2)
                  / np.mean(np.abs(ref[inner]) ** 2))
    assert err < 0.02, err


def test_resample_poly_rejects_bad_length(rng):
    x = np.zeros(100, np.complex64)
    with pytest.raises(ValueError, match="divisible"):
        sampling.resample_poly(x, 3, 7)


# ---- anti-aliased decimate ------------------------------------------------------


def test_decimate_passband_tone_preserved():
    from aether_primitives_tpu.ops.sampling import decimate

    n, dec = 8192, 4
    f = 0.02  # well inside the decimated passband
    t = np.arange(n)
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    y = np.asarray(decimate(x, dec))
    assert y.shape == (n // dec,)
    # steady state: the tone survives at dec*f cycles/sample, unit amplitude
    core = y[200:-10]
    ref = np.exp(2j * np.pi * f * dec * (t[: len(core)] ))
    # compare magnitudes and tone frequency via correlation with the ideal
    amp = np.abs(core).mean()
    assert abs(amp - 1.0) < 0.01
    corr = np.abs(np.vdot(core / np.abs(core), ref / np.abs(ref))) / len(core)
    assert corr > 0.999


def test_decimate_alias_rejected():
    from aether_primitives_tpu.ops.sampling import decimate, downsample_by

    n, dec = 8192, 4
    # a tone ABOVE the decimated Nyquist: raw downsample aliases it in at
    # full strength; decimate() kills it by >= ~55 dB
    f = 0.2
    t = np.arange(n)
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    raw = np.asarray(downsample_by(x, dec))
    flt = np.asarray(decimate(x, dec, atten_db=60.0))
    assert np.abs(raw[50:]).mean() > 0.99  # alias at full strength
    assert 20 * np.log10(np.abs(flt[200:]).mean() + 1e-12) < -55


def test_decimate_factor_one_and_validation(rng):
    from aether_primitives_tpu.ops.sampling import decimate

    x = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    assert np.allclose(np.asarray(decimate(x, 1)), x)
    with pytest.raises(ValueError, match="cutoff"):
        decimate(x, 4, cutoff=1.5)
    with pytest.raises(ValueError, match="factor"):
        decimate(x, 0)
