"""DOA estimation + beamforming: MUSIC/Capon bearing accuracy, MVDR
interference nulling, coherent-source spatial smoothing, steering-vector
identities. (New capability family — the reference has no array support;
contracts are the textbook identities plus planted-source recovery.)"""

import numpy as np
import pytest

from aether_primitives_tpu.models import doa


def _two_source_snapshots(rng, m=8, t_snap=512, deg=(-20.0, 25.0),
                          snr_db=10.0, coherent=False):
    t = np.arange(t_snap)
    x = np.zeros((m, t_snap), np.complex64)
    base = np.exp(2j * np.pi * 0.0137 * t)
    for i, d in enumerate(deg):
        a = np.asarray(doa.steering_vector(m, np.deg2rad(d)))
        if coherent:
            s = base * (0.9 if i else 1.0)
        else:
            s = np.exp(2j * np.pi * rng.uniform(0.01, 0.45) * t) * np.exp(
                1j * 2 * np.pi * rng.uniform()
            )
        x += a[:, None] * s[None, :]
    namp = 10 ** (-snr_db / 20)
    x += namp * (
        rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    ).astype(np.complex64) / np.sqrt(2)
    return x.astype(np.complex64)


def test_steering_vector_identities():
    a0 = np.asarray(doa.steering_vector(8, 0.0))
    assert np.allclose(a0, 1.0)  # broadside: no inter-element phase
    a = np.asarray(doa.steering_vector(8, 0.3))
    assert np.allclose(np.abs(a), 1.0, atol=1e-6)
    # conjugate symmetry: a(-theta) = conj(a(theta)) for a ULA
    am = np.asarray(doa.steering_vector(8, -0.3))
    assert np.allclose(am, np.conj(a), atol=1e-6)


@pytest.mark.parametrize("method,tol_deg", [("music", 0.5), ("capon", 1.0)])
def test_two_source_bearings(rng, method, tol_deg):
    x = _two_source_snapshots(rng)
    est = np.rad2deg(np.asarray(doa.estimate_doa(x, 2, method=method)))
    assert np.allclose(est, [-20.0, 25.0], atol=tol_deg), est


def test_music_resolves_close_sources(rng):
    # 6 degrees apart at 8 elements: inside a conventional beamwidth
    x = _two_source_snapshots(rng, deg=(10.0, 16.0), snr_db=15.0)
    est = np.rad2deg(np.asarray(doa.estimate_doa(x, 2, method="music")))
    assert np.allclose(est, [10.0, 16.0], atol=1.0), est


def test_mvdr_nulls_interferer(rng):
    x = _two_source_snapshots(rng)
    r = doa.covariance(x)
    w = np.asarray(doa.mvdr_weights(r, np.deg2rad(-20.0)))
    a0 = np.asarray(doa.steering_vector(8, np.deg2rad(-20.0)))
    a1 = np.asarray(doa.steering_vector(8, np.deg2rad(25.0)))
    g0 = abs(np.vdot(w, a0))
    g1 = abs(np.vdot(w, a1))
    assert abs(g0 - 1.0) < 1e-3  # distortionless toward the target
    assert 20 * np.log10(g1 / g0) < -25  # interferer nulled


def test_delay_and_sum_array_gain(rng):
    m = 8
    x = _two_source_snapshots(rng, m=m, deg=(0.0,), snr_db=0.0)
    y = np.asarray(doa.beamform(x, 0.0))
    # single-element SNR ~0 dB; coherent sum gives ~10*log10(M) gain
    sig = np.abs(np.mean(y * np.conj(np.exp(2j * np.pi * 0.0))))  # power proxy
    p_beam = np.mean(np.abs(y) ** 2)
    p_elem = np.mean(np.abs(x[0]) ** 2)
    # beam output keeps unit signal gain but averages noise down
    assert p_beam < p_elem  # noise suppressed
    del sig


def test_coherent_sources_need_smoothing(rng):
    x = _two_source_snapshots(rng, deg=(-20.0, 25.0), snr_db=20.0,
                              coherent=True)
    est_sm = np.rad2deg(
        np.asarray(doa.estimate_doa(x, 2, method="music", smoothing=3))
    )
    assert np.allclose(est_sm, [-20.0, 25.0], atol=1.5), est_sm


def test_batched_covariance_and_spectrum(rng):
    xs = np.stack([_two_source_snapshots(rng), _two_source_snapshots(rng)])
    r = doa.covariance(xs)
    assert r.shape == (2, 8, 8)
    ang, spec = doa.music_spectrum(r, 2)
    assert spec.shape == (2, ang.shape[0])


def test_steering_vector_pos_matches_ula():
    pos = np.stack([0.5 * np.arange(8), np.zeros(8)], axis=1)  # x-axis ULA
    a1 = np.asarray(doa.steering_vector(8, 0.3))
    a2 = np.asarray(doa.steering_vector_pos(pos, 0.3, 0.0))
    assert np.allclose(a1, a2, atol=1e-6)
    with pytest.raises(ValueError, match="positions"):
        doa.steering_vector_pos(np.zeros((4,)), 0.1)


def test_2d_music_l_array(rng):
    """A 9-element L-shaped (x-z) array separates azimuth AND elevation:
    two sources at distinct (az, el) recovered within the grid step."""
    px = np.stack([0.5 * np.arange(5), np.zeros(5), np.zeros(5)], axis=1)
    pz = np.stack(
        [np.zeros(4), np.zeros(4), 0.5 * np.arange(1, 5)], axis=1
    )
    pos3 = np.concatenate([px, pz])
    true_src = [
        (np.deg2rad(-15.0), np.deg2rad(10.0)),
        (np.deg2rad(30.0), np.deg2rad(-20.0)),
    ]
    T = 600
    t = np.arange(T)
    x = np.zeros((9, T), np.complex64)
    for az0, el0 in true_src:
        a = np.asarray(doa.steering_vector_pos(pos3, az0, el0))
        x += (
            a[:, None]
            * np.exp(2j * np.pi * rng.uniform(0.05, 0.45) * t)[None, :]
        )
    x += 0.2 * (
        rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    ).astype(np.complex64)
    est = np.rad2deg(
        np.asarray(doa.estimate_doa_2d(x.astype(np.complex64), 2, pos3))
    )
    want = np.rad2deg(np.asarray(sorted(true_src)))
    assert np.allclose(est, want, atol=2.5), (est, want)


def test_batched_scan_mode_matches_per_window(rng):
    # estimate_doa over [W, M, T] in one graph must
    # reproduce the per-window calls (every stage broadcasts)
    wins = np.stack([
        _two_source_snapshots(rng, deg=(-30.0 + 3 * w, 10.0 + 2 * w))
        for w in range(8)
    ])
    import jax as _jax

    batched = np.asarray(_jax.jit(
        lambda v: doa.estimate_doa(v, 2)
    )(wins))
    for w in range(8):
        single = np.asarray(doa.estimate_doa(wins[w], 2))
        assert np.allclose(batched[w], single, atol=1e-6), w


def test_sharded_estimate_doa_matches_single(rng, eight_devices):
    import jax as _jax

    from aether_primitives_tpu.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh({"channel": 8})
    wins = np.stack([
        _two_source_snapshots(rng, deg=(-40.0 + 5 * w, 5.0 + 4 * w))
        for w in range(16)
    ])
    sharded = np.asarray(doa.sharded_estimate_doa(wins, 2, mesh))
    single = np.asarray(doa.estimate_doa(wins, 2))
    assert np.allclose(sharded, single, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        doa.sharded_estimate_doa(wins[:3], 2, mesh)
