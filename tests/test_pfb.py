"""Polyphase filterbank channelizer tests.

Golden is the direct causal WOLA formula in float64:
``y[t, c] = sum_{p, r} h[p*M + r] x[(t-p)*M + r] e^{-2 pi i c r / M}``
(zeros for t < p) — the branch decomposition the implementation
factorizes into P slab multiplies + one batched matmul FFT. P=1 with unit
taps must reproduce the reference's plain chunked FFT (waterfall core,
reference src/util/plot.rs:59-62).
"""

import numpy as np
import pytest

from aether_primitives_tpu.evm import evm_rms_db
from aether_primitives_tpu.models.channelizer import (
    PfbChannelizer,
    pfb_channelize,
    pfb_prototype,
    pfb_spectra,
    waterfall_spectra,
)
from aether_primitives_tpu.ops.fft import Scale


def rand_c(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )


def _direct_pfb(x, h, m):
    """f64 golden: causal branch-filter + DFT across branches."""
    x = x.astype(np.complex128)
    h = h.astype(np.complex128)
    p = -(-h.shape[-1] // m)
    h = np.pad(h, (0, p * m - h.shape[-1]))
    t_frames = -(-x.shape[-1] // m)
    x = np.pad(x, (0, t_frames * m - x.shape[-1]))
    fr = x.reshape(t_frames, m)
    hb = h.reshape(p, m)
    u = np.zeros((t_frames, m), np.complex128)
    for t in range(t_frames):
        for pi in range(p):
            if t - pi >= 0:
                u[t] += hb[pi] * fr[t - pi]
    return np.fft.fft(u, axis=-1)


def test_pfb_matches_f64_direct():
    rng = np.random.default_rng(30)
    m, p = 32, 4
    x = rand_c(rng, m * 10 - 7)  # ragged tail exercises the zero pad
    h = pfb_prototype(m, p)
    got = np.asarray(pfb_channelize(x, m, taps=h))
    ref = _direct_pfb(x, h, m)
    assert got.shape == (10, m)
    assert evm_rms_db(got, ref) < -110


def test_pfb_arbitrary_complex_taps_and_batch():
    rng = np.random.default_rng(31)
    m, p = 16, 3
    x = rand_c(rng, (2, m * 8))
    h = (0.3 * rand_c(rng, p * m)).astype(np.complex64)
    got = np.asarray(pfb_channelize(x, m, taps=h))
    ref = np.stack([_direct_pfb(row, h, m) for row in x])
    assert evm_rms_db(got, ref) < -110


def test_pfb_p1_unit_taps_is_plain_chunked_fft():
    # rectangular-window degenerate case == the reference waterfall core
    rng = np.random.default_rng(32)
    m = 64
    x = rand_c(rng, m * 6)
    got = np.asarray(
        pfb_channelize(x, m, taps=np.ones(m, np.complex64), scale=Scale.SN)
    )
    ref = np.fft.fft(
        x.astype(np.complex128).reshape(6, m), axis=-1
    ) / np.sqrt(np.float64(m))
    assert evm_rms_db(got, ref) < -120


def test_pfb_spectra_matches_waterfall_for_rect():
    rng = np.random.default_rng(33)
    m = 32
    x = rand_c(rng, m * 5)
    a = np.asarray(pfb_spectra(x, m, taps=np.ones(m, np.complex64)))
    b = np.asarray(waterfall_spectra(x, m))
    assert np.allclose(a, b, atol=1e-5)


def test_pfb_history_stitches_blocks():
    rng = np.random.default_rng(34)
    m, p = 16, 4
    x = rand_c(rng, m * 12)
    h = pfb_prototype(m, p)
    whole = np.asarray(pfb_channelize(x, m, taps=h))
    half = m * 6
    a = np.asarray(pfb_channelize(x[:half], m, taps=h))
    b = np.asarray(
        pfb_channelize(
            x[half:], m, taps=h, history=x[half - (p - 1) * m : half]
        )
    )
    assert evm_rms_db(np.concatenate([a, b]), whole.astype(np.complex128)) < -120


def test_pfb_channelizer_stage_is_stateful():
    rng = np.random.default_rng(35)
    m, p = 16, 4
    x = rand_c(rng, m * 12)
    whole = np.asarray(pfb_channelize(x, m, taps=pfb_prototype(m, p)))
    st = PfbChannelizer(m, taps_per_branch=p)
    got = np.concatenate(
        [np.asarray(st.step(x[: m * 6])), np.asarray(st.step(x[m * 6 :]))]
    )
    assert evm_rms_db(got, whole.astype(np.complex128)) < -120


def test_pfb_channel_isolation_beats_rectangle():
    # a tone centered between channels leaks everywhere through a
    # rectangle's -13 dB sinc sidelobes; the prototype skirt must cut the
    # far-channel leakage by >= 30 dB relative to that
    m = 64
    t = np.arange(m * 64)
    f = (3 + 0.5) / m  # half-way between channels 3 and 4 (worst case)
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    rect = np.abs(
        np.asarray(pfb_channelize(x, m, taps=np.ones(m, np.complex64)))
    )[8:]
    pfb = np.abs(np.asarray(pfb_channelize(x, m, taps_per_branch=8)))[8:]
    far = [c for c in range(m) if min(abs(c - 3), abs(c - 4)) > 4]
    rect_leak = rect[:, far].max() / rect.max()
    pfb_leak = pfb[:, far].max() / pfb.max()
    assert 20 * np.log10(pfb_leak / rect_leak) < -30


def test_pfb_history_length_validated():
    with pytest.raises(ValueError, match="history"):
        pfb_channelize(
            np.zeros(64, np.complex64), 16, taps_per_branch=4,
            history=np.zeros(5, np.complex64),
        )


def test_sharded_pfb_matches_single(eight_devices):
    from aether_primitives_tpu.models.channelizer import sharded_pfb
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    rng = np.random.default_rng(36)
    m, p = 16, 4
    x = rand_c(rng, 8 * m * 4)  # 4 frames per device
    mesh = mesh_mod.make_mesh({"time": 8})
    single = np.asarray(pfb_channelize(x, m, taps_per_branch=p))
    shard = np.asarray(sharded_pfb(x, m, mesh, taps_per_branch=p))
    assert (single == shard).all()


# ---------------------------------------------------------------- synthesis


def _direct_synth(y, g, m):
    """f64 golden: per-frame inverse DFT then branch overlap-add."""
    y = y.astype(np.complex128)
    g = g.astype(np.complex128)
    q = -(-g.shape[-1] // m)
    g = np.pad(g, (0, q * m - g.shape[-1]))
    gb = g.reshape(q, m)
    t_frames = y.shape[0]
    v = np.fft.ifft(y, axis=-1)  # Scale.N convention
    out = np.zeros(((t_frames + q - 1) * m,), np.complex128)
    for t in range(t_frames):
        for p in range(q):
            out[(t + p) * m : (t + p + 1) * m] += gb[p] * v[t]
    return out


def test_pfb_synthesize_matches_f64_direct():
    from aether_primitives_tpu.models.channelizer import pfb_synthesize

    rng = np.random.default_rng(40)
    m, q = 32, 5
    y = rand_c(rng, (9, m))
    g = (0.5 * rand_c(rng, q * m)).astype(np.complex64)
    got = np.asarray(pfb_synthesize(y, m, taps=g))
    ref = _direct_synth(y, g, m)
    assert got.shape == ref.shape
    assert evm_rms_db(got, ref) < -110


def test_pfb_synthesize_rect_inverts_chunked_fft():
    # Q=1 unit taps with Scale.N inverts the plain chunked FFT exactly
    from aether_primitives_tpu.models.channelizer import pfb_synthesize

    rng = np.random.default_rng(41)
    m = 64
    x = rand_c(rng, m * 7)
    y = pfb_channelize(x, m, taps=np.ones(m, np.complex64))
    back = np.asarray(pfb_synthesize(y, m))
    assert evm_rms_db(back, x.astype(np.complex128)) < -120


def test_pfb_roundtrip_ls_synthesis():
    # analysis prototype -> least-squares synthesis inverse -> delayed
    # reconstruction. Exact FIR PR is structurally impossible for a
    # critically sampled DFT bank with a nontrivial prototype (branch
    # zeros sit near |z|=1), so the contract is the measured LS floor:
    # <= -30 dB RMS at the default Q = 8P (see pfb_synthesis_taps docs).
    from aether_primitives_tpu.models.channelizer import (
        pfb_synthesis_taps,
        pfb_synthesize,
    )

    rng = np.random.default_rng(42)
    m, p = 16, 4
    h = pfb_prototype(m, p)
    g = pfb_synthesis_taps(h, m)
    q = -(-g.shape[-1] // m)
    assert q == 8 * p
    d = (p + q - 2) // 2
    x = rand_c(rng, m * 128)
    y = pfb_channelize(x, m, taps=h)
    back = np.asarray(pfb_synthesize(y, m, taps=g))
    got = back[d * m : d * m + x.shape[-1]]
    # edges see the cold-start/tail transient; judge the interior
    core = slice(q * m, -q * m)
    err = evm_rms_db(got[core], x[core].astype(np.complex128))
    assert err < -30, err
    # and quality must improve monotonically with Q
    g2 = pfb_synthesis_taps(h, m, taps_per_branch=2 * p)
    d2 = (p + 2 * p - 2) // 2
    back2 = np.asarray(pfb_synthesize(y, m, taps=g2))
    got2 = back2[d2 * m : d2 * m + x.shape[-1]]
    err2 = evm_rms_db(got2[core], x[core].astype(np.complex128))
    assert err < err2, (err, err2)


def test_pfb_synthesizer_streams_like_one_shot():
    from aether_primitives_tpu.models.channelizer import (
        PfbSynthesizer,
        pfb_synthesize,
    )

    rng = np.random.default_rng(43)
    m, q = 16, 3
    g = (0.5 * rand_c(rng, q * m)).astype(np.complex64)
    y = rand_c(rng, (12, m))
    whole = np.asarray(pfb_synthesize(y, m, taps=g))
    st = PfbSynthesizer(m, taps=g)
    a = np.asarray(st.step(y[:5]))
    b = np.asarray(st.step(y[5:]))
    tail = np.asarray(st.flush())
    got = np.concatenate([a, b, tail])
    assert evm_rms_db(got, whole.astype(np.complex128)) < -120


def test_pfb_synthesizer_rejects_short_block():
    from aether_primitives_tpu.models.channelizer import PfbSynthesizer

    st = PfbSynthesizer(8, taps=np.ones(8 * 4, np.float32))
    with pytest.raises(ValueError, match="Q-1"):
        st.step(np.zeros((2, 8), np.complex64))


# ---- Welch PSD --------------------------------------------------------------


def test_welch_psd_matches_scipy(rng):
    scipy_signal = pytest.importorskip("scipy.signal")
    from aether_primitives_tpu.models.channelizer import welch_psd

    x = (rng.normal(size=1 << 14) + 1j * rng.normal(size=1 << 14)).astype(
        np.complex64
    )
    f_ref, p_ref = scipy_signal.welch(
        x, fs=2.5, window="hann", nperseg=512, noverlap=256,
        detrend=False, return_onesided=False, scaling="density",
    )
    f_got, p_got = welch_psd(x, 512, hop=256, window="hann", fs=2.5)
    assert np.allclose(f_got, f_ref)
    assert np.allclose(np.asarray(p_got), p_ref, rtol=2e-4, atol=1e-6)


def test_welch_psd_tone_power():
    from aether_primitives_tpu.models.channelizer import welch_psd

    n, fft_len = 1 << 14, 1024
    t = np.arange(n)
    x = np.exp(2j * np.pi * (200 / fft_len) * t).astype(np.complex64)
    freqs, psd = welch_psd(x, fft_len, shift=True)
    psd = np.asarray(psd)
    k = psd.argmax()
    assert abs(freqs[k] - 200 / fft_len) < 1e-9
    # a unit tone's PSD integrates to ~1 (density * df)
    assert abs(psd.sum() / fft_len - 1.0) < 1e-2


def test_welch_psd_batched_and_short_raises(rng):
    from aether_primitives_tpu.models.channelizer import welch_psd

    x = (rng.normal(size=2 * 4096) + 1j * rng.normal(size=2 * 4096)).astype(
        np.complex64
    ).reshape(2, 4096)
    _, psd = welch_psd(x, 256)
    assert np.asarray(psd).shape == (2, 256)
    with pytest.raises(ValueError, match="shorter"):
        welch_psd(x[0, :100], 256)


# ---------------------------------------------------------------- STFT / iSTFT


@pytest.mark.parametrize(
    "hop,window", [(None, "sqrt_hann"), (64, "hann"), (128, "sqrt_hann"), (256, "rect")]
)
def test_stft_istft_roundtrip_exact(hop, window):
    from aether_primitives_tpu.models.channelizer import istft, stft

    rng = np.random.default_rng(5)
    x = rand_c(rng, 5000)
    s = stft(x, 256, hop=hop, window=window)
    y = np.asarray(istft(s, hop=hop, window=window, length=5000))
    assert evm_rms_db(y, x.astype(np.complex128)) < -120


def test_stft_tone_lands_in_bin():
    from aether_primitives_tpu.models.channelizer import stft

    n, m = 4096, 256
    k = 32
    x = np.exp(2j * np.pi * k / m * np.arange(n)).astype(np.complex64)
    s = np.asarray(stft(x, m))
    mid = s[4:-4]  # interior frames
    assert (np.abs(mid).argmax(axis=-1) == k).all()


def test_stft_istft_batched(rng):
    from aether_primitives_tpu.models.channelizer import istft, stft

    x = rand_c(rng, (3, 2000))
    s = stft(x, 128)
    assert s.shape[:-2] == (3,)
    y = np.asarray(istft(s, length=2000))
    assert y.shape == (3, 2000)
    assert evm_rms_db(y, x.astype(np.complex128)) < -120


def test_stft_spectral_masking_removes_tone(rng):
    # the use case: mask an interferer in the STFT domain, resynthesize
    from aether_primitives_tpu.models.channelizer import istft, stft

    n, m, k = 8192, 256, 40
    sig = (0.1 * rand_c(rng, n)).astype(np.complex64)
    tone = np.exp(2j * np.pi * (k / m) * np.arange(n)).astype(np.complex64)
    s = np.asarray(stft(sig + tone, m)).copy()
    s[..., k - 1 : k + 2] = 0  # notch the interferer bins
    y = np.asarray(istft(s, length=n))
    # interferer suppressed by > 20 dB; the noise floor survives
    res = y - sig
    assert np.linalg.norm(res[500:-500]) < 0.1 * np.linalg.norm(tone[500:-500])


def test_istft_rejects_non_divisor_hop_and_nola():
    from aether_primitives_tpu.models.channelizer import istft, stft

    with pytest.raises(ValueError, match="multiple of hop"):
        stft(np.zeros(512, np.complex64), 256, hop=96)
    # hop == fft_len with a tapered window: zero weight inside frames
    s = stft(np.zeros(2048, np.complex64), 256, hop=256, window="hann")
    with pytest.raises(ValueError, match="NOLA"):
        istft(s, hop=256, window="hann")


# ------------------------------------------------------- oversampled PFB


def test_pfb_os_matches_f64_golden():
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        pfb_prototype_nyquist,
    )

    rng = np.random.default_rng(50)
    m, os_, p = 8, 2, 3
    hop = m // os_
    x = rand_c(rng, 100)
    h = np.asarray(pfb_prototype_nyquist(m, p)).astype(np.float64)
    y = np.asarray(pfb_channelize_os(x, m, os=os_, taps=h))
    t_frames = y.shape[0]
    pm = -(-len(h) // m) * m
    hh = np.pad(h, (0, pm - len(h)))
    xx = np.pad(x.astype(np.complex128), (0, (t_frames - 1) * hop + pm - len(x)))
    ref = np.zeros((t_frames, m), np.complex128)
    mm = np.arange(pm)
    for t in range(t_frames):
        for k in range(m):
            ref[t, k] = np.sum(
                hh * xx[t * hop + mm] * np.exp(-2j * np.pi * k * (t * hop + mm) / m)
            )
    assert evm_rms_db(y, ref) < -110


def test_pfb_os1_equals_critically_sampled_shifted():
    # os=1: the same filterbank in the forward (WOLA) convention — equals
    # the causal pfb_channelize with the BRANCH-REVERSED prototype,
    # delayed by P-1 frames (convolution vs correlation along frames)
    from aether_primitives_tpu.models.channelizer import pfb_channelize_os

    rng = np.random.default_rng(51)
    m, p = 16, 4
    h = pfb_prototype(m, p)
    h_rev = np.asarray(h).reshape(p, m)[::-1].reshape(-1)
    x = rand_c(rng, m * 40)
    a = np.asarray(pfb_channelize(x, m, taps=h_rev))       # causal, T rows
    b = np.asarray(pfb_channelize_os(x, m, os=1, taps=h))  # forward
    ncmp = b.shape[0] - (p - 1)
    assert evm_rms_db(b[:ncmp], a[p - 1 : p - 1 + ncmp].astype(np.complex128)) < -120


def test_pfb_os2_near_perfect_reconstruction():
    # matched root-Nyquist cascade at os=2 beats the critically sampled
    # bank's structural -35 dB limit by a wide margin
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        pfb_synthesize_os,
    )

    rng = np.random.default_rng(52)
    n, m = 30000, 64
    x = rand_c(rng, n)
    y = pfb_channelize_os(x, m, os=2)
    back = np.asarray(pfb_synthesize_os(y, m, os=2, length=n))
    core = slice(2 * m * 16, n - 2 * m * 16)
    assert evm_rms_db(back[core], x[core].astype(np.complex128)) < -70


def test_pfb_os_channel_extraction_and_isolation():
    from aether_primitives_tpu.models.channelizer import pfb_channelize_os

    m, k = 32, 5
    n = m * 200
    tone = np.exp(2j * np.pi * (k / m) * np.arange(n)).astype(np.complex64)
    y = np.asarray(pfb_channelize_os(tone, m, os=2))
    mid = y[50:-50]
    # tone lands in channel k, downconverted to DC (flat phase)
    own = mid[:, k]
    assert np.abs(own).std() < 0.01 * np.abs(own).mean()
    assert np.abs(np.diff(np.angle(own))).max() < 1e-2
    # neighbor and far channels suppressed
    far = np.abs(mid[:, (k + 7) % m]).mean()
    assert far < 1e-3 * np.abs(own).mean()


def test_pfb_os_batched_and_validation(rng):
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        pfb_synthesize_os,
    )

    x = rand_c(rng, (2, 4000))
    y = pfb_channelize_os(x, 16, os=2, taps_per_branch=4)
    assert y.shape[0] == 2 and y.shape[-1] == 16
    back = np.asarray(pfb_synthesize_os(y, 16, os=2, taps_per_branch=4, length=4000))
    assert back.shape == (2, 4000)
    with pytest.raises(ValueError, match="os must divide"):
        pfb_channelize_os(x, 16, os=3)
    with pytest.raises(ValueError, match="os must divide"):
        pfb_synthesize_os(y, 16, os=5)


def test_pfb_os_streaming_matches_one_shot(rng):
    from aether_primitives_tpu.models.channelizer import (
        PfbChannelizerOs,
        PfbSynthesizerOs,
        pfb_channelize_os,
        pfb_synthesize_os,
    )

    m, os_ = 16, 2
    n = m * 80
    x = rand_c(rng, n)
    whole = np.asarray(pfb_channelize_os(x, m, os=os_, taps_per_branch=4))
    st = PfbChannelizerOs(m, os=os_, taps_per_branch=4)
    blocks = [x[: m * 30], x[m * 30 : m * 55], x[m * 55 :]]
    got = np.concatenate([np.asarray(st.step(b)) for b in blocks], axis=0)
    assert evm_rms_db(got, whole[: got.shape[0]].astype(np.complex128)) < -120

    # synthesis streaming == one-shot interior
    whole_e = whole[: whole.shape[0] - (whole.shape[0] % os_)]
    syn_whole = np.asarray(pfb_synthesize_os(whole_e, m, os=os_, taps_per_branch=4))
    sy = PfbSynthesizerOs(m, os=os_, taps_per_branch=4)
    t = whole_e.shape[0]
    t1 = (t // 2) - ((t // 2) % os_)
    a = np.asarray(sy.step(whole_e[:t1]))
    b = np.asarray(sy.step(whole_e[t1:]))
    tail = np.asarray(sy.flush())
    got_s = np.concatenate([a, b, tail])
    # edges use different (edge-aware vs periodic) normalization — judge
    # the interior, which matches exactly
    pm = 4 * m
    core = slice(2 * pm, min(len(got_s), len(syn_whole)) - 2 * pm)
    assert evm_rms_db(got_s[core], syn_whole[core].astype(np.complex128)) < -110


def test_pfb_os_streaming_roundtrip_through_stages(rng):
    # analysis stage -> synthesis stage over blocks reconstructs the input
    from aether_primitives_tpu.models.channelizer import (
        PfbChannelizerOs,
        PfbSynthesizerOs,
    )

    m = 32
    n = m * 200
    x = rand_c(rng, n)
    ana = PfbChannelizerOs(m, os=2)
    syn = PfbSynthesizerOs(m, os=2)
    outs = []
    for i in range(4):
        blk = x[i * (n // 4) : (i + 1) * (n // 4)]
        outs.append(np.asarray(syn.step(ana.step(blk))))
    outs.append(np.asarray(syn.flush()))
    back = np.concatenate(outs)
    # back lags x by ~the prototype span; find best lag and compare core
    pm = 16 * m
    core = np.arange(2 * pm, n - 3 * pm)
    best = 0
    for lag in range(0, 2 * pm, m // 2):
        if core[-1] + lag >= len(back):
            continue
        seg = back[core + lag]
        ref = x[core]
        num = np.abs(np.vdot(seg, ref))
        den = np.linalg.norm(seg) * np.linalg.norm(ref)
        if den and num / den > best:
            best = num / den
    assert best > 0.9997, best


def test_pfb_os_stream_block_too_short():
    from aether_primitives_tpu.models.channelizer import PfbChannelizerOs

    st = PfbChannelizerOs(16, os=2, taps_per_branch=4)
    with pytest.raises(ValueError, match="block too short"):
        st.step(np.zeros(32, np.complex64))


def test_sharded_pfb_os_matches_single(eight_devices):
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        sharded_pfb_os,
    )
    from aether_primitives_tpu.parallel import mesh as mesh_mod

    rng = np.random.default_rng(37)
    m, p = 16, 4  # prototype spans 2p+1 = 9 branches -> halo 136 samples
    x = rand_c(rng, 8 * m * 12)  # span 192 >= halo per device
    mesh = mesh_mod.make_mesh({"time": 8})
    single = np.asarray(pfb_channelize_os(x, m, os=2, taps_per_branch=p))
    shard = np.asarray(sharded_pfb_os(x, m, mesh, os=2, taps_per_branch=p))
    # sharded emits n/hop frames (zero-extended capture end); the one-shot
    # emits the frames whose windows fit the padded capture — a prefix
    t = single.shape[0]
    assert shard.shape[0] >= t
    assert (shard[:t] == single).all()
    assert (np.abs(shard[t:]) >= 0).all()  # tail frames finite
    # undersized spans are rejected loudly, not silently truncated
    with pytest.raises(ValueError, match="span"):
        sharded_pfb_os(rand_c(rng, 8 * m * 6), m, mesh, os=2, taps_per_branch=p)


def _np_pfb_os_analysis(x, h, m, os_):
    """float64 oversampled analysis straight from the definition:
    ``y[t, k] = sum_j h[j] x[t*hop + j] e^{-2 pi i k (t*hop + j)/M}`` over
    the zero-extended capture."""
    hop = m // os_
    h = np.asarray(h, np.complex128)
    n = x.shape[-1]
    t_frames = (n - h.size + hop - 1) // hop + 1
    xp = np.zeros((t_frames - 1) * hop + h.size, np.complex128)
    xp[:n] = x
    k = np.arange(m)[:, None]
    j = np.arange(h.size)[None, :]
    out = np.empty((t_frames, m), np.complex128)
    for t in range(t_frames):
        ph = np.exp(-2j * np.pi * k * (t * hop + j) / m)
        out[t] = ph @ (h * xp[t * hop : t * hop + h.size])
    return out


def _np_pfb_os_synthesis(y, h, m, os_, length):
    """float64 matched-WOLA synthesis from the definition:
    ``out[t*hop + j] += h[j] * w[t, (t*hop + j) mod M]`` with ``w`` the
    1/M-scaled inverse DFT of each frame, divided by the overlap-add of
    ``|h|^2``."""
    hop = m // os_
    h = np.asarray(h, np.complex128)
    w = np.fft.ifft(np.asarray(y, np.complex128), axis=-1)
    out = np.zeros(length + h.size, np.complex128)
    den = np.zeros(length + h.size)
    j = np.arange(h.size)
    for t in range(w.shape[0]):
        out[t * hop + j] += h * w[t, (t * hop + j) % m]
        den[t * hop + j] += np.abs(h) ** 2
    den = np.where(den <= 1e-10 * den.max(), 1.0, den)
    return (out / den)[:length]


def _rel(got, ref):
    return np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2))


@pytest.mark.parametrize("m, os_, p, n", [
    (256, 2, 8, 256 * 40 + 13),
    (128, 4, 4, 128 * 37),
])
def test_pfb_os_fold_matches_f64_reference(rng, m, os_, p, n):
    """The XLA slice fold of the oversampled analysis bank against a
    float64 evaluation of its defining sum."""
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        pfb_prototype_nyquist,
    )

    h = pfb_prototype_nyquist(m, p)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    got = np.asarray(pfb_channelize_os(x, m, os=os_, taps=h))
    ref = _np_pfb_os_analysis(x, np.pad(h, (0, -h.size % m)), m, os_)
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5, (m, os_, _rel(got, ref))


def test_pfb_os_pallas_roundtrip_floor(rng):
    """Analysis through the slice fold -> matched WOLA synthesis hits the
    root-Nyquist reconstruction floor (the -76 dB-class gate that guards
    the os bank's purpose)."""
    from aether_primitives_tpu.models.channelizer import (
        pfb_channelize_os,
        pfb_synthesize_os,
    )

    m = 64
    n = 30000
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    y = pfb_channelize_os(x, m, os=2)
    back = np.asarray(pfb_synthesize_os(y, m, os=2, length=n))
    core = slice(2 * m * 16, n - 2 * m * 16)
    err = back[core] - np.asarray(x)[core].astype(np.complex128)
    db = 10 * np.log10(
        np.mean(np.abs(err) ** 2) / np.mean(np.abs(x[core]) ** 2)
    )
    assert db < -70, db


def test_pfb_os_synthesis_matches_f64_reference(rng):
    """The XLA per-class overlap-add of the matched-WOLA synthesis against
    a float64 evaluation of its defining sum and normalization."""
    from aether_primitives_tpu.models.channelizer import (
        pfb_prototype_nyquist,
        pfb_synthesize_os,
    )

    m, os_, p = 256, 2, 8
    h = pfb_prototype_nyquist(m, p)
    hp = np.pad(h, (0, -h.size % m))
    y = rand_c(rng, (41, m))
    got = np.asarray(pfb_synthesize_os(y, m, os=os_, taps=h))
    ref = _np_pfb_os_synthesis(y, hp, m, os_, got.shape[-1])
    assert _rel(got, ref) < 1e-5, _rel(got, ref)


def test_pfb_synthesize_matches_f64_reference(rng):
    """The critically sampled synthesis slice-sum against a float64
    evaluation of ``x[(t+p)*M + r] += g[p*M + r] * ifft(y[t])[r]``."""
    from aether_primitives_tpu.models.channelizer import (
        pfb_synthesis_taps,
        pfb_synthesize,
    )

    m, p = 256, 4
    g = np.asarray(pfb_synthesis_taps(pfb_prototype(m, p), m), np.complex128)
    q = -(-g.size // m)
    gb = np.pad(g, (0, q * m - g.size)).reshape(q, m)
    y = rand_c(rng, (37, m))
    v = np.fft.ifft(y.astype(np.complex128), axis=-1)
    ref = np.zeros((y.shape[0] + q - 1) * m, np.complex128)
    for t in range(y.shape[0]):
        for pi in range(q):
            ref[(t + pi) * m : (t + pi + 1) * m] += gb[pi] * v[t]
    got = np.asarray(pfb_synthesize(y, m, taps=g.astype(np.complex64)))
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-5, _rel(got, ref)
