"""Synchronization + equalization: the full receiver against a realistic
channel (unknown delay, static multipath, AWGN) recovers exact bits."""

import numpy as np
import pytest

from aether_primitives_tpu.models import RxChain, RxChainConfig, TxChain, loopback_delay
from aether_primitives_tpu.models.sync import OfdmEqualizer, detect_preamble
from aether_primitives_tpu.ops import modulation, noise, sequence


def test_detect_preamble_exact_offset(rng):
    pre = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    x = (0.05 * (rng.normal(size=4096) + 1j * rng.normal(size=4096))).astype(
        np.complex64
    )
    x[777 : 777 + 64] += pre
    off, metric = detect_preamble(x, pre)
    assert int(off) == 777
    assert float(metric) > 0.5


def test_detect_preamble_noise_only_low_metric(rng):
    pre = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    x = (0.05 * (rng.normal(size=4096) + 1j * rng.normal(size=4096))).astype(
        np.complex64
    )
    _, metric = detect_preamble(x, pre)
    assert float(metric) < 0.1


def test_equalizer_estimate_apply(rng):
    tx_pilot = (rng.normal(size=128) + 1j * rng.normal(size=128)).astype(np.complex64)
    h_true = (0.5 + 1.2j) * np.exp(1j * np.linspace(0, 2, 128)).astype(np.complex64)
    rx_pilot = (tx_pilot * h_true).astype(np.complex64)
    h = np.asarray(OfdmEqualizer.estimate(rx_pilot, tx_pilot))
    assert np.allclose(h, h_true, atol=1e-5)
    data = (rng.normal(size=128) + 1j * rng.normal(size=128)).astype(np.complex64)
    eq = np.asarray(OfdmEqualizer.apply(data * h_true, h))
    assert np.allclose(eq, data, atol=1e-4)


def test_full_receiver_over_channel(rng):
    """TX burst -> unknown integer delay + 3-tap multipath + AWGN ->
    preamble sync -> RX spectra -> pilot equalization -> exact data bits."""
    cfg = RxChainConfig(fft_len=256, decimation=4, active_bins=128)
    tx = TxChain(cfg)
    rx = RxChain(cfg)
    bpf = tx.bits_per_frame()

    # payload: 1 pilot frame (known gold bits) + 4 data frames
    pilot_bits = np.asarray(sequence.lte_gold(0x5A5, bpf))
    data_bits = rng.integers(0, 2, 4 * bpf).astype(np.uint8)
    tx_bits = np.concatenate([pilot_bits, data_bits])
    burst = np.asarray(tx.step(tx_bits))

    # preamble ahead of the burst for timing acquisition
    pre_bits = np.asarray(sequence.lte_gold(0x111, 256))
    preamble = np.asarray(modulation.qpsk().modulate(pre_bits))  # 128 syms
    signal = np.concatenate([preamble, burst])

    # channel: unknown delay, mild static multipath, AWGN
    delay = 1234
    h_chan = np.zeros(8, np.complex64)
    h_chan[0] = 1.0
    h_chan[3] = 0.25 - 0.15j
    h_chan[7] = -0.1 + 0.05j
    rxed = np.convolve(signal, h_chan)
    rxed = np.concatenate([np.zeros(delay, np.complex64), rxed])
    pad = 4 * cfg.fft_len * cfg.decimation  # room for the chain's framing
    rxed = np.concatenate([rxed, np.zeros(pad, np.complex64)]).astype(np.complex64)
    rxed = np.asarray(noise.new(1e-5, 815).apply(rxed))

    # --- receiver ---
    off, metric = detect_preamble(rxed, preamble)
    off = int(off)
    assert float(metric) > 0.2
    assert off == delay  # channel tap 0 dominates

    # burst starts after the preamble; compensate the TX+RX filter delay
    start = off + len(preamble) + loopback_delay(tx, rx)
    span = cfg.fft_len * cfg.decimation
    nframes = 5
    rx_in = rxed[start : start + nframes * span]
    spec = np.asarray(rx.spectra(rx_in))  # [5, 128]

    # channel estimate from the pilot frame, applied to the data frames
    pilot_syms = np.asarray(rx.modulation.modulate(pilot_bits))
    h = OfdmEqualizer.estimate(spec[0], pilot_syms)
    eq = OfdmEqualizer.apply(spec[1:], h)
    out_bits = np.asarray(rx.demod_spectra(eq))
    assert (out_bits == data_bits).all()


def test_cfo_estimate_and_correct(rng):
    from aether_primitives_tpu.models.sync import apply_freq_shift, estimate_cfo

    rep = 128
    half = (rng.normal(size=rep) + 1j * rng.normal(size=rep)).astype(np.complex64)
    pre = np.concatenate([half, half])
    f0 = 7.3e-4  # cycles/sample, well inside the 1/(2*128) ambiguity bound
    n = np.arange(len(pre))
    shifted = (pre * np.exp(2j * np.pi * f0 * n)).astype(np.complex64)
    f_hat = float(estimate_cfo(shifted, rep))
    assert abs(f_hat - f0) < 1e-6
    fixed = np.asarray(apply_freq_shift(shifted, f_hat))
    # after correction the two halves match again (up to a common phase)
    ratio = fixed[rep:] / fixed[:rep]
    assert np.abs(np.angle(ratio * np.conj(ratio.mean()))).max() < 1e-3


def test_full_receiver_with_cfo(rng):
    """Delay + multipath + CFO + noise -> sync (time + frequency) +
    equalization -> exact bits. The residual common phase after CFO
    correction is absorbed by the pilot equalizer."""
    from aether_primitives_tpu.models.sync import apply_freq_shift, estimate_cfo

    cfg = RxChainConfig(fft_len=256, decimation=4, active_bins=128)
    tx = TxChain(cfg)
    rx = RxChain(cfg)
    bpf = tx.bits_per_frame()

    pilot_bits = np.asarray(sequence.lte_gold(0x5A5, bpf))
    data_bits = rng.integers(0, 2, 4 * bpf).astype(np.uint8)
    burst = np.asarray(tx.step(np.concatenate([pilot_bits, data_bits])))

    rep = 128
    half_bits = np.asarray(sequence.lte_gold(0x77, rep * 2))
    half = np.asarray(modulation.qpsk().modulate(half_bits))  # rep symbols
    preamble = np.concatenate([half, half])
    signal = np.concatenate([preamble, burst])

    delay, f0 = 951, 2.5e-4
    h_chan = np.zeros(5, np.complex64)
    h_chan[0], h_chan[2] = 1.0, 0.2 + 0.1j
    rxed = np.convolve(signal, h_chan)
    rxed = np.concatenate([np.zeros(delay, np.complex64), rxed])
    rxed = np.concatenate(
        [rxed, np.zeros(4 * cfg.fft_len * cfg.decimation, np.complex64)]
    )
    n = np.arange(len(rxed))
    rxed = (rxed * np.exp(2j * np.pi * f0 * n)).astype(np.complex64)
    rxed = np.asarray(noise.new(1e-6, 815).apply(rxed))

    # --- receiver: time sync, CFO sync, equalize ---
    off, metric = detect_preamble(rxed, preamble)
    off = int(off)
    assert abs(off - delay) <= 2  # CFO slightly biases the correlation peak
    f_hat = float(estimate_cfo(rxed[off:], rep))
    assert abs(f_hat - f0) < 2e-6
    corrected = np.asarray(apply_freq_shift(rxed, f_hat))

    start = off + len(preamble) + loopback_delay(tx, rx)
    span = cfg.fft_len * cfg.decimation
    rx_in = corrected[start : start + 5 * span]
    spec = np.asarray(rx.spectra(rx_in))
    pilot_syms = np.asarray(rx.modulation.modulate(pilot_bits))
    h = OfdmEqualizer.estimate(spec[0], pilot_syms)
    out_bits = np.asarray(rx.demod_spectra(OfdmEqualizer.apply(spec[1:], h)))
    assert (out_bits == data_bits).all()


def test_apply_freq_shift_batched(rng):
    from aether_primitives_tpu.models.sync import apply_freq_shift

    x = (rng.normal(size=(3, 256)) + 1j * rng.normal(size=(3, 256))).astype(
        np.complex64
    )
    fs = np.array([1e-4, -2e-4, 5e-4], np.float32)
    out = np.asarray(apply_freq_shift(x, fs))
    for i in range(3):
        ref = np.asarray(apply_freq_shift(x[i], float(fs[i])))
        assert np.allclose(out[i], ref, atol=1e-6)


# ---- symbol-timing recovery (Oerder & Meyr) --------------------------------


def _shaped_qpsk(rng, nsym, sps, beta=0.35):
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops import modulation

    bits = rng.integers(0, 2, nsym * 2).astype(np.uint8)
    syms = np.asarray(modulation.qpsk().modulate(bits))
    up = np.zeros(nsym * sps, np.complex64)
    up[::sps] = syms
    taps = fir_mod.rrc_taps(sps, span=8, beta=beta)
    return np.asarray(fir_mod.fir_filter(up, taps))


def test_rrc_taps_properties():
    from aether_primitives_tpu.ops import fir as fir_mod

    h = np.asarray(fir_mod.rrc_taps(4, span=10, beta=0.35)).real
    assert h.shape == (81,)
    assert abs(np.sum(h * h) - 1.0) < 1e-6  # unit energy
    assert (h == h[::-1]).all()  # symmetric
    # matched cascade (RC pulse) has (near-)zero ISI at symbol instants
    rc = np.convolve(h, h)
    mid = len(rc) // 2
    isi = rc[mid % 4 :: 4]
    isi = np.delete(isi, np.argmax(np.abs(isi)))
    assert np.abs(isi).max() < 0.01 * np.abs(rc[mid])


@pytest.mark.parametrize("tau_true", [0.0, 0.3, -0.45, 1.2])
def test_estimate_timing_recovers_fractional_offset(tau_true):
    from aether_primitives_tpu.models import sync
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(1815)
    sps = 4
    x = _shaped_qpsk(rng, 2048, sps)
    delayed = np.asarray(sampling.fractional_delay(x, tau_true))
    tau_hat = float(np.asarray(sync.estimate_timing(delayed, sps)))
    err = (tau_hat - tau_true + sps / 2) % sps - sps / 2
    assert abs(err) < 0.05, (tau_true, tau_hat)


def test_timing_correction_restores_symbol_instants():
    from aether_primitives_tpu.models import sync
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(42)
    sps, tau_true = 4, 0.37
    x = _shaped_qpsk(rng, 1024, sps)
    delayed = np.asarray(sampling.fractional_delay(x, tau_true))
    tau_hat = float(np.asarray(sync.estimate_timing(delayed, sps)))
    fixed = np.asarray(sampling.fractional_delay(delayed, -tau_hat))
    # matched filter + symbol-rate sampling: corrected stream has much
    # lower EVM at the symbol instants than the mis-timed one
    mf = fir_mod.rrc_taps(sps, span=8, beta=0.35)
    def symbol_evm(sig):
        y = np.asarray(fir_mod.fir_filter(sig, mf))
        d = 2 * 8 * sps // 2 * 2  # two RRC group delays
        pts = y[d : d + 800 * sps : sps]
        pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
        ideal = (np.sign(pts.real) + 1j * np.sign(pts.imag)) / np.sqrt(2)
        return np.sqrt(np.mean(np.abs(pts - ideal) ** 2))
    assert symbol_evm(fixed) < 0.5 * symbol_evm(delayed)


def test_fractional_delay_integer_is_roll(rng):
    from aether_primitives_tpu.ops import sampling

    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64)
    y = np.asarray(sampling.fractional_delay(x, 3))
    from aether_primitives_tpu.evm import evm_rms_db

    assert evm_rms_db(y, np.roll(x, 3).astype(np.complex128)) < -110


def test_fractional_delay_traced_tau(rng):
    import jax
    import jax.numpy as jnp
    from aether_primitives_tpu.ops import sampling

    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    host = np.asarray(sampling.fractional_delay(x, 0.25))
    traced = np.asarray(jax.jit(sampling.fractional_delay)(x, jnp.float32(0.25)))
    from aether_primitives_tpu.evm import evm_rms_db

    assert evm_rms_db(traced, host.astype(np.complex128)) < -100


@pytest.mark.parametrize("phi", [0.0, 0.2, -0.35])
def test_estimate_phase_mpsk_qpsk(rng, phi):
    from aether_primitives_tpu.models.sync import estimate_phase_mpsk

    bits = rng.integers(0, 2, 2 * 4096).astype(np.uint8)
    s = np.asarray(modulation.qpsk().modulate(bits)) / np.sqrt(2)
    y = (s * np.exp(1j * phi)).astype(np.complex64)
    y += (0.02 * (rng.normal(size=s.size) + 1j * rng.normal(size=s.size))).astype(
        np.complex64
    )
    phi_hat = float(np.asarray(estimate_phase_mpsk(y, 4)))
    err = (phi_hat - phi + np.pi / 4) % (np.pi / 2) - np.pi / 4
    assert abs(err) < 0.01, (phi, phi_hat)


def test_estimate_phase_then_derotate_fixes_cma_output(rng):
    from aether_primitives_tpu.models import equalizer
    from aether_primitives_tpu.models.sync import estimate_phase_mpsk

    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, 2 * 6000).astype(np.uint8)
    tx = np.asarray(qpsk.modulate(bits)) / np.sqrt(2)
    chan = np.array([1.0, 0.4 - 0.2j], np.complex64) * np.exp(0.4j)
    x = np.convolve(tx, chan)[: tx.size].astype(np.complex64)
    y, _ = equalizer.cma_equalize(x, ntaps=9, mu=0.02, r2=1.0)
    y = np.asarray(y)[2000:]
    phi = float(np.asarray(estimate_phase_mpsk(y, 4)))
    fixed = y * np.exp(-1j * phi)
    got = np.asarray(qpsk.demod(fixed.astype(np.complex64)))
    want = bits[2 * 2000 :]
    # the pi/2 ambiguity maps bits through a fixed permutation; accept any
    # of the 4 rotations being bit-exact
    ok = False
    for k in range(4):
        rot = (fixed * np.exp(-1j * np.pi / 2 * k)).astype(np.complex64)
        cand = np.asarray(qpsk.demod(rot))
        if (cand == want[: cand.size]).all():
            ok = True
            break
    assert ok


# ------------------------------------------------- Costas loop (PLL)


def test_costas_locks_static_phase(rng):
    from aether_primitives_tpu.models.sync import costas_loop

    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, 2 * 4000).astype(np.uint8)
    tx = np.asarray(qpsk.modulate(bits))
    rx = (tx * np.exp(1j * 0.3)).astype(np.complex64)
    y, ph, fr = costas_loop(rx, m=4, loop_bw=0.02)
    # loop settles onto the offset (well within pi/4 -> no ambiguity)
    assert abs(float(np.mean(np.asarray(ph)[2000:])) - 0.3) < 0.02
    got = np.asarray(qpsk.demod(np.asarray(y)[2000:]))
    assert (got == bits[2 * 2000 :]).all()


def test_costas_tracks_residual_cfo(rng):
    from aether_primitives_tpu.models.sync import costas_loop

    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, 2 * 6000).astype(np.uint8)
    tx = np.asarray(qpsk.modulate(bits))
    f_cyc = 1e-4  # cycles/sample residual CFO
    n = np.arange(tx.size)
    rx = (tx * np.exp(2j * np.pi * f_cyc * n)).astype(np.complex64)
    y, ph, fr = costas_loop(rx, m=4, loop_bw=0.02)
    # second-order loop: integrator converges to the frequency step
    assert abs(float(np.mean(np.asarray(fr)[4000:])) - 2 * np.pi * f_cyc) < 2e-4
    got = np.asarray(qpsk.demod(np.asarray(y)[4000:]))
    assert (got == bits[2 * 4000 :]).all()


def test_costas_tracks_phase_noise_random_walk(rng):
    from aether_primitives_tpu.models.sync import costas_loop

    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, 2 * 8000).astype(np.uint8)
    tx = np.asarray(qpsk.modulate(bits))
    walk = np.cumsum(rng.normal(scale=2e-3, size=tx.size))
    rx = (tx * np.exp(1j * walk)).astype(np.complex64)
    y, ph, _ = costas_loop(rx, m=4, loop_bw=0.03)
    err = np.asarray(ph)[1000:] - walk[1000:]
    assert np.sqrt(np.mean(err**2)) < 0.08  # tracks the walk
    assert np.abs(walk[1000:]).max() > 0.15  # ...which is itself large
    got = np.asarray(qpsk.demod(np.asarray(y)[1000:]))
    assert np.mean(got != bits[2 * 1000 :]) < 1e-3


def test_costas_batched_matches_rowwise(rng):
    from aether_primitives_tpu.models.sync import costas_loop

    qpsk = modulation.qpsk()
    rows = []
    for _ in range(3):
        bits = rng.integers(0, 2, 2 * 500).astype(np.uint8)
        rows.append(np.asarray(qpsk.modulate(bits)) * np.exp(1j * 0.2))
    batch = np.stack(rows).astype(np.complex64)
    yb, phb, frb = costas_loop(batch, m=4, loop_bw=0.02)
    for i in range(3):
        y1, ph1, fr1 = costas_loop(batch[i], m=4, loop_bw=0.02)
        assert np.allclose(np.asarray(yb)[i], np.asarray(y1), atol=1e-6)
        assert np.allclose(np.asarray(phb)[i], np.asarray(ph1), atol=1e-6)


def test_estimate_cfo_blind_qpsk(rng):
    from aether_primitives_tpu.models.sync import estimate_cfo_blind

    qpsk = modulation.qpsk()
    bits = rng.integers(0, 2, 2 * 2048).astype(np.uint8)
    tx = np.asarray(qpsk.modulate(bits))
    for f0 in (3.7e-4, -2.1e-3, 0.0):
        rx = tx * np.exp(2j * np.pi * f0 * np.arange(tx.size))
        rx = (rx + 0.3 * (rng.normal(size=tx.size) + 1j * rng.normal(size=tx.size))).astype(np.complex64)
        got = float(estimate_cfo_blind(rx, m=4))
        assert abs(got - f0) < 3e-5, (f0, got)


# ---- Gardner feedback timing loop ---------------------------------------------


def _rc_shaped_qpsk(rng, nsym, sps, beta=0.35):
    """TX-RRC + RX-matched-RRC (raised-cosine cascade) QPSK stream and the
    transmitted symbols — the stream a timing loop actually sees."""
    from aether_primitives_tpu.ops import fir as fir_mod
    from aether_primitives_tpu.ops import modulation

    bits = rng.integers(0, 2, nsym * 2).astype(np.uint8)
    syms = np.asarray(modulation.qpsk().modulate(bits))
    up = np.zeros(nsym * sps, np.complex64)
    up[::sps] = syms
    taps = fir_mod.rrc_taps(sps, span=8, beta=beta)
    shaped = np.asarray(fir_mod.fir_filter(up, taps))
    matched = np.asarray(fir_mod.fir_filter(shaped, taps))
    return matched, syms


def _sign_agreement(strobes, tx_syms, settle):
    """Best agreement of strobe sign-decisions vs TX symbols over small
    alignment shifts (group delay is implementation detail)."""
    dec = np.sign(strobes.real) + 1j * np.sign(strobes.imag)
    ref = np.sign(tx_syms.real) + 1j * np.sign(tx_syms.imag)
    best = 0.0
    for shift in range(-24, 24):  # dec[k] ~ ref[k + shift]
        lo = max(settle, -shift)
        n = min(len(dec) - lo, len(ref) - lo - shift)
        if n <= 100:
            continue
        a = dec[lo : lo + n]
        b = ref[lo + shift : lo + shift + n]
        best = max(best, float(np.mean(a == b)))
    return best


@pytest.mark.parametrize("tau_true", [0.3, 1.7, -0.45])
def test_gardner_locks_static_offset(tau_true):
    from aether_primitives_tpu.models.sync import gardner_loop
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(815)
    sps = 4
    x, syms = _rc_shaped_qpsk(rng, 3000, sps)
    delayed = np.asarray(sampling.fractional_delay(x, tau_true))
    strobes, tau = gardner_loop(delayed, sps=sps, loop_bw=0.02)
    strobes = np.asarray(strobes)
    assert _sign_agreement(strobes, syms, settle=400) > 0.998
    # post-settle strobe positions are stable (loop locked, static clock)
    steps = np.diff(np.asarray(tau)[1500:])
    # Gardner self-noise at this loop bandwidth peaks ~0.1 sample
    assert np.abs(steps - sps).max() < 0.25


def test_gardner_tracks_clock_drift():
    from aether_primitives_tpu.models.sync import gardner_loop
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(42)
    sps = 4
    x, syms = _rc_shaped_qpsk(rng, 4000, sps)
    # RX sample clock 0.1% slow: the same waveform occupies more samples
    stretched = np.asarray(sampling.resample_poly(x, 1001, 1000))
    strobes, tau = gardner_loop(stretched, sps=sps, loop_bw=0.02)
    strobes = np.asarray(strobes)
    assert _sign_agreement(strobes, syms, settle=600) > 0.998
    # converged symbol period reflects the stretched clock (~sps * 1.001)
    period = float(np.mean(np.diff(np.asarray(tau)[2500:3500])))
    assert abs(period - sps * 1.001) < 0.01


def test_gardner_sps2_and_validation():
    from aether_primitives_tpu.models.sync import gardner_loop
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(7)
    x, syms = _rc_shaped_qpsk(rng, 3000, 2)
    delayed = np.asarray(sampling.fractional_delay(x, 0.5))  # worst case
    strobes, _ = gardner_loop(delayed, sps=2, loop_bw=0.02)
    assert _sign_agreement(np.asarray(strobes), syms, settle=500) > 0.99
    with pytest.raises(ValueError, match="2 samples/symbol"):
        gardner_loop(x, sps=1)
    with pytest.raises(ValueError, match="single stream"):
        gardner_loop(np.zeros((2, 64), np.complex64))


def test_costas_axes_grid_locks_psk_table(rng):
    # index-linear psk_table points sit on the axes; grid="axes" locks
    # them on-point where the default diagonal reference would park the
    # loop on decision boundaries
    from aether_primitives_tpu.models.sync import costas_loop
    from aether_primitives_tpu.ops import modulation as mod

    table = np.asarray(mod.psk_table(4))
    idx = rng.integers(0, 4, 4000)
    syms = (table[idx] * np.exp(1j * 0.4)).astype(np.complex64)
    y, _, _ = costas_loop(syms, m=4, loop_bw=0.02, grid="axes")
    got = np.asarray(mod.nearest_index(np.asarray(y)[500:], table))
    assert (got == idx[500:]).mean() > 0.999
    with pytest.raises(ValueError, match="grid"):
        costas_loop(syms, grid="hex")


# ---- blind baud-rate estimation -------------------------------------------------


@pytest.mark.parametrize("sps", [2, 3, 4, 8])
def test_estimate_baud_rate_integer_sps(sps):
    from aether_primitives_tpu.models.sync import estimate_baud_rate

    rng = np.random.default_rng(99)
    x = _shaped_qpsk(rng, 4000, sps)
    x = x + 0.05 * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
    rate = float(np.asarray(estimate_baud_rate(x.astype(np.complex64))))
    assert abs(rate - 1.0 / sps) < 2e-4, (rate, 1.0 / sps)


def test_estimate_baud_rate_fractional_sps():
    # non-integer samples/symbol (sps = 4 * 1000/1001 after resampling)
    from aether_primitives_tpu.models.sync import estimate_baud_rate
    from aether_primitives_tpu.ops import sampling

    rng = np.random.default_rng(7)
    x = _shaped_qpsk(rng, 4000, 4)
    x = x[: (len(x) // 1000) * 1000]
    x = np.asarray(sampling.resample_poly(x, 1001, 1000))
    rate = float(np.asarray(estimate_baud_rate(x)))
    want = 1.0 / (4 * 1001 / 1000)
    assert abs(rate - want) < 2e-4, (rate, want)


def test_estimate_baud_rate_batched(rng):
    from aether_primitives_tpu.models.sync import estimate_baud_rate

    rows = np.stack([_shaped_qpsk(rng, 2000, 4), _shaped_qpsk(rng, 4000, 2)])
    rates = np.asarray(estimate_baud_rate(rows.astype(np.complex64)))
    assert abs(rates[0] - 0.25) < 5e-4
    assert abs(rates[1] - 0.5) < 5e-4


def test_code_tracking_loop_holds_lock_under_drift(rng):
    """Early-late DLL on a GPS C/A code with a 5 ppm chip-clock offset
    (realistic TCXO/Doppler class), CFO, and noise: the despread prompt
    magnitude holds near full correlation across a 3-sample cumulative
    drift (1.5 chips), while a fixed-phase despreader dies after ~1 chip.
    With rectangular chips the correlation plateau is a chip wide, so tau
    is asserted against the drift only to plateau tolerance; the prompt
    magnitude is the lock criterion."""
    from aether_primitives_tpu.models.sync import code_tracking_loop
    from aether_primitives_tpu.ops.sequence import gps_ca_code

    chips01 = gps_ca_code(7)
    code = 1.0 - 2.0 * chips01.astype(np.float64)
    sps, n_dwells, ppm = 2, 300, 5e-6
    n = (n_dwells + 3) * 1023 * sps
    s = np.arange(n, dtype=np.float64)
    chip_pos = (s - sps) * (1 + ppm) / sps
    idx = np.floor(chip_pos).astype(np.int64) % 1023
    x = code[idx] * np.exp(2j * np.pi * 4e-5 * s)  # residual CFO
    x += 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    x = x.astype(np.complex64)

    prompt, tau = code_tracking_loop(
        x, chips01, sps=sps, loop_bw=0.05, n_dwells=n_dwells
    )
    mag = np.abs(np.asarray(prompt)) / 1023
    # plateau-edge excursions transiently cost magnitude (rectangular
    # chips); lock = never below half correlation, high on average
    assert mag[1:].min() > 0.4 and mag[-50:].mean() > 0.8, (
        mag.min(), mag[-50:].mean()
    )
    # tau follows the -3-sample drift within the plateau tolerance
    k = np.arange(n_dwells)
    drift = -ppm * 1023 * sps * k
    err = (np.asarray(tau) - np.asarray(tau)[0]) - drift
    assert np.abs(err).max() < 1.6, np.abs(err).max()

    # open loop (fixed code phase): the same despreader decorrelates
    rep = np.repeat(code, sps)
    mags_open = []
    for kk in (0, n_dwells - 1):
        lo = sps + kk * 1023 * sps  # aligned at dwell 0 (code starts at sps)
        seg = np.asarray(x[lo : lo + 1023 * sps])
        mags_open.append(abs(np.dot(rep, seg)) / (1023 * sps))
    assert mags_open[0] > 0.7 and mags_open[-1] < 0.35, mags_open


def test_gnss_nav_bit_recovery_through_stress_channel(rng):
    """The full GNSS tracking channel — early-late DLL
    (code) -> FLL-assisted Costas PLL (carrier) -> bit sync — recovers
    50 bps nav data through the round-3 stress channel (5 ppm chip-clock
    drift + 4e-5 cyc/sample residual CFO + noise), where the despread
    prompts alone rotate ~0.082 cycles/dwell and are sign-useless."""
    from aether_primitives_tpu.models.sync import (
        carrier_tracking_loop,
        code_tracking_loop,
        nav_bit_sync,
    )
    from aether_primitives_tpu.ops.sequence import gps_ca_code

    chips01 = gps_ca_code(7)
    code = 1.0 - 2.0 * chips01.astype(np.float64)
    sps, n_dwells, ppm = 2, 620, 5e-6
    dwell = 1023 * sps
    n = (n_dwells + 3) * dwell
    s = np.arange(n, dtype=np.float64)
    chip_pos = (s - sps) * (1 + ppm) / sps
    idx = np.floor(chip_pos).astype(np.int64) % 1023
    # 50 bps BPSK nav data: one bit per 20 code periods, edges aligned
    # to code periods (the GPS framing), edge offset 7 dwells in
    nav_bits = rng.integers(0, 2, n_dwells // 20 + 3).astype(np.uint8)
    bit_of_dwell = ((np.floor((s - sps) / dwell).astype(np.int64) + 7)
                    // 20) % nav_bits.size
    data = 1.0 - 2.0 * nav_bits[bit_of_dwell]
    x = code[idx] * data * np.exp(2j * np.pi * 4e-5 * s)
    x += 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    x = x.astype(np.complex64)

    prompt, _tau = code_tracking_loop(
        x, chips01, sps=sps, loop_bw=0.05, n_dwells=n_dwells
    )
    # raw prompts rotate through full circles -> sign of I is useless
    raw_i_bits = (np.real(np.asarray(prompt)) < 0).astype(np.uint8)
    wiped, _phi, freq = carrier_tracking_loop(prompt)
    # the FLL/PLL must find the 0.082 cyc/dwell carrier
    assert abs(float(np.mean(np.asarray(freq)[-100:])) - 4e-5 * dwell) < 5e-3
    # drop the pull-in transient, then recover the bit stream
    settle = 60  # dwells (3 bits)
    bits, off, quality = nav_bit_sync(np.asarray(wiped)[settle:], 20)
    bits = np.asarray(bits)
    assert float(quality) > 0.8, float(quality)
    # expected bits at the recovered alignment (Costas 180-deg ambiguity:
    # accept either polarity — a frame preamble resolves it in a receiver)
    first_dwell = settle + int(off)
    expect = nav_bits[(np.arange(bits.size) * 20 + first_dwell + 7) // 20
                      % nav_bits.size]
    agree = (bits == expect).mean()
    assert max(agree, 1 - agree) == 1.0, agree
    # and the no-carrier-loop strawman really is useless
    raw_agree = (raw_i_bits[settle:settle + 20 * bits.size:20] == expect).mean()
    assert 0.2 < raw_agree < 0.8, raw_agree
