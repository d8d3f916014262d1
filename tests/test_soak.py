"""Soak test: thousands of stateful streaming blocks through one
StatefulExecutor (the reference's pipeline example is
a 10-second sustained harness, reference examples/pipeline.rs:54,198).

Opt-in (set ``AETHER_SOAK=1``) — the run takes minutes on the CPU
backend. What it pins, over ~2000 consecutive blocks of ONE contiguous
stream:

- **No drift**: sampled blocks deep into the stream still match an
  independent f64 numpy reference (convolve with true history →
  decimate → FFT → sign demod) — the carried state is an exact sample
  slice, so agreement must stay at the rounding-only level forever.
- **Bounded memory**: host RSS growth after warmup stays small and the
  device allocator's bytes_in_use does not creep (state donation means
  no garbage accumulates).
- **Exact accounting**: StageStats lifetime counters equal the blocks
  and samples actually pushed.
"""

import os
import resource

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.skipif(
    os.environ.get("AETHER_SOAK") != "1",
    reason="soak test is opt-in: set AETHER_SOAK=1",
)

N_BLOCKS = 2000
BLOCK = 8192
CHECK_EVERY = 250


def _f64_reference_bits(chain, block, history):
    """Independent f64 realization of the chain on one block given the
    true full-rate history: convolve -> decimate -> frame FFT (1/sqrt(N)
    scale) -> QPSK sign demod, all numpy."""
    taps = np.asarray(chain.taps, np.complex128)
    k = taps.shape[-1]
    ext = np.concatenate([history.astype(np.complex128),
                          block.astype(np.complex128)])
    # causal stream filter: block sample i sits at ext position k-1+i
    y = np.convolve(ext, taps, mode="full")[k - 1:k - 1 + block.size]
    dec = chain.config.decimation
    nfft = chain.config.fft_len
    yd = y[::dec]
    frames = yd.reshape(-1, nfft)
    spec = np.fft.fft(frames, axis=-1) / np.sqrt(nfft)
    re, im = spec.real, spec.imag
    bits = np.empty(spec.shape[:-1] + (2 * nfft,), np.uint8)
    bits[..., 0::2] = (re < 0)
    bits[..., 1::2] = (im < 0)
    return bits.reshape(-1)


def test_soak_stateful_stream_drift_memory_stats():
    from aether_primitives_tpu.models import RxChain, RxChainConfig
    from aether_primitives_tpu.parallel.streaming import StatefulExecutor
    from aether_primitives_tpu.utils.profiling import device_memory_stats

    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os"))
    k = chain.taps.shape[-1]
    ex = StatefulExecutor(
        chain.streaming_step, chain.init_state(), name="soak",
        printer=None,
    )

    rng = np.random.default_rng(99)
    history = np.zeros(k - 1, np.complex64)
    checked = 0
    rss_after_warmup = None
    dev_after_warmup = None

    for i in range(N_BLOCKS):
        block = (rng.normal(size=BLOCK)
                 + 1j * rng.normal(size=BLOCK)).astype(np.complex64)
        ex.send(block)
        bits = np.asarray(ex.recv())
        if i % CHECK_EVERY == 0:
            ref = _f64_reference_bits(chain, block, history)
            agree = (bits == ref).mean()
            # f32 chain vs f64 reference: only rounding-boundary sign
            # flips allowed, at ANY depth into the stream (no drift)
            assert agree > 0.9999, (i, agree)
            checked += 1
        history = block[-(k - 1):]
        if i == 50:  # warmup done: compiles, allocator steady
            rss_after_warmup = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss
            dev_after_warmup = device_memory_stats().get("bytes_in_use")

    assert checked == N_BLOCKS // CHECK_EVERY

    # exact accounting
    st = ex.chain_stats
    assert st.total_n == N_BLOCKS
    assert st.total_samples == N_BLOCKS * BLOCK

    # bounded host memory: peak RSS growth after warmup < 256 MB
    rss_end = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    growth_mb = (rss_end - rss_after_warmup) / 1024.0
    assert growth_mb < 256, f"host RSS grew {growth_mb:.0f} MB after warmup"

    # bounded device memory (backend permitting): donation means the
    # steady-state allocation must not creep with block count
    dev_end = device_memory_stats().get("bytes_in_use")
    if dev_after_warmup and dev_end:
        assert dev_end < dev_after_warmup + 64 * 1024 * 1024, (
            dev_after_warmup, dev_end)

    # the carried state equals the true stream tail — zero drift by
    # construction, asserted not assumed
    assert np.array_equal(np.asarray(ex.state), history)
    ex.close()
