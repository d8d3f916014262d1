"""Defaults that do not depend on the device.

Each realization choice below once consulted ``jax.devices()[0].platform``
and fell back silently when the query raised. The defaults are now the
same on every device, so they resolve with the device query broken, and
the removed kernel backends are rejected by name.
"""

import jax
import numpy as np
import pytest

from aether_primitives_tpu.models import RxChain, RxChainConfig
from aether_primitives_tpu.ops import fec, fft, fir, sampling, turbo


def _broken_devices(*_a, **_k):
    raise RuntimeError("device query must not decide a default")


def _fir_mode():
    assert RxChain(RxChainConfig(fft_len=64, decimation=4)).fir_mode == "shift_add"


def _precision():
    chain = RxChain(RxChainConfig(fft_len=64, decimation=4))
    assert chain._einsum_precision() == jax.lax.Precision.HIGHEST


def _fft_backend(monkeypatch):
    monkeypatch.delenv("AETHER_FFT_BACKEND", raising=False)
    assert fft.default_backend() == "xla"


def _stage_n1():
    # the heuristic alone: largest n1 <= 128 dividing fft_len whose G'
    # tensor stays small — no per-device table
    assert fir._fused_stage_n1(4, 2048) == fir._fused_stage_n1(4, 2048, None)
    assert 2048 % fir._fused_stage_n1(4, 2048) == 0


def _sampling_dense():
    x = np.arange(64, dtype=np.float32)
    assert np.array_equal(np.asarray(sampling.downsample(x, 16)), x[::4])
    assert sampling.interpolate.__defaults__ == (False,)


def _trellis_backend():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (2, 40)).astype(np.uint8)
    enc = np.stack([np.asarray(fec.conv_encode(b)) for b in bits])
    llr = (4.0 * (1.0 - 2.0 * enc)).astype(np.float32)
    assert np.array_equal(np.asarray(fec.viterbi_decode(llr)), bits)
    soft = np.asarray(fec.conv_decode_soft(llr, window=16, guard=8))
    assert np.array_equal((soft < 0).astype(np.uint8), bits)


SITES = {
    "fir_mode": _fir_mode,
    "precision": _precision,
    "fft_backend": _fft_backend,
    "stage_n1": _stage_n1,
    "sampling_dense": _sampling_dense,
    "trellis_backend": _trellis_backend,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_default_ignores_device_query(site, monkeypatch):
    fn = SITES[site]
    args = (monkeypatch,) if site == "fft_backend" else ()
    monkeypatch.setattr(jax, "devices", _broken_devices)
    fn(*args)


@pytest.mark.parametrize("decoder", ["viterbi", "conv_soft", "turbo"])
def test_removed_pallas_backend_rejected(decoder):
    llr = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match="backend"):
        if decoder == "viterbi":
            fec.viterbi_decode(llr, backend="pallas")
        elif decoder == "conv_soft":
            fec.conv_decode_soft(llr, window=16, guard=8, backend="pallas")
        else:
            turbo.turbo_decode(llr[:20], llr[:20], llr[:20], iterations=1,
                               window=8, guard=4, bcjr_backend="pallas")
