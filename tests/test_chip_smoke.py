"""chip_smoke.py at tiny sizes on the CPU: its phases, its refusal to run
without a GPU, and the entry points' compile-cache and peak-table rules.

The full-size phases need a card; ``python chip_smoke.py`` runs them
there, and the tests marked ``gpu`` skip on any other machine.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from aether_primitives_tpu import cli

ROOT = Path(__file__).resolve().parent.parent


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load_chip_smoke()


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_rx_chain_phase_tiny(smoke, capsys):
    res = smoke.rx_chain_phase("cpu-test", n=4 * 64 * 8, fft_len=64,
                               decimation=4, steps=2)
    assert res["agreement"] >= cli.GATE_BIT_AGREEMENT
    assert res["evm_db"] <= cli.GATE_EVM_DB
    out = capsys.readouterr().out
    assert "ms/block" in out and "cpu-test" in out
    assert "TF32 cannot apply" in out


@pytest.mark.parametrize("fec", ["viterbi", "turbo", "ldpc11n", "rs", "ccsds"])
def test_burst_phase_tiny(smoke, fec, capsys):
    res = smoke.burst_phase("cpu-test", fecs=(fec,), batch=2, capture=8192,
                            steps=1)
    assert res[fec]["bursts_per_s"] > 0
    assert res[fec]["scans"], "every burst decoder has a scan"
    out = capsys.readouterr().out
    assert f"burst {fec}: B=2 payloads exact" in out


def test_four_card_phase_on_virtual_devices(smoke, eight_devices, capsys):
    res = smoke.four_card_phase("cpu-test", eight_devices[:4], n_local=4 * 128,
                                fft_len=128, ddc_len=4 * 1024, batch=4,
                                capture=8192)
    assert res["rx_agreement"] == 1.0
    assert res["ddc_err"] < 1e-5
    assert res["burst_identical"]


def test_scan_lengths_counts_nested_scans(smoke):
    def f(x):
        def outer(c, v):
            c2, _ = jax.lax.scan(lambda a, b: (a + b, None), c, v)
            return c2, None
        return jax.lax.scan(outer, x[0, 0], x)[0]

    got = smoke._scan_lengths(jax.make_jaxpr(f)(np.ones((3, 5), np.float32)))
    assert got == {3: 1, 5: 1}


def test_compile_cache_respects_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert cli.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cli.enable_compile_cache()
        assert path == ROOT / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == str(path)
        assert cli.enable_compile_cache() == path  # same path every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_peak_h100():
    peak = cli.device_peak("NVIDIA H100 80GB HBM3")
    assert peak["hbm_bytes_per_s"] == 3.35e12
    assert "NVIDIA" in peak["source"]


def test_device_peak_unknown_kind_raises():
    with pytest.raises(ValueError, match="no published peak"):
        cli.device_peak("cpu")


def test_plausible_uses_given_peak():
    # 1e6 samples in 10 us = 1.6 TB/s of c64 traffic
    assert cli._plausible(10e-6, 1_000_000, 3.35e12)
    assert not cli._plausible(10e-6, 1_000_000, 0.5e12)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cli.require_gpu(jax, allow_cpu=False)
    assert cli.require_gpu(jax, allow_cpu=True).platform == "cpu"


@pytest.mark.gpu
def test_chip_smoke_on_card(smoke):
    """The one-card phases at full width (run by ``python chip_smoke.py``
    on a machine with a card)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py there")
    dev, card = smoke.device_phase(1)
    smoke.rx_chain_phase(card)
