"""Multi-device tests on the 8-virtual-device CPU mesh: halo exchange
correctness (sharded == gathered single-device result), sharded waterfall,
sharded RX chain (SURVEY.md §4 multi-device strategy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aether_primitives_tpu.evm import evm_rms_db
from aether_primitives_tpu.ops import fir
from aether_primitives_tpu.parallel import halo, mesh as mesh_mod


def rand_c(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return mesh_mod.make_mesh({"time": 8})


def test_make_mesh_infer():
    m = mesh_mod.make_mesh({"time": -1})
    assert m.shape["time"] == len(jax.devices())


def test_make_mesh_two_axes(mesh8):
    m = mesh_mod.make_mesh({"channel": 2, "time": 4})
    assert m.shape == {"channel": 2, "time": 4}


def test_make_mesh_bad_sizes():
    with pytest.raises(ValueError, match="devices"):
        mesh_mod.make_mesh({"time": 3})


def test_halo_left_is_previous_tail(mesh8):
    # shard i must see shard i-1's tail; shard 0 sees zeros
    n = 8 * 16
    x = jnp.arange(n).astype(jnp.float32)

    def fn(xs):
        return halo.halo_left(xs, 4, "time")

    out = jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh8,
            in_specs=jax.sharding.PartitionSpec("time"),
            out_specs=jax.sharding.PartitionSpec("time"),
        )
    )(x)
    out = np.asarray(out).reshape(8, 20)
    assert (out[0, :4] == 0).all()
    for i in range(1, 8):
        assert (out[i, :4] == np.arange(i * 16 - 4, i * 16)).all()
        assert (out[i, 4:] == np.arange(i * 16, (i + 1) * 16)).all()


@pytest.mark.parametrize("use_os", [False, True])
def test_sharded_fir_matches_single_device(mesh8, use_os):
    rng = np.random.default_rng(0)
    n = 8 * 1024
    x = rand_c(rng, n)
    taps = rand_c(rng, 33)
    single = np.asarray(fir.fir_filter(x, taps))
    sharded = np.asarray(
        halo.sharded_fir(x, taps, mesh8, use_os=use_os, block_len=256 if use_os else None)
    )
    assert evm_rms_db(sharded, single.astype(np.complex128)) < -110


def test_sharded_waterfall_matches_single(mesh8):
    from aether_primitives_tpu.models import channelizer

    rng = np.random.default_rng(1)
    cap = rand_c(rng, 8 * 4 * 256)  # 32 rows of 256 across 8 devices
    single = np.asarray(channelizer.waterfall_spectra(cap, 256))
    m = mesh_mod.make_mesh({"channel": 8})
    sharded = np.asarray(channelizer.sharded_waterfall(cap, 256, m))
    assert np.allclose(sharded, single, atol=1e-5)


@pytest.mark.parametrize(
    "fir_mode,backend,modulation",
    [
        ("fused", None, "qpsk"),
        ("fused", "matmul", "qpsk"),  # staged-layout sign fast path
        ("fused", "matmul", "qam16"),  # amplitude-sensitive demod
        ("os", None, "qpsk"),
        ("shift_add", None, "qpsk"),
    ],
)
def test_sharded_streaming_matches_contiguous(mesh8, fir_mode, backend, modulation):
    """The flagship composition: carried FIR state x
    time-axis halo x (channel, time) mesh. Four consecutive sharded
    streaming blocks must be bit-identical to ONE contiguous single-device
    step of the concatenated capture — the state hand-off at block
    boundaries and the ppermute halo at shard boundaries must compose."""
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    chain = RxChain(
        RxChainConfig(
            fft_len=128, decimation=4, fir_mode=fir_mode,
            fft_backend=backend, modulation=modulation,
        )
    )
    m = mesh_mod.make_mesh({"channel": 2, "time": 4})
    rng = np.random.default_rng(3)
    C, B = 2, 4  # channels, consecutive blocks
    n = 4 * 4 * 128  # per-block; per-device span 512 = dec*fft_len
    cap = (rng.normal(size=(C, B * n))
           + 1j * rng.normal(size=(C, B * n))).astype(np.complex64)
    contiguous = np.asarray(chain.step(cap))

    fn = jax.jit(lambda b, s: chain.sharded_streaming_step_2d(b, s, m))
    state = chain.init_state((C,))
    outs = []
    for i in range(B):
        bits, state = fn(cap[:, i * n:(i + 1) * n], state)
        outs.append(np.asarray(bits))
    got = np.concatenate(outs, axis=-1)
    assert got.shape == contiguous.shape
    agree = (got == contiguous).mean()
    assert agree == 1.0, f"bit agreement {agree}"
    # the carried state equals the capture's true full-rate tail
    k = chain.taps.shape[-1]
    assert np.array_equal(np.asarray(state), cap[:, -(k - 1):])


def test_sharded_streaming_matches_single_device_streaming(mesh8):
    """Sharded streaming and single-device streaming produce the SAME
    per-block bits and carried state at every step (not just in the
    concatenation) — the mesh is transparent to the stream contract."""
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os"))
    m = mesh_mod.make_mesh({"channel": 2, "time": 4})
    rng = np.random.default_rng(4)
    C, n = 2, 4 * 4 * 128
    state_s = chain.init_state((C,))
    state_1 = chain.init_state((C,))
    fn = jax.jit(lambda b, s: chain.sharded_streaming_step_2d(b, s, m))
    for i in range(3):
        blk = (rng.normal(size=(C, n))
               + 1j * rng.normal(size=(C, n))).astype(np.complex64)
        bits_s, state_s = fn(blk, state_s)
        bits_1, state_1 = chain.streaming_step(blk, state_1)
        assert np.array_equal(np.asarray(bits_s), np.asarray(bits_1)), i
        assert np.array_equal(np.asarray(state_s), np.asarray(state_1)), i


def test_sharded_rx_chain_matches_single(mesh8):
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    cfg = RxChainConfig(fft_len=256, decimation=4)
    chain = RxChain(cfg)
    rng = np.random.default_rng(2)
    n = 8 * 4 * 256 * 2  # per-device span divisible by decimation*fft_len
    x = rand_c(rng, n)
    single = np.asarray(chain.step(x))
    sharded = np.asarray(chain.sharded_step(x, mesh8))
    agree = (single == sharded).mean()
    assert agree == 1.0, f"bit agreement {agree}"


def test_sharded_packed_bits_matches_single(mesh8):
    """packed_bits emission composes with the (channel, time) mesh: the
    per-shard byte streams concatenate to exactly the single-device
    packed output (bits per shard divide by 8 by construction)."""
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    chain = RxChain(RxChainConfig(fft_len=128, decimation=4, fir_mode="os",
                                  packed_bits=True))
    m = mesh_mod.make_mesh({"channel": 2, "time": 4})
    rng = np.random.default_rng(6)
    n = 4 * 4 * 128
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    single = np.asarray(chain.step(x))
    sharded = np.asarray(chain.sharded_step_2d(x, m))
    assert np.array_equal(sharded, single)
    # and the stream form
    st = chain.init_state((2,))
    bits_s, _ = chain.sharded_streaming_step_2d(x, st, m)
    bits_1, _ = chain.streaming_step(x, chain.init_state((2,)))
    assert np.array_equal(np.asarray(bits_s), np.asarray(bits_1))
