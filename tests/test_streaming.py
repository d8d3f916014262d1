"""Streaming executor + block pool tests (device-side equivalents of
reference src/pipeline.rs and src/pool.rs semantics)."""

import jax.numpy as jnp
import numpy as np

from aether_primitives_tpu.parallel import streaming


def test_pipeline_two_stages_matches_reference_example():
    # the reference example's stages: "Abs" then "Mul 20"
    # (examples/pipeline.rs:34-47)
    pipe = streaming.new("Abs", lambda b: jnp.abs(b)).add_stage(
        "Mul 20", lambda b: b * 20.0
    )
    ex = pipe.finish(depth=2, donate=False, printer=None)
    blocks = [np.full(64, -2.0, np.float32), np.full(64, 3.0, np.float32)]
    out = ex.run(blocks)
    assert np.allclose(np.asarray(out[0]), 40.0)
    assert np.allclose(np.asarray(out[1]), 60.0)


def test_pipeline_order_preserved():
    ex = streaming.new("id", lambda b: b + 0.0).finish(depth=3, donate=False, printer=None)
    blocks = [np.full(8, float(i), np.float32) for i in range(10)]
    out = ex.run(blocks)
    assert [float(np.asarray(o)[0]) for o in out] == list(range(10))


def test_send_recv_api():
    ex = streaming.new("x2", lambda b: b * 2).finish(depth=2, donate=False, printer=None)
    ex.send(np.ones(4, np.float32))
    ex.send(np.full(4, 2.0, np.float32))
    a = ex.recv()
    b = ex.recv()
    assert float(np.asarray(a)[0]) == 2.0 and float(np.asarray(b)[0]) == 4.0


def test_profile_mode_per_stage_stats():
    pipe = streaming.new("a", lambda b: b + 1).add_stage("b", lambda b: b * 2)
    ex = pipe.finish(depth=1, donate=False, profile=True, printer=None)
    out = ex.run([np.zeros(16, np.float32)] * 3)
    assert np.allclose(np.asarray(out[0]), 2.0)
    assert ex.stats[0].total_n == 3
    assert ex.stats[1].total_n == 3
    assert ex.stats[0].total_active_s > 0


def test_stats_reporting(capsys=None):
    msgs = []
    pipe = streaming.new("s", lambda b: b)
    ex = pipe.finish(depth=1, donate=False, report_every_s=0.0, printer=msgs.append)
    ex.run([np.zeros(4, np.float32)] * 2)
    assert any("chain" in m and "Utilisation" in m for m in msgs)


def test_executor_with_sharding():
    # blocks laid out across the 8-device CPU mesh before the chain runs
    import jax

    from aether_primitives_tpu.parallel import mesh as mesh_mod

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 devices")
    mesh = mesh_mod.make_mesh({"time": 8})
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("time"))
    ex = streaming.new("x2", lambda b: b * 2.0).finish(
        depth=2, donate=False, sharding=sharding, printer=None
    )
    out = ex.run([np.arange(64, dtype=np.float32) for _ in range(3)])
    assert np.allclose(np.asarray(out[0]), np.arange(64) * 2.0)


def test_executor_runs_rx_chain_blocks():
    # the flagship chain as a streaming stage: pipeline-of-model integration
    from aether_primitives_tpu.models import RxChain, RxChainConfig

    chain = RxChain(RxChainConfig(fft_len=128, decimation=4))
    ex = streaming.new("rx", chain.step).finish(depth=2, donate=False, printer=None)
    rng = np.random.default_rng(0)
    n = 4 * 128 * 2
    blocks = [
        (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        for _ in range(4)
    ]
    outs = ex.run(blocks)
    assert len(outs) == 4
    for b, o in zip(blocks, outs):
        assert (np.asarray(o) == np.asarray(chain.step(b))).all()


# -- pool (reference src/pool.rs:223-297 tests) -----------------------------


def test_pool_taking():
    pool = streaming.make(1, lambda: bytearray(50))
    assert pool.len() == 1 and pool.cap() == 1
    e1 = pool.take()
    assert e1 is not None
    assert pool.len() == 0 and pool.cap() == 1
    e1.release()
    assert pool.len() == 1 and pool.cap() == 1

    e1 = pool.take()
    e2 = pool.take()
    assert e1 is not None and e2 is None
    e1.release()
    assert pool.len() == 1 and pool.cap() == 1


def test_pool_resetting():
    pool = streaming.make(1, lambda: [], resetter=lambda b: b.clear())
    with pool.take() as buf:
        buf.extend(range(50))
        assert len(buf) == 50
    with pool.take() as buf:
        assert len(buf) == 0  # resetter ran on return


def test_pool_taking_or_making():
    pool = streaming.make(0, lambda: bytearray(50))
    e1 = pool.take_or_make()
    assert pool.len() == 0 and pool.cap() == 1
    e2 = pool.take_or_make()
    assert pool.len() == 0 and pool.cap() == 2
    e1.release()
    e2.release()
    assert pool.len() == 2 and pool.cap() == 2


def test_pool_is_empty_and_threads():
    import threading

    pool = streaming.make(0, lambda: np.zeros(8))
    assert pool.is_empty()
    out = []

    def worker():
        e = pool.take_or_make()
        out.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert pool.cap() == 1 and pool.len() == 0
    out[0].release()
    assert pool.len() == 1


def test_send_does_not_donate_caller_arrays():
    import jax.numpy as jnp

    ex = streaming.new("x2", lambda b: b * 2.0).finish(depth=2, donate=True, printer=None)
    b = jnp.ones(8, jnp.float32)
    ex.send(b)
    ex.recv()
    assert float(b.sum()) == 8.0  # caller's buffer must survive


def test_send_backlog_cap():
    import pytest

    ex = streaming.new("id", lambda b: b).finish(depth=1, donate=False, printer=None)
    cap = ex.depth * ex.MAX_BACKLOG_FACTOR
    for i in range(cap):
        ex.send(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="backlog"):
        ex.send(np.zeros(4, np.float32))
    for _ in range(cap):
        ex.recv()


def test_default_mode_samples_per_stage_stats():
    # fused (non-profile) mode must still feed per-stage stats via the
    # periodic sampling path (round-1 review: they were constructed but
    # never recorded)
    import jax.numpy as jnp

    from aether_primitives_tpu.parallel import streaming

    pipe = streaming.new("a", lambda b: b + 1.0).add_stage("b", lambda b: b * 2.0)
    ex = pipe.finish(depth=2, donate=False, printer=None, profile_every=4)
    for _ in range(9):
        ex.send(np.zeros(64, np.float32))
    for _ in ex:
        pass
    # blocks 0, 4, 8 sampled
    assert all(st.total_n == 3 for st in ex.stats)
    assert all(st.total_active_s > 0 for st in ex.stats)
    assert ex.chain_stats.total_n == 9
    # sampled blocks still produce correct results through the stage path
    out = np.asarray(pipe.finish(donate=False, profile_every=1, printer=None)
                     .run([np.ones(8, np.float32)])[0])
    assert np.allclose(out, 4.0)


def test_profile_every_zero_disables_sampling():
    import jax.numpy as jnp

    from aether_primitives_tpu.parallel import streaming

    pipe = streaming.new("a", lambda b: b + 1.0)
    ex = pipe.finish(depth=2, donate=False, printer=None, profile_every=0)
    ex.send(np.zeros(8, np.float32))
    for _ in ex:
        pass
    assert ex.stats[0].total_n == 0
    assert ex.chain_stats.total_n == 1
