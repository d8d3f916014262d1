"""Sharded streaming graph executor and HBM block pool.

Device-side re-imagination of the reference's two concurrency components
(SURVEY.md §2 #10-#11, §5):

- the thread-per-stage mpsc **Pipeline** (reference src/pipeline.rs) becomes
  a :class:`Pipeline` of named jitted block transforms. Stages fuse into one
  XLA computation per block (a stage boundary is a compiler hint, not a
  thread+channel hop); blocks stream through with **bounded in-flight
  depth** — double buffering instead of the reference's unbounded channels
  (whose OOM backlog risk its own example documents,
  examples/pipeline.rs:61-66). Per-stage throughput/utilisation metrics
  mirror the reference's once-a-second reports;
- the mutex-guarded object **Pool** (reference src/pool.rs) becomes
  :class:`BlockPool`: preallocated host staging buffers with the same
  ``take`` / ``take_or_make`` / ``len`` / ``cap`` surface (RAII guard
  included), while on-device reuse comes from **buffer donation** — the
  executor donates each block's device buffer back to XLA so HBM blocks are
  recycled without any lock (SPMD ownership replaces the mutex).

The same pipeline runs single-chip or sharded: pass a mesh + partition spec
and every block is laid out across devices before the (pjit-compiled) chain
runs; stages may contain collectives (e.g. :func:`..halo.halo_left` in a
``shard_map`` stage).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.metrics import StageStats


@dataclass
class Stage:
    name: str
    op: Callable[[Any], Any]


class Pipeline:
    """Builder for a streaming chain of named block transforms.

    Mirrors the reference's builder (``pipeline::new(name, op)`` →
    ``add_stage`` → ``finish``, src/pipeline.rs:26-48,123-137)::

        pipe = Pipeline("Abs", lambda b: jnp.abs(b))
        pipe = pipe.add_stage("Mul 20", lambda b: b * 20.0)
        ex = pipe.finish(depth=2)
        results = ex.run(blocks)   # keeps at most `depth` blocks in flight

    (or interleave ``send``/``recv`` by hand — ``recv`` must drain what
    ``send`` produces; the executor refuses to grow an unbounded backlog.)
    """

    def __init__(self, name: str, op: Callable[[Any], Any]):
        self.stages: List[Stage] = [Stage(name, op)]

    def add_stage(self, name: str, op: Callable[[Any], Any]) -> "Pipeline":
        self.stages.append(Stage(name, op))
        return self

    def composed(self) -> Callable[[Any], Any]:
        """The fused chain as a single callable (for jit / shard_map)."""
        stages = list(self.stages)

        def chain(x):
            for s in stages:
                x = s.op(x)
            return x

        return chain

    def finish(
        self,
        depth: int = 2,
        donate: bool = True,
        sharding: Optional[jax.sharding.Sharding] = None,
        profile: bool = False,
        report_every_s: float = 1.0,
        printer: Optional[Callable[[str], None]] = print,
        profile_every: int = 16,
    ) -> "StreamExecutor":
        """Compile the chain and return the executor (the analog of the
        reference's ``finish() -> (Sender, Receiver)``)."""
        return StreamExecutor(
            self.stages,
            depth=depth,
            donate=donate,
            sharding=sharding,
            profile=profile,
            report_every_s=report_every_s,
            printer=printer,
            profile_every=profile_every,
        )


def new(name: str, op: Callable[[Any], Any]) -> Pipeline:
    """Create a pipeline (API parity with reference ``pipeline::new``)."""
    return Pipeline(name, op)


class StreamExecutor:
    """Runs blocks through the compiled chain with bounded in-flight depth.

    ``send`` enqueues a block (blocking once ``depth`` blocks are in flight —
    that is the backpressure); ``recv`` returns the oldest finished result.
    JAX dispatch is asynchronous, so while the device computes block *i* the
    host stages and transfers block *i+1* — double buffering without
    explicit DMA management.

    ``profile=True`` compiles each stage separately and synchronizes between
    stages to attribute time per stage on EVERY block (slower; for tuning
    only). The default mode fuses everything and attributes time to the
    chain — but still feeds the per-stage stats by routing every
    ``profile_every``-th block through the per-stage path (periodic
    sampling), so production runs get the reference's always-on per-stage
    throughput/utilisation report (reference src/pipeline.rs:89-114)
    without paying the per-stage sync on the steady-state path. Set
    ``profile_every=0`` to disable sampling (per-stage stats then stay
    empty; chain stats remain live).
    """

    def __init__(
        self,
        stages: List[Stage],
        depth: int = 2,
        donate: bool = True,
        sharding: Optional[jax.sharding.Sharding] = None,
        profile: bool = False,
        report_every_s: float = 1.0,
        printer: Optional[Callable[[str], None]] = print,
        profile_every: int = 16,
    ):
        self.stages = stages
        self.depth = max(1, int(depth))
        self.sharding = sharding
        self.profile = profile
        self._inflight: deque = deque()
        self._closed = False
        donate_args = (0,) if donate else ()
        # donation is only safe for buffers the executor itself creates on
        # device (host numpy blocks staged via asarray/device_put); a block
        # that arrives as a jax.Array is caller-owned and must go through
        # the non-donating executable or the caller's buffer would be
        # silently invalidated
        self._donate = donate
        self.profile_every = 0 if profile else max(0, int(profile_every))
        self._sent = 0
        # per-stage executables exist in every mode: full-time in profile
        # mode, as the periodic sampling path otherwise (jit wrappers are
        # free until first call, so unsampled runs never compile them)
        self._stage_fns_nodonate = [jax.jit(s.op) for s in stages]
        self._stage_fns = (
            [
                jax.jit(s.op, donate_argnums=donate_args if i == 0 else ())
                for i, s in enumerate(stages)
            ]
            if donate
            else self._stage_fns_nodonate
        )
        if profile:
            self._chain = None
            self._chain_nodonate = None
        else:
            def chain(x):
                for s in stages:
                    x = s.op(x)
                return x

            self._chain_nodonate = jax.jit(chain)
            self._chain = (
                jax.jit(chain, donate_argnums=donate_args)
                if donate
                else self._chain_nodonate
            )
        self.stats = [
            StageStats(s.name, report_every_s=report_every_s, printer=printer)
            for s in stages
        ]
        self.chain_stats = StageStats(
            "chain", report_every_s=report_every_s, printer=printer
        )
        self._started = time.monotonic()

    # -- feeding -----------------------------------------------------------
    #: hard cap on dispatched-but-uncollected results; beyond this, send
    #: raises instead of letting device memory grow without bound
    MAX_BACKLOG_FACTOR = 8

    def send(self, block) -> None:
        """Feed one block.

        Backpressure: when ``depth`` computations are pending, waits for the
        oldest to finish before dispatching more (bounding the device work
        queue). Collected results must still be drained with :meth:`recv`
        (or :meth:`run`, which interleaves automatically); the executor
        raises once ``depth * MAX_BACKLOG_FACTOR`` results are waiting.
        """
        if self._closed:
            raise RuntimeError("Executor is closed")
        if len(self._inflight) >= self.depth * self.MAX_BACKLOG_FACTOR:
            raise RuntimeError(
                "in-flight backlog exceeded: drain results with recv() "
                "(or use run(), which interleaves send/recv)"
            )
        if len(self._inflight) >= self.depth:
            jax.block_until_ready(self._inflight[-self.depth][0])
        t0 = time.monotonic()
        caller_owned = isinstance(block, jax.Array)
        x = jnp.asarray(block)
        if self.sharding is not None:
            x = jax.device_put(x, self.sharding)
            caller_owned = False  # device_put produced a fresh buffer
        use_donate = self._donate and not caller_owned
        sample_stages = self.profile or (
            self.profile_every and self._sent % self.profile_every == 0
        )
        self._sent += 1
        if sample_stages:
            fns = self._stage_fns if use_donate else self._stage_fns_nodonate
            y = x
            for fn, st in zip(fns, self.stats):
                s0 = time.monotonic()
                y = fn(y)
                jax.block_until_ready(y)
                st.record(time.monotonic() - s0, samples=int(np.prod(x.shape)))
        else:
            chain = self._chain if use_donate else self._chain_nodonate
            y = chain(x)
        self._inflight.append((y, t0, int(np.prod(x.shape))))

    def recv(self):
        """Wait for and return the oldest in-flight result."""
        if not self._inflight:
            raise IndexError("No blocks in flight")
        y, t0, nsamp = self._inflight.popleft()
        y = jax.block_until_ready(y)
        self.chain_stats.record(time.monotonic() - t0, samples=nsamp)
        return y

    def close(self) -> None:
        self._closed = True

    def __iter__(self):
        while self._inflight:
            yield self.recv()

    # -- convenience -------------------------------------------------------
    def run(self, blocks) -> list:
        """Push all blocks through and return all results (keeps at most
        ``depth`` blocks in flight)."""
        out = []
        for b in blocks:
            if len(self._inflight) >= self.depth:
                out.append(self.recv())
            self.send(b)
        out.extend(self)
        return out


class StatefulExecutor:
    """Bounded-depth executor for STATEFUL streaming steps — chains whose
    blocks are successive spans of one contiguous capture and must thread
    carry-over state (e.g. FIR history) block-to-block.

    ``step(block, state) -> (out, new_state)`` (e.g.
    :meth:`~aether_primitives_tpu.models.modem.RxChain.streaming_step`);
    ``init_state`` is the pre-capture state (zeros for a causal chain).
    This is the continuous-stream form of the reference's pipeline
    (reference src/pipeline.rs:70-79: each worker loops over successive
    blocks of one stream) that the stateless :class:`StreamExecutor`
    cannot express — its chain restarts per block.

    The state dependency does NOT serialize the host: state lives on
    device, ``send`` dispatches asynchronously, and the device queue
    resolves block *i+1*'s dependence on block *i*'s state while the host
    stages block *i+2* (same double buffering as :class:`StreamExecutor`,
    minus cross-block reordering, which a stateful chain forbids anyway).
    The state buffer is donated back to XLA each step (each call consumes
    the previous state exactly once), so no state garbage accumulates.
    """

    MAX_BACKLOG_FACTOR = StreamExecutor.MAX_BACKLOG_FACTOR

    def __init__(
        self,
        step: Callable[[Any, Any], Any],
        init_state,
        name: str = "stream",
        depth: int = 2,
        donate_state: bool = True,
        sharding: Optional[jax.sharding.Sharding] = None,
        report_every_s: float = 1.0,
        printer: Optional[Callable[[str], None]] = print,
    ):
        self.depth = max(1, int(depth))
        self.sharding = sharding
        self._fn = jax.jit(
            step, donate_argnums=(1,) if donate_state else ()
        )
        self._state = init_state
        self._inflight: deque = deque()
        self._closed = False
        self.chain_stats = StageStats(
            name, report_every_s=report_every_s, printer=printer
        )

    def send(self, block) -> None:
        """Feed the next contiguous block (same backpressure contract as
        :meth:`StreamExecutor.send`)."""
        if self._closed:
            raise RuntimeError("Executor is closed")
        if len(self._inflight) >= self.depth * self.MAX_BACKLOG_FACTOR:
            raise RuntimeError(
                "in-flight backlog exceeded: drain results with recv() "
                "(or use run(), which interleaves send/recv)"
            )
        if len(self._inflight) >= self.depth:
            jax.block_until_ready(self._inflight[-self.depth][0])
        t0 = time.monotonic()
        x = block if isinstance(block, jax.Array) else jax.tree.map(
            jnp.asarray, block
        )
        if self.sharding is not None:
            x = jax.device_put(x, self.sharding)
        nsamp = int(
            sum(np.prod(l.shape) for l in jax.tree.leaves(x))
        )
        y, self._state = self._fn(x, self._state)
        self._inflight.append((y, t0, nsamp))

    def recv(self):
        """Wait for and return the oldest in-flight result."""
        if not self._inflight:
            raise IndexError("No blocks in flight")
        y, t0, nsamp = self._inflight.popleft()
        y = jax.block_until_ready(y)
        self.chain_stats.record(time.monotonic() - t0, samples=nsamp)
        return y

    @property
    def state(self):
        """Current carry state (e.g. to checkpoint / resume a stream).

        Returns a COPY: with ``donate_state=True`` the live carry is
        donated to XLA on the next ``send()``, so handing out the raw
        buffers would leave any held checkpoint deleted (review finding
        r4 — ``np.asarray`` on it raised "Array has been deleted")."""
        return jax.tree.map(
            lambda a: jnp.array(a) if isinstance(a, jax.Array) else a,
            self._state,
        )

    def close(self) -> None:
        self._closed = True

    def __iter__(self):
        while self._inflight:
            yield self.recv()

    def run(self, blocks) -> list:
        """Push all contiguous blocks through in order; returns all results
        (keeps at most ``depth`` blocks in flight)."""
        out = []
        for b in blocks:
            if len(self._inflight) >= self.depth:
                out.append(self.recv())
            self.send(b)
        out.extend(self)
        return out


# --------------------------------------------------------------------------
# Block pool (reference src/pool.rs)
# --------------------------------------------------------------------------


class PoolElem:
    """RAII guard: derefs to the buffer via ``.value``; returning happens on
    ``release()`` or context-manager exit (reference ``Elem``,
    src/pool.rs:189-221)."""

    def __init__(self, pool: "BlockPool", value):
        self._pool = pool
        self.value = value
        self._returned = False

    def release(self) -> None:
        if not self._returned:
            self._returned = True
            self._pool._give_back(self.value)

    def __enter__(self):
        return self.value

    def __exit__(self, *exc):
        self.release()


class BlockPool:
    """Thread-safe pool of reusable host staging buffers.

    Same surface as the reference pool (``make``/``take``/``take_or_make``/
    ``len``/``cap``, src/pool.rs:43-160): ``maker`` builds a buffer,
    ``resetter`` runs when one is returned. On-device HBM reuse is the
    executor's job (donation); this pool amortizes *host* allocation for
    staging numpy blocks.

    Checkout/return contract (the reference's doctest, src/pool.rs:13-42 —
    cross-thread moves work because the pool is lock-guarded):

    >>> pool = BlockPool(1, maker=lambda: [0, 0], resetter=lambda b: b.clear())
    >>> elem = pool.take()
    >>> elem.value.append(7)
    >>> pool.take() is None    # bounded: empty while checked out
    True
    >>> elem.release()         # resetter runs, buffer returns
    >>> pool.len(), pool.cap()
    (1, 1)
    >>> pool.take().value      # reset cleared it
    []
    """

    def __init__(self, initial_len: int, maker: Callable[[], Any], resetter=None):
        self._maker = maker
        self._resetter = resetter or (lambda buf: None)
        self._lock = threading.Lock()
        self._elems = []
        for _ in range(int(initial_len)):
            e = maker()
            self._resetter(e)
            self._elems.append(e)
        self._cap = len(self._elems)

    def take(self) -> Optional[PoolElem]:
        """Bounded checkout: ``None`` when empty (reference ``take``)."""
        with self._lock:
            if not self._elems:
                return None
            return PoolElem(self, self._elems.pop())

    def take_or_make(self) -> PoolElem:
        """Growing checkout (reference ``take_or_make``)."""
        with self._lock:
            if self._elems:
                return PoolElem(self, self._elems.pop())
            self._cap += 1
        return PoolElem(self, self._maker())

    def _give_back(self, value) -> None:
        self._resetter(value)
        with self._lock:
            self._elems.append(value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._elems)

    def len(self) -> int:
        return len(self)

    def cap(self) -> int:
        with self._lock:
            return self._cap

    def is_empty(self) -> bool:
        return len(self) == 0

    # the reference ships this method name with a typo (``is_emtpy``,
    # src/pool.rs:145); alias kept so ported call sites keep working
    is_emtpy = is_empty


def make(initial_len: int, maker: Callable[[], Any], resetter=None) -> BlockPool:
    """Create a pool (API parity with reference ``pool::make``)."""
    return BlockPool(initial_len, maker, resetter)
