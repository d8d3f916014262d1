"""Overlap-save halo exchange between neighboring devices.

The device-mesh replacement for the reference's mpsc channel hop between
pipeline stages (SURVEY.md §5 "distributed communication backend"): when a
long capture is sharded into contiguous time blocks across the mesh, FIR /
correlation at block boundaries needs each shard to see the last ``K-1``
samples of its **left** (earlier-time) neighbor. That halo moves with
``jax.lax.ppermute`` (NCCL on GPUs) inside ``shard_map``; the first shard receives
zeros — exactly the zero initial filter state of the causal convention.

Use :func:`sharded_fir` for the fused shard_map FIR, or call
:func:`halo_left` inside your own shard_map stages.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fir as _fir
from ..types import cf32
from .mesh import TIME_AXIS

P = jax.sharding.PartitionSpec


def left_tail(x: jnp.ndarray, overlap: int, axis_name: str = TIME_AXIS) -> jnp.ndarray:
    """The left neighbor's trailing ``overlap`` samples (zeros on the first
    shard). Must run inside ``shard_map`` over ``axis_name``.

    Returns ``[..., overlap]`` — the halo itself.
    """
    size = jax.lax.axis_size(axis_name)
    if overlap > x.shape[-1]:
        raise ValueError(
            f"halo overlap {overlap} exceeds the per-device span "
            f"{x.shape[-1]}: the exchange reaches only ONE neighbor — "
            "use fewer shards or a longer capture"
        )
    tail = x[..., -overlap:]
    # right-shift: shard i sends its tail to shard i+1; shard 0's incoming
    # slot has no source => ppermute fills it with zeros (the causal initial
    # state).
    perm = [(i, i + 1) for i in range(size - 1)]
    return jax.lax.ppermute(tail, axis_name, perm=perm)


def right_head(x: jnp.ndarray, overlap: int, axis_name: str = TIME_AXIS) -> jnp.ndarray:
    """The RIGHT neighbor's leading ``overlap`` samples (zeros on the last
    shard) — the halo for FORWARD-looking windows (the oversampled PFB's
    WOLA frames), dual of :func:`left_tail`. Must run inside ``shard_map``
    over ``axis_name``. Returns ``[..., overlap]``."""
    size = jax.lax.axis_size(axis_name)
    if overlap > x.shape[-1]:
        raise ValueError(
            f"halo overlap {overlap} exceeds the per-device span "
            f"{x.shape[-1]}: the exchange reaches only ONE neighbor — "
            "use fewer shards or a longer capture"
        )
    head = x[..., :overlap]
    # left-shift: shard i+1 sends its head to shard i; the last shard's
    # incoming slot has no source => zeros (the capture's zero-padded end)
    perm = [(i + 1, i) for i in range(size - 1)]
    return jax.lax.ppermute(head, axis_name, perm=perm)


def halo_left(x: jnp.ndarray, overlap: int, axis_name: str = TIME_AXIS) -> jnp.ndarray:
    """Prepend the left neighbor's trailing ``overlap`` samples (zeros on the
    first shard). Must run inside ``shard_map`` over ``axis_name``.

    Returns ``[..., overlap + n_local]``.
    """
    if overlap <= 0:
        return x
    return jnp.concatenate([left_tail(x, overlap, axis_name), x], axis=-1)


def _fir_shard(x_local, taps, axis_name, use_os, block_len):
    k = taps.shape[-1]
    if use_os:
        # the halo becomes overlap-save's external history — local length
        # stays divisible by block_len
        h = left_tail(x_local, k - 1, axis_name) if k > 1 else None
        return _fir.fir_filter_os(x_local, taps, block_len=block_len, history=h)
    ext = halo_left(x_local, k - 1, axis_name)
    return _fir.fir_filter(ext, taps)[..., k - 1 :]


def sharded_fir(
    x,
    taps,
    mesh: jax.sharding.Mesh,
    axis_name: str = TIME_AXIS,
    use_os: bool = False,
    block_len: Optional[int] = None,
):
    """Continuous causal FIR over a time-sharded capture.

    ``x``: ``[..., n]`` with ``n`` divisible by the mesh axis size; sharded
    (or shardable) over ``axis_name`` on the last axis. Bit-equal (to
    rounding) to single-device :func:`~aether_primitives_tpu.ops.fir.fir_filter`
    on the gathered signal: the halo exchange supplies the true cross-shard
    history.
    """
    # taps embed as an in-trace constant from host memory (numpy), never an
    # eager device array — required on backends without complex transfer
    taps = np.asarray(taps, dtype=np.complex64)
    fn = jax.shard_map(
        partial(
            _fir_shard,
            taps=taps,
            axis_name=axis_name,
            use_os=use_os,
            block_len=block_len,
        ),
        mesh=mesh,
        in_specs=P(*([None] * (x.ndim - 1) + [axis_name])),
        out_specs=P(*([None] * (x.ndim - 1) + [axis_name])),
    )
    return fn(x)
