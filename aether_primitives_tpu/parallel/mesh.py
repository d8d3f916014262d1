"""Device-mesh helpers.

Sharding model (SURVEY.md §5 "long-context / sequence parallelism"): long
captures shard into contiguous **time blocks** along one mesh axis, and
independent **channels** (waterfall rows, parallel RX chains) along another.
Collectives are XLA's (NCCL on GPUs); multi-host runs span processes with the same mesh via
``jax.distributed.initialize``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

TIME_AXIS = "time"
CHANNEL_AXIS = "channel"


def make_mesh(
    axes: Optional[dict] = None, devices: Optional[Sequence] = None
) -> jax.sharding.Mesh:
    """Build a mesh. Default: all devices on one ``time`` axis.

    ``axes``: ordered {name: size} dict; sizes must multiply to the device
    count (one size may be -1 to infer).
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if axes is None:
        axes = {TIME_AXIS: n}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh axes {dict(zip(names, sizes))} != {n} devices")
    dev_array = np.asarray(devs).reshape(sizes)
    return jax.sharding.Mesh(dev_array, tuple(names))


def time_sharding(mesh: jax.sharding.Mesh, axis: str = TIME_AXIS):
    """NamedSharding placing the leading (block) axis on ``axis``."""
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(axis))


def init_distributed(**kwargs) -> None:
    """Multi-host runtime bring-up (``jax.distributed.initialize``).

    No-op if already initialized; pass coordinator_address/num_processes/
    process_id explicitly where no cluster environment provides them.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized
