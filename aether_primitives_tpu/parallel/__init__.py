"""Multi-chip scaling: device meshes, halo exchange, sharded streaming.

The reference's concurrency layer is a thread-per-stage mpsc pipeline and a
mutex-guarded object pool (reference src/pipeline.rs, src/pool.rs). The
device-mesh equivalents here (SURVEY.md §5):

- :mod:`mesh` — ``jax.sharding.Mesh`` construction helpers (time/channel
  axes, multi-host initialization);
- :mod:`halo` — overlap-save halo exchange between devices (``ppermute`` under
  ``shard_map``) for sharded FIR/correlation block boundaries;
- :mod:`streaming` — the sharded streaming graph executor (stage = jitted
  block transform, channel hop = device transfer/collective) with
  per-stage throughput metrics, plus the donated-buffer block pool.
"""

from . import mesh
from . import halo
from . import streaming

__all__ = ["mesh", "halo", "streaming"]
