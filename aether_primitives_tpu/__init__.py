"""aether-primitives-tpu: a software-defined-radio primitives framework in JAX.

A JAX/XLA framework with the capability surface of the Rust crate
``razorheadfx/aether_primitives`` (see SURVEY.md), re-designed for accelerators:

- the unit of data is an HBM-resident block tensor of complex64 samples
  (``[batch..., block_len]``), not a heap ``Vec<cf32>``;
- element-wise "VecOps" are jnp ops fused by XLA (plus a chainable wrapper);
- FFTs run as plan-cached jitted transforms (XLA's FFT, or a matmul
  backend: four-step Cooley-Tukey as batched DFT-factor matmuls);
- streaming runs as sharded block graphs over a ``jax.sharding.Mesh`` with
  overlap-save halo exchange between devices, instead of thread-per-stage mpsc
  pipelines.

Numeric contract: the reference's ``assert_evm!`` macro (reference src/lib.rs:26-49),
vectorized here as :func:`assert_evm` with the same -80 dB default.
"""

from .types import cf32, cf64, as_cf32
from .boundary import Split, split, merge, f32_boundary
from .evm import assert_evm, evm, evm_db
from . import ops
from . import parallel
from . import utils
from . import models
from .ops import vecops, fft, sampling, modulation, sequence, noise, fir, frontend, analog, fec
from .ops.vecops import CVec
from .ops.fft import Scale, Fft, plan as fft_plan
from .utils import DB

__version__ = "0.2.0"

__all__ = [
    "cf32",
    "cf64",
    "as_cf32",
    "Split",
    "split",
    "merge",
    "f32_boundary",
    "assert_evm",
    "evm",
    "evm_db",
    "CVec",
    "Scale",
    "Fft",
    "fft_plan",
    "DB",
    "ops",
    "parallel",
    "utils",
    "models",
    "vecops",
    "fft",
    "sampling",
    "modulation",
    "sequence",
    "noise",
    "fir",
    "frontend",
    "analog",
    "fec",
]
