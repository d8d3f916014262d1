"""DSP kernels: element-wise vector ops, FFT, resampling, modulation,
sequences, noise, and FIR/correlation — all batched jitted JAX kernels
over complex64 sample blocks."""

from . import vecops
from . import fft
from . import sampling
from . import modulation
from . import sequence
from . import noise
from . import fir
from . import frontend
from . import analog
from . import fec
from . import ldpc
from . import nr_ldpc
from . import rs
from . import bch
from . import tpc
from . import turbo
from . import firdes
from . import iir
from . import polar

__all__ = [
    "vecops", "fft", "sampling", "modulation", "sequence", "noise", "fir",
    "frontend",
    "analog",
    "fec", "ldpc", "nr_ldpc", "rs", "bch", "tpc", "turbo", "polar",
    "firdes", "iir",
]
