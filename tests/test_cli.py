"""Unit tests for the bench harness (aether_primitives_tpu.cli).

The round-1 advisor found the marginal-cost timer clamping negative spans
to 1e-9 s and publishing ~exasample/s throughputs; these tests pin the
fixed behavior: clean linear timing resolves, noise-dominated timing
escalates and then reports failure (None) with an upper bound, and the
plausibility guard rejects memory rates beyond the device's peak.
"""

import numpy as np

from aether_primitives_tpu.cli import _plausible, marginal_cost, numpy_reference_bits


def test_marginal_cost_resolves_linear_runtimes():
    # run(k) = fixed 40 ms sync + k * 2 ms
    dt, floor = marginal_cost(lambda k: 0.040 + k * 0.002, 5, 25)
    assert dt is not None
    assert abs(dt - 0.002) < 1e-9
    assert floor <= dt


def test_marginal_cost_fails_on_constant_runtimes():
    # pure sync cost, no per-iteration signal: must NOT fabricate a rate
    dt, floor = marginal_cost(lambda k: 0.040, 5, 25)
    assert dt is None
    assert floor > 0


def test_marginal_cost_fails_on_negative_span():
    # async-dispatch artifact: larger k measured *faster*
    calls = iter([0.050, 0.049] * 64)

    def run(k):
        return next(calls)

    dt, _ = marginal_cost(run, 5, 25, reps=1)
    assert dt is None


def test_marginal_cost_escalates_until_resolved():
    # per-iter cost tiny vs sync: only resolvable at escalated counts
    dt, _ = marginal_cost(lambda k: 0.040 + k * 1e-4, 5, 25)
    assert dt is not None
    assert abs(dt - 1e-4) < 1e-8


def test_plausibility_guard():
    h100 = 3.35e12  # bytes/s
    # 1e6 samples in 1 us -> 16 PB/s: impossible
    assert not _plausible(1e-6, 1_000_000, h100)
    # 1e6 samples in 100 us -> 160 GB/s: fine
    assert _plausible(100e-6, 1_000_000, h100)


def test_numpy_reference_bits_shapes_and_determinism():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    taps = np.asarray([1.0, 0.5j], np.complex64)
    a = numpy_reference_bits(x, taps, 4, 256)
    b = numpy_reference_bits(x, taps, 4, 256)
    assert a.shape == (4096 // 4 * 2,)
    assert a.dtype == np.uint8
    assert np.array_equal(a, b)
