"""Profiler integration (SURVEY.md §5 tracing/profiling).

The reference instruments its pipeline loop inline (per-stage counters,
reference src/pipeline.rs:67-114) and uses criterion offline; here the
online counters live in :mod:`.metrics` / the streaming executor, and this
module adds the *device-level* view: ``jax.profiler`` traces viewable in
TensorBoard/Perfetto, plus annotation helpers to label pipeline stages in
the trace timeline.

Note: trace capture requires profiler support in the PJRT backend; where
a backend lacks it these helpers degrade to no-ops with a warning rather
than failing the pipeline.
"""

from __future__ import annotations

import contextlib
import warnings


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace for the enclosed block.

    >>> with profiling.trace("/tmp/aeth-trace"):  # doctest: +SKIP
    ...     executor.run(blocks)
    then ``tensorboard --logdir /tmp/aeth-trace`` (Profile tab).
    """
    import jax

    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as e:  # backend without profiler support
        warnings.warn(f"jax profiler trace unavailable: {e}")
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:
                warnings.warn(f"jax profiler stop failed: {e}")


def annotate(name: str):
    """Label a region in the profiler timeline (``TraceAnnotation``);
    usable as a context manager around stage dispatches."""
    import jax

    try:
        return jax.profiler.TraceAnnotation(name)
    except Exception:
        return contextlib.nullcontext()


def device_memory_stats() -> dict:
    """Best-effort HBM usage snapshot for the default device."""
    import jax

    dev = jax.devices()[0]
    try:
        stats = dev.memory_stats()
        return {
            "bytes_in_use": stats.get("bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
        }
    except Exception:
        return {}
