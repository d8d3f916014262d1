"""Cross-ambiguity function (CAF): joint delay-Doppler acquisition.

:func:`~aether_primitives_tpu.models.sync.detect_preamble` finds WHERE a
known signature sits; under carrier offset / platform motion the signature
is also rotated by an unknown Doppler, and a plain correlator's peak
collapses once the rotation winds through a full cycle over the
signature (coherence loss ~ ``sinc(nu * N)``). The classic fix is the
cross-ambiguity surface::

    CAF(nu, tau) = sum_n x[n] e^{-j 2 pi nu n} conj(ref[n - tau])

evaluated over a grid of Doppler hypotheses ``nu`` (cycles/sample) and
all circular delays ``tau`` — the acquisition stage of GNSS receivers,
radar processors, and TDOA/FDOA geolocation.

Realization: one Doppler hypothesis = one derotated copy of
``x``, so the whole surface is a single *batched* circular correlation —
``[n_dop, N]`` forward FFT,
one elementwise multiply by ``conj(FFT(ref))``, one batched inverse.
No per-hypothesis loop; the Doppler axis is just a batch dimension. The
sequential-search structure of a classic serial-acquisition receiver
disappears entirely.

Reference seed: the freq-domain correlator composition the reference
benches (fft -> vec_mul(conj) -> ifft, /root/reference/benches/
benches.rs:410-417) — the CAF is that correlator batched over a rotator
bank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import fft as _fft
from ..ops.fft import Scale
from ..parallel.mesh import TIME_AXIS
from ..types import cf32

P = jax.sharding.PartitionSpec


def ambiguity(
    x, ref, dopplers, fft_backend: Optional[str] = None
) -> jnp.ndarray:
    """The complex CAF surface ``[len(dopplers), N]``.

    ``x``: the received block (``[N]`` complex); ``ref``: the known
    signature (zero-padded to ``N`` if shorter); ``dopplers``: Doppler
    hypotheses in cycles/sample (array-like, may be traced). Row ``i`` is
    the circular correlation of ``x`` derotated by ``dopplers[i]``
    against ``ref`` — so ``|out[i, tau]|`` peaks where ``ref`` delayed by
    ``tau`` and shifted by ``dopplers[i]`` best explains ``x``. A zero
    Doppler row equals :func:`~aether_primitives_tpu.ops.fir.correlate`.
    """
    x = jnp.asarray(x, dtype=cf32)
    if x.ndim != 1:
        raise ValueError("ambiguity takes a flat block (batch via vmap)")
    n = x.shape[-1]
    ref = jnp.asarray(ref, dtype=cf32)
    if ref.shape[-1] < n:
        ref = jnp.pad(ref, (0, n - ref.shape[-1]))
    elif ref.shape[-1] > n:
        raise ValueError("Reference longer than signal")
    nu = jnp.asarray(dopplers, jnp.float32).reshape(-1)
    ang = -2.0 * jnp.pi * nu[:, None] * jnp.arange(n, dtype=jnp.float32)[None, :]
    bank = x[None, :] * jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    plan = _fft.plan(n, fft_backend)
    spec = plan.fwd(bank, Scale.NONE) * jnp.conj(plan.fwd(ref, Scale.NONE))
    return plan.bwd(spec, Scale.N)


def _parabolic(ym1, y0, yp1):
    """Sub-bin vertex offset of a parabola through three equally spaced
    magnitudes — 0 when the peak is exactly on-bin, in (-0.5, 0.5)."""
    denom = ym1 - 2.0 * y0 + yp1
    return jnp.where(jnp.abs(denom) > 1e-30, 0.5 * (ym1 - yp1) / denom, 0.0)


def estimate_delay_doppler(
    x,
    ref,
    max_doppler: float,
    n_dopplers: int = 64,
    fft_backend: Optional[str] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Joint (delay, doppler, peak_metric) from the CAF surface.

    Scans ``n_dopplers`` hypotheses uniformly over ``[-max_doppler,
    +max_doppler]`` cycles/sample, takes the surface's peak, and refines
    BOTH axes by parabolic interpolation of the magnitude through the
    peak's neighbors (delay neighbors are circular; Doppler neighbors are
    clamped to the grid edge). Returns:

    - ``delay`` — fractional samples, where ``ref`` starts within ``x``;
    - ``doppler`` — cycles/sample (resolve finer than the ``1/N``
      coherence-limited grid via the interpolation);
    - ``peak_metric`` — ``|CAF|^2 / (E_x * E_ref)``, 1.0 for a perfectly
      matched, lone signature (normalized cross-energy; threshold ~0.1
      separates presence from noise in the tests).

    Everything (argmax included) runs on device — one jittable graph.
    """
    x = jnp.asarray(x, dtype=cf32)
    nu = jnp.linspace(-max_doppler, max_doppler, int(n_dopplers)).astype(jnp.float32)
    surf = ambiguity(x, ref, nu, fft_backend)
    return _refine_peak(surf, nu, x, ref)


def _refine_peak(surf, nu, x, ref):
    """Shared peak search + parabolic refinement over a CAF surface
    ``[n_dopplers, n]`` (used by the single-device and sharded
    estimators — one copy so the edge handling cannot diverge)."""
    n = surf.shape[-1]
    mag = jnp.abs(surf)
    flat = jnp.argmax(mag)
    di, ti = flat // n, flat % n
    # delay refinement (circular neighbors)
    row = mag[di]
    tau_off = _parabolic(row[(ti - 1) % n], row[ti], row[(ti + 1) % n])
    # doppler refinement (clamped neighbors; off = 0 at the grid edge)
    col = mag[:, ti]
    nd = col.shape[0]
    dm1 = col[jnp.maximum(di - 1, 0)]
    dp1 = col[jnp.minimum(di + 1, nd - 1)]
    nu_off = jnp.where(
        (di > 0) & (di < nd - 1), _parabolic(dm1, col[di], dp1), 0.0
    )
    step = nu[1] - nu[0] if nd > 1 else jnp.float32(0.0)
    delay = (ti.astype(jnp.float32) + tau_off) % n
    doppler = nu[di] + nu_off * step
    e_x = jnp.sum(jnp.abs(x) ** 2)
    e_r = jnp.sum(jnp.abs(jnp.asarray(ref, dtype=cf32)) ** 2)
    metric = (mag[di, ti] ** 2) / (e_x * e_r)
    return delay, doppler, metric


# --------------------------------------------------------------- sharded


def sharded_ambiguity(
    x,
    ref,
    dopplers,
    mesh,
    axis_name: str = TIME_AXIS,
    fft_backend: Optional[str] = None,
) -> jnp.ndarray:
    """:func:`ambiguity` with the DOPPLER axis sharded over ``mesh``.

    Acquisition is embarrassingly parallel over hypotheses (each Doppler
    row is an independent derotate + circular correlation — the GNSS
    PRN x Doppler search grid), so the mesh splits the rotator bank: the
    block ``x`` and signature ``ref`` are replicated to every device
    once, each device correlates its ``n_dop / n_dev``
    hypotheses, and the surface comes back sharded row-wise — no
    collectives inside the hot loop at all. Identical (bit-for-bit: the
    per-row math never crosses shards) to the single-device surface
    (tests/test_caf.py). ``len(dopplers)`` must divide by the mesh axis
    size.
    """
    x = jnp.asarray(x, dtype=cf32)
    nu = jnp.asarray(dopplers, jnp.float32).reshape(-1)
    n_dev = mesh.shape[axis_name]
    if nu.shape[0] % n_dev:
        raise ValueError(
            f"{nu.shape[0]} Doppler hypotheses do not divide over "
            f"{n_dev} devices"
        )

    def shard_fn(xs, nus):
        return ambiguity(xs, ref, nus, fft_backend)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(axis_name)),
        out_specs=P(axis_name, None),
    )
    return fn(x, nu)


def sharded_estimate_delay_doppler(
    x,
    ref,
    max_doppler: float,
    mesh,
    n_dopplers: int = 64,
    axis_name: str = TIME_AXIS,
    fft_backend: Optional[str] = None,
):
    """:func:`estimate_delay_doppler` computing its CAF surface via
    :func:`sharded_ambiguity`; the peak search + parabolic refinement run
    on the (tiny) gathered surface. Same return contract."""
    x = jnp.asarray(x, dtype=cf32)
    nu = jnp.linspace(
        -max_doppler, max_doppler, int(n_dopplers)
    ).astype(np.float32)
    surf = sharded_ambiguity(x, ref, nu, mesh, axis_name, fft_backend)
    return _refine_peak(surf, jnp.asarray(nu), x, ref)
