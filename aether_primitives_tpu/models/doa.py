"""Direction-of-arrival estimation + beamforming for uniform linear arrays.

The array-processing complement to :mod:`.diversity` (combining/MIMO): a
multi-element capture ``[n_elem, T]`` yields bearings via subspace
(MUSIC) or adaptive-spectrum (Capon/MVDR) methods, and steering weights
for delay-and-sum or MVDR beamforming. The reference has no array
support; this extends the deployed-SDR surface the same way the FEC and
sync layers do (reference defines the numeric contracts, not the scope).

Shape: everything reduces to small dense linear algebra batched over
an angle GRID — steering matrix ``[G, M]`` against covariance ``[M, M]``
as one or two matmuls, eigendecomposition of the ``[M, M]``
covariance via ``jnp.linalg.eigh`` (M is 4-64: tiny), peak-finding as a
masked top-k over the static grid (no data-dependent shapes). Angles are
radians from broadside; ``d_lambda`` is element spacing in wavelengths
(default half-wavelength).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import cf32

__all__ = [
    "steering_vector",
    "steering_vector_pos",
    "covariance",
    "spatial_smoothing",
    "music_spectrum",
    "music_spectrum_2d",
    "capon_spectrum",
    "estimate_doa",
    "estimate_doa_2d",
    "sharded_estimate_doa",
    "beamform",
    "mvdr_weights",
]


def steering_vector(n_elem: int, theta, d_lambda: float = 0.5) -> jnp.ndarray:
    """ULA steering vector(s) ``a(theta) [.., M]``:
    ``a_m = e^{-2 pi i m d sin(theta)}`` (phase reference element 0,
    angle from broadside)."""
    th = jnp.asarray(theta, jnp.float32)
    m = jnp.arange(n_elem, dtype=jnp.float32)
    phase = -2.0 * jnp.pi * d_lambda * jnp.sin(th)[..., None] * m
    return jnp.exp(1j * phase.astype(jnp.float32)).astype(cf32)


def steering_vector_pos(positions, az, el=0.0) -> jnp.ndarray:
    """Steering vector(s) for an ARBITRARY array geometry.

    ``positions [M, 2 or 3]`` element coordinates in WAVELENGTHS
    (x = "right", y = boresight, z = "up"); ``az`` azimuth from boresight
    toward +x, ``el`` elevation toward +z (radians; broadcastable).
    ``a_m = e^{-2 pi i p_m . u(az, el)}`` with unit direction
    ``u = (sin az cos el, cos az cos el, sin el)``. A ULA on the x axis
    reproduces :func:`steering_vector` (tested)."""
    p = np.asarray(positions, np.float32)
    if p.ndim != 2 or p.shape[1] not in (2, 3):
        raise ValueError("positions must be [M, 2] or [M, 3] (wavelengths)")
    if p.shape[1] == 2:
        p = np.concatenate([p, np.zeros((p.shape[0], 1), np.float32)], axis=1)
    az = jnp.asarray(az, jnp.float32)
    el = jnp.asarray(el, jnp.float32)
    u = jnp.stack(
        [
            jnp.sin(az) * jnp.cos(el),
            jnp.cos(az) * jnp.cos(el),
            jnp.sin(el) * jnp.ones_like(az),
        ],
        axis=-1,
    )  # [.., 3]
    phase = -2.0 * jnp.pi * jnp.einsum("...c,mc->...m", u, jnp.asarray(p))
    return jnp.exp(1j * phase.astype(jnp.float32)).astype(cf32)


def covariance(x) -> jnp.ndarray:
    """Sample spatial covariance ``R = X X^H / T`` from snapshots
    ``[.., M, T]``."""
    x = jnp.asarray(x, cf32)
    t = x.shape[-1]
    return jnp.matmul(
        x, jnp.conj(jnp.swapaxes(x, -1, -2)),
        precision=jax.lax.Precision.HIGHEST,
    ) / jnp.float32(t)


def spatial_smoothing(r, n_sub: int) -> jnp.ndarray:
    """Forward spatial smoothing: average the ``n_sub`` leading-diagonal
    ``[M-n_sub+1, ...]`` subarray covariances — restores rank for
    COHERENT (multipath-copy) sources at the cost of aperture."""
    r = jnp.asarray(r, cf32)
    m = r.shape[-1]
    ms = m - n_sub + 1
    acc = None
    for s in range(n_sub):
        blk = r[..., s : s + ms, s : s + ms]
        acc = blk if acc is None else acc + blk
    return acc / jnp.float32(n_sub)


def _grid(n_grid: int) -> np.ndarray:
    # open interval: endfire angles alias for a ULA
    return np.linspace(-np.pi / 2 * 0.98, np.pi / 2 * 0.98, n_grid).astype(
        np.float32
    )


def music_spectrum(
    r,
    n_sources: int,
    n_grid: int = 721,
    d_lambda: float = 0.5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """MUSIC pseudo-spectrum over a static angle grid.

    ``r [.., M, M]`` spatial covariance; returns ``(angles [G],
    spectrum [.., G])`` with ``P(theta) = 1 / ||E_n^H a(theta)||^2``
    (noise-subspace projection; peaks at source bearings). The
    eigendecomposition is a tiny batched ``eigh``; the grid sweep is one
    ``[G, M] x [M, M-K]`` matmul.
    """
    r = jnp.asarray(r, cf32)
    m = r.shape[-1]
    _w, v = jnp.linalg.eigh(r)  # ascending eigenvalues
    en = v[..., : m - n_sources]  # noise subspace [.., M, M-K]
    grid = _grid(n_grid)
    a = steering_vector(m, jnp.asarray(grid), d_lambda)  # [G, M]
    proj = jnp.matmul(
        jnp.conj(a), en, precision=jax.lax.Precision.HIGHEST
    )  # [.., G, M-K]
    denom = jnp.sum(jnp.abs(proj) ** 2, axis=-1)
    return jnp.asarray(grid), 1.0 / (denom + 1e-12)


def music_spectrum_2d(
    r,
    n_sources: int,
    positions,
    n_az: int = 181,
    n_el: int = 61,
    el_max: float = np.pi / 3,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Joint azimuth/elevation MUSIC for an arbitrary (planar/3-D) array.

    Returns ``(az_grid [Ga], el_grid [Ge], spectrum [.., Ga, Ge])`` —
    the noise-subspace projection evaluated on the full angle grid as ONE
    ``[Ga*Ge, M] x [M, M-K]`` matmul. Needs a 2-D-capable geometry: a
    purely linear array cannot separate elevation (cone ambiguity)."""
    r = jnp.asarray(r, cf32)
    m = r.shape[-1]
    _w, v = jnp.linalg.eigh(r)
    en = v[..., : m - n_sources]
    az = np.linspace(-np.pi / 2 * 0.98, np.pi / 2 * 0.98, n_az).astype(np.float32)
    el = np.linspace(-el_max, el_max, n_el).astype(np.float32)
    azg, elg = np.meshgrid(az, el, indexing="ij")
    a = steering_vector_pos(
        positions, jnp.asarray(azg.ravel()), jnp.asarray(elg.ravel())
    )  # [Ga*Ge, M]
    proj = jnp.matmul(jnp.conj(a), en, precision=jax.lax.Precision.HIGHEST)
    denom = jnp.sum(jnp.abs(proj) ** 2, axis=-1)
    spec = (1.0 / (denom + 1e-12)).reshape(
        denom.shape[:-1] + (n_az, n_el)
    )
    return jnp.asarray(az), jnp.asarray(el), spec


def estimate_doa_2d(
    x,
    n_sources: int,
    positions,
    n_az: int = 181,
    n_el: int = 61,
    el_max: float = np.pi / 3,
) -> jnp.ndarray:
    """``[K, 2]`` (azimuth, elevation) bearings from snapshots
    ``x [M, T]`` of an arbitrary-geometry array, via 2-D MUSIC: top-K
    local maxima of the az/el surface (3x3 neighborhood), sorted by
    azimuth."""
    az, el, spec = music_spectrum_2d(
        covariance(x), n_sources, positions, n_az, n_el, el_max
    )
    s = spec
    pad = jnp.pad(s, [(1, 1), (1, 1)], constant_values=-jnp.inf)
    is_peak = jnp.ones_like(s, dtype=bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            nb = pad[1 + di : 1 + di + s.shape[0], 1 + dj : 1 + dj + s.shape[1]]
            is_peak = is_peak & (s >= nb)
    masked = jnp.where(is_peak, s, -jnp.inf).reshape(-1)
    _vals, idx = jax.lax.top_k(masked, n_sources)
    ai = idx // el.shape[0]
    ei = idx % el.shape[0]
    pairs = jnp.stack([az[ai], el[ei]], axis=-1)  # [K, 2]
    order = jnp.argsort(pairs[:, 0])
    return pairs[order]


def capon_spectrum(
    r,
    n_grid: int = 721,
    d_lambda: float = 0.5,
    diagonal_load: float = 1e-3,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Capon (MVDR) spatial spectrum ``P(theta) = 1 / (a^H R^{-1} a)``.

    No model-order input (unlike MUSIC) — resolution set by the array
    and SNR. ``diagonal_load`` regularizes the inverse (x mean diagonal).
    """
    r = jnp.asarray(r, cf32)
    m = r.shape[-1]
    load = diagonal_load * jnp.real(jnp.trace(r, axis1=-2, axis2=-1)) / m
    rl = r + load[..., None, None] * jnp.eye(m, dtype=cf32)
    grid = _grid(n_grid)
    a = steering_vector(m, jnp.asarray(grid), d_lambda)  # [G, M]
    ri_a = jnp.linalg.solve(
        rl[..., None, :, :], a[..., None].astype(cf32)
    )[..., 0]  # [.., G, M]  (R^{-1} a per grid angle)
    denom = jnp.real(jnp.sum(jnp.conj(a) * ri_a, axis=-1))
    return jnp.asarray(grid), 1.0 / (denom + 1e-12)


def _peaks(angles, spec, n_sources: int):
    """Top-``n_sources`` local maxima with parabolic refinement."""
    s = spec
    left = jnp.concatenate([s[..., :1], s[..., :-1]], axis=-1)
    right = jnp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    is_peak = (s >= left) & (s > right)
    masked = jnp.where(is_peak, s, -jnp.inf)
    _vals, idx = jax.lax.top_k(masked, n_sources)  # [.., K]
    step = angles[1] - angles[0]
    i0 = jnp.clip(idx, 1, angles.shape[0] - 2)
    sm = jnp.take_along_axis(s, i0 - 1, axis=-1)
    s0 = jnp.take_along_axis(s, i0, axis=-1)
    sp = jnp.take_along_axis(s, i0 + 1, axis=-1)
    delta = 0.5 * (sm - sp) / (sm - 2 * s0 + sp + 1e-20)
    return angles[i0] + jnp.clip(delta, -1.0, 1.0) * step


def estimate_doa(
    x,
    n_sources: int,
    method: str = "music",
    n_grid: int = 721,
    d_lambda: float = 0.5,
    smoothing: Optional[int] = None,
) -> jnp.ndarray:
    """Bearings (radians from broadside, sorted) of ``n_sources`` from
    snapshots ``x [M, T]``. ``method``: "music" | "capon".
    ``smoothing``: forward spatial smoothing order for coherent sources
    (uses an ``M - smoothing + 1``-element effective aperture)."""
    r = covariance(x)
    if smoothing:
        r = spatial_smoothing(r, smoothing)
    if method == "music":
        ang, spec = music_spectrum(r, n_sources, n_grid, d_lambda)
    elif method == "capon":
        ang, spec = capon_spectrum(r, n_grid, d_lambda)
    else:
        raise ValueError(f"unknown DOA method {method!r}")
    return jnp.sort(_peaks(ang, spec, n_sources), axis=-1)


def beamform(x, theta, d_lambda: float = 0.5) -> jnp.ndarray:
    """Delay-and-sum beamformer: steer ``x [.., M, T]`` to ``theta`` ->
    ``[.., T]`` (unit-gain toward ``theta``)."""
    x = jnp.asarray(x, cf32)
    m = x.shape[-2]
    a = steering_vector(m, jnp.asarray(theta, jnp.float32), d_lambda)
    w = a / jnp.float32(m)
    return jnp.einsum("...m,...mt->...t", jnp.conj(w), x)


def mvdr_weights(r, theta, d_lambda: float = 0.5,
                 diagonal_load: float = 1e-3) -> jnp.ndarray:
    """MVDR (Capon) weights ``w = R^{-1} a / (a^H R^{-1} a)``: unit gain
    toward ``theta``, interference + noise power minimized. Apply as
    ``einsum('...m,...mt->...t', conj(w), x)``."""
    r = jnp.asarray(r, cf32)
    m = r.shape[-1]
    load = diagonal_load * jnp.real(jnp.trace(r, axis1=-2, axis2=-1)) / m
    rl = r + load[..., None, None] * jnp.eye(m, dtype=cf32)
    a = steering_vector(m, jnp.asarray(theta, jnp.float32), d_lambda)
    ri_a = jnp.linalg.solve(rl, a[..., None])[..., 0]
    return ri_a / jnp.sum(jnp.conj(a) * ri_a, axis=-1, keepdims=True)


def sharded_estimate_doa(
    x,
    n_sources: int,
    mesh,
    axis_name: str = "channel",
    method: str = "music",
    n_grid: int = 721,
    d_lambda: float = 0.5,
    smoothing: Optional[int] = None,
) -> jnp.ndarray:
    """:func:`estimate_doa` over a WINDOW batch ``x [W, M, T]`` with the
    window axis sharded over ``mesh`` — the scan-mode form: each device runs the full covariance + eigh + grid-matmul
    + peak pipeline on its ``W / n_dev`` windows, pure data parallel (no
    collectives; windows are independent estimates). Returns ``[W, K]``
    sorted bearings, identical to the unsharded batched call
    (tests/test_doa.py). ``W`` must divide by the mesh axis size.

    Single-device batched scan mode is just :func:`estimate_doa` with a
    leading window axis — every stage already broadcasts over it.
    """
    x = jnp.asarray(x, cf32)
    if x.ndim != 3:
        raise ValueError(f"expected [W, M, T] windows, got shape {x.shape}")
    n_dev = mesh.shape[axis_name]
    if x.shape[0] % n_dev:
        raise ValueError(
            f"{x.shape[0]} windows do not divide over {n_dev} devices"
        )
    p = jax.sharding.PartitionSpec

    def shard_fn(xs):
        return estimate_doa(xs, n_sources, method, n_grid, d_lambda,
                            smoothing)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=p(axis_name, None, None),
        out_specs=p(axis_name, None),
    )
    return fn(x)
