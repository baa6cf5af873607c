"""Pure-XLA (jnp) voxelization ops.

This is the portable compute path: it runs on every backend, serves as the
numerical parity reference for the Pallas deposit kernel, and is itself fully
jit/vmap/shard_map compatible.  One functional op replaces the reference's
3 backends x 3 forward paths x 6 density/radii kernels (~28 implementations,
SURVEY.md section 7.1):

    out[c, d, h, w] = sum_v weights[v, c] * f(|coords_v - g_dhw|, r_v, sigma)

- ``forward_single``   == weights of ones, shape (V, 1)
- ``forward_types``    == one-hot weights (the reference's scatter_add
  (torch/voxelizer.py:378) becomes a matmul)
- ``forward_features`` == dense weights

Distances are computed *separably*: per-axis squared deltas dx2 (V, D),
dy2 (V, H), dz2 (V, W) are formed once (difference-first, so no catastrophic
cancellation in f32, unlike a |x|^2+|g|^2-2x.g expansion), then combined per
D-slab as a broadcast sum.  This replaces the reference's f64 ``cdist`` over
a materialized meshgrid (numpy/voxelizer.py:544)
with O(V*(D+H+W)) setup and zero stored grid coordinates.

The channel accumulation is a (C, V) @ (V, slab) matmul, the same contraction
the reference does via BLAS (numpy/voxelizer.py:228), at Precision.HIGHEST (true f32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import GridSpec
from ..core.density import density_sq


def _axis_positions(spec: GridSpec, dtype, offset=0, count: int | None = None) -> jnp.ndarray:
    """Voxel-center positions for axis indices [offset, offset + count).

    ``offset`` may be a traced scalar (depth-sharded slabs compute it from
    ``jax.lax.axis_index``); ``count`` must be static.
    """
    count = spec.dimension if count is None else count
    idx = jnp.arange(count, dtype=dtype) + jnp.asarray(offset, dtype)
    return idx * jnp.asarray(spec.resolution, dtype) - jnp.asarray(spec.width / 2.0, dtype)


def _per_axis_sq_deltas(
    coords: jnp.ndarray, spec: GridSpec, d_offset=0, d_count: int | None = None
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(V, Dl), (V, H), (V, W) squared per-axis distances to voxel centers.

    The depth (first) axis may cover just the slab [d_offset, d_offset+d_count)
    — the unit of depth-sharding across devices (replicate atoms, partition
    voxels; no halo needed, SURVEY.md section 5).
    """
    ax = _axis_positions(spec, coords.dtype)  # (dim,)
    axd = ax if d_count is None else _axis_positions(spec, coords.dtype, d_offset, d_count)
    dx = coords[:, 0:1] - axd[None, :]
    dy = coords[:, 1:2] - ax[None, :]
    dz = coords[:, 2:3] - ax[None, :]
    return dx * dx, dy * dy, dz * dz


def _pick_slab(dimension: int, num_atoms: int, budget_elems: int = 1 << 26) -> int:
    """Largest divisor of `dimension` keeping the (V, slab, H, W) temp under budget."""
    plane = dimension * dimension
    best = 1
    for cand in range(1, dimension + 1):
        if dimension % cand == 0 and num_atoms * cand * plane <= budget_elems:
            best = cand
    return best


def _sanitize(
    weights: jnp.ndarray, radii: jnp.ndarray, mask: jnp.ndarray | None
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Zero the weights of masked-out (padded) atoms and keep r2 nonzero for them."""
    r2 = radii * radii
    if mask is not None:
        weights = jnp.where(mask[:, None], weights, 0.0)
        r2 = jnp.where(mask, r2, 1.0)
    return weights, r2


@functools.partial(jax.jit, static_argnames=("spec", "density_type", "sigma", "d_count"))
def voxelize_dense(
    coords: jnp.ndarray,
    weights: jnp.ndarray,
    radii: jnp.ndarray,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,
    d_offset=0,
    d_count: int | None = None,
) -> jnp.ndarray:
    """Voxelize a point cloud with per-atom radii.

    Args:
      coords: (V, 3) float — already centered/transformed.
      weights: (V, C) float — per-atom channel weights.
      radii: (V,) float — per-atom radii (broadcast a scalar for scalar mode).
      spec: grid geometry (static).
      density_type: "gaussian" | "binary" (static).
      sigma: gaussian width (static).
      mask: optional (V,) bool — False entries (padding) contribute nothing.
      d_offset/d_count: optional depth slab [d_offset, d_offset+d_count);
        d_offset may be traced (depth-sharding), d_count is static.

    Returns:
      (C, Dl, H, W) float grid (Dl = d_count or the full dimension).
    """
    v, c = weights.shape
    dim = spec.dimension
    dloc = dim if d_count is None else d_count
    dtype = coords.dtype
    weights, r2 = _sanitize(weights.astype(dtype), radii.astype(dtype), mask)

    dx2, dy2, dz2 = _per_axis_sq_deltas(coords, spec, d_offset, d_count)

    slab = _pick_slab(dloc, v)
    nslabs = dloc // slab

    def compute_slab(dx2_slab: jnp.ndarray) -> jnp.ndarray:
        # dx2_slab: (V, slab) -> out (C, slab, H, W)
        d2 = dx2_slab[:, :, None, None] + dy2[:, None, :, None] + dz2[:, None, None, :]
        dens = density_sq(d2, r2[:, None, None, None], density_type, sigma)
        return jnp.einsum("vc,vdhw->cdhw", weights, dens, preferred_element_type=dtype,
                          precision=jax.lax.Precision.HIGHEST)

    if nslabs == 1:
        return compute_slab(dx2)

    # (V, Dl) -> (nslabs, V, slab) so lax.map iterates over D-slabs.
    dx2_slabs = jnp.moveaxis(dx2.reshape(v, nslabs, slab), 1, 0)
    out = jax.lax.map(compute_slab, dx2_slabs)  # (nslabs, C, slab, H, W)
    return jnp.moveaxis(out, 0, 1).reshape(c, dloc, dim, dim)


@functools.partial(jax.jit, static_argnames=("spec", "density_type", "sigma", "d_count"))
def voxelize_dense_channelwise(
    coords: jnp.ndarray,
    weights: jnp.ndarray,
    radii: jnp.ndarray,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,
    d_offset=0,
    d_count: int | None = None,
) -> jnp.ndarray:
    """Voxelize with channel-wise radii: channel c uses radius radii[c] for all atoms.

    Matches the reference channel-wise features path
    (/root/reference/molvoxel/voxelizer/numpy/voxelizer.py:213-224): the squared
    distances are shared across channels; only the density differs per channel.

    Args:
      coords: (V, 3); weights: (V, C); radii: (C,); mask: optional (V,) bool.

    Returns:
      (C, D, H, W) float grid.
    """
    v, c = weights.shape
    dim = spec.dimension
    dloc = dim if d_count is None else d_count
    dtype = coords.dtype
    weights = weights.astype(dtype)
    r2c = (radii * radii).astype(dtype)  # (C,)
    if mask is not None:
        weights = jnp.where(mask[:, None], weights, 0.0)

    dx2, dy2, dz2 = _per_axis_sq_deltas(coords, spec, d_offset, d_count)

    slab = _pick_slab(dloc, v)
    nslabs = dloc // slab

    def compute_slab(dx2_slab: jnp.ndarray) -> jnp.ndarray:
        d2 = dx2_slab[:, :, None, None] + dy2[:, None, :, None] + dz2[:, None, None, :]  # (V, slab, H, W)
        per_channel = []
        for ci in range(c):
            dens = density_sq(d2, r2c[ci], density_type, sigma)
            per_channel.append(jnp.einsum("v,vdhw->dhw", weights[:, ci], dens, preferred_element_type=dtype,
                                          precision=jax.lax.Precision.HIGHEST))
        return jnp.stack(per_channel)  # (C, slab, H, W)

    if nslabs == 1:
        return compute_slab(dx2)

    dx2_slabs = jnp.moveaxis(dx2.reshape(v, nslabs, slab), 1, 0)
    out = jax.lax.map(compute_slab, dx2_slabs)
    return jnp.moveaxis(out, 0, 1).reshape(c, dloc, dim, dim)
