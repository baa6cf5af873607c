"""Batched voxelization over padded molecule batches.

The reference has no real batch axis: its timing harness loops Python-side
over ``out_grid[i]`` slices.  Here the batch is a first-class axis: on the GPU
it is the second grid axis of the fused deposit kernel
(ops/pallas_deposit.py); on the CPU it vmaps the dense XLA op.  This is also
the axis data-parallel sharding splits across devices (parallel/).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import GridSpec
from ..core.transform import do_random_transform
from .dense import voxelize_dense, voxelize_dense_channelwise
from .voxelize import default_impl, notrunc_use_pallas


@functools.partial(
    jax.jit,
    static_argnames=(
        "spec",
        "density_type",
        "sigma",
        "random_rotation",
        "channelwise",
        "impl",
        "radii_batched",
        "d_count",
        "materialize",
        "out_dtype",
        "presorted",
    ),
)
def voxelize_batch(
    coords: jnp.ndarray,
    weights: jnp.ndarray,
    radii: jnp.ndarray,
    mask: jnp.ndarray | None,
    centers: jnp.ndarray | None,
    keys: jnp.ndarray,
    random_translation: jnp.ndarray | float = 0.0,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
    radii_batched: bool = False,
    d_offset=0,
    d_count: int | None = None,
    materialize: bool = False,
    out_dtype: str = "float32",
    presorted: bool = False,
) -> jnp.ndarray:
    """Voxelize a padded batch of point clouds.

    Args:
      coords: (B, V, 3).
      weights: (B, V, C).
      radii: (V,)/(C,) shared, or (B, V) when ``radii_batched``.
      mask: (B, V) bool or None.
      centers: (B, 3) or None (treated as origin).
      keys: (B,) jax PRNG keys (e.g. ``jax.random.split(key, B)``); only
        consumed when random_translation > 0 or random_rotation.
      random_translation: scalar magnitude (may be traced).
      random_rotation: static bool.
      d_offset/d_count: optional depth slab (depth-sharded execution).
      out_dtype: "float32" (parity default), "bfloat16" or "float8_e4m3fn":
        narrower grids write fewer bytes and are the natural CNN-training
        input dtype.  Accumulation stays f32.
      presorted: atoms already arrive in spatially-local (Morton) order —
        e.g. the data pipeline sorted them once on the host
        (data/pipeline.py) — so no in-graph sort is needed.

    Returns:
      (B, C, Dl, H, W) of ``out_dtype``.
    """
    if impl == "auto":
        impl = default_impl()
    rt = jnp.asarray(random_translation, coords.dtype)

    if centers is not None:
        coords = coords - centers[:, None, :].astype(coords.dtype)

    notrunc = density_type == "gaussian_notrunc"
    on_kernel = impl == "pallas" and not (
        notrunc and (channelwise or not notrunc_use_pallas(coords.shape[1], spec.dimension, out_dtype))
    )
    # Spatial sort BEFORE the random transform: rigid transforms preserve
    # locality, so the Morton order computed from the un-augmented coords
    # keeps the kernel's atom chunks compact for every augmented sample, the
    # argsort is loop-invariant in augmentation loops, and pipelines that
    # sort on the host skip it entirely (``presorted``).
    if on_kernel and not presorted:
        from .pallas_deposit import _sort_atoms_spatially

        if not channelwise and radii.ndim == 1:
            radii = jnp.broadcast_to(jnp.asarray(radii, jnp.float32)[None, :], coords.shape[:2])
        coords, weights, radii, mask = _sort_atoms_spatially(coords, weights, radii, mask, spec)
        presorted = True

    coords = jax.vmap(lambda k, crd: do_random_transform(k, crd, None, rt, random_rotation))(keys, coords)

    if notrunc and not on_kernel:
        from .separable import voxelize_separable_batch, voxelize_separable_batch_channelwise

        fn = voxelize_separable_batch_channelwise if channelwise else voxelize_separable_batch
        return fn(coords, weights, radii, spec=spec, sigma=sigma, mask=mask, d_offset=d_offset,
                  d_count=d_count, materialize=materialize, out_dtype=out_dtype)

    if on_kernel:
        # custom_vjp wrapper: kernel forward, dense-path VJP backward
        from .autodiff import voxelize_pallas_batch_ad

        return voxelize_pallas_batch_ad(
            coords, weights, radii, mask, d_offset, spec, density_type, sigma, channelwise,
            d_count, out_dtype, presorted,
        )
    if impl != "dense":
        raise ValueError(f"unknown impl {impl!r}; expected 'auto', 'dense' or 'pallas'")

    fn = voxelize_dense_channelwise if channelwise else voxelize_dense
    single = functools.partial(
        fn, spec=spec, density_type=density_type, sigma=sigma, d_offset=d_offset, d_count=d_count
    )
    mask_ax = None if mask is None else 0
    radii_ax = 0 if radii_batched else None
    out = jax.vmap(lambda crd, w, r, m: single(crd, w, r, mask=m), in_axes=(0, 0, radii_ax, mask_ax))(
        coords, weights, radii, mask
    )
    if out_dtype != "float32":
        out = out.astype(out_dtype)
    if materialize:
        # the dense path is foldable XLA too: fence it so a benchmark that
        # asks for materialized grids cannot silently measure a folded graph
        out = jax.lax.optimization_barrier(out)
    return out


def pick_slab_depth(
    spec: GridSpec, num_channels: int = 4, batch_size: int = 1, bytes_limit: int | None = None
) -> int | None:
    """Depth-slab size for grids too large to hold whole on the device.

    None = the full (B, C, D, H, W) float32 grid fits in an eighth of the
    device's memory (``bytes_limit``, by default what the first device
    reports); otherwise the largest divisor of D whose slab does.  Drives
    the full-grid assembly path (voxelize_batch_sliced, CLI --dimension
    256).  A device that does not report its memory (the CPU) never
    slices."""
    if bytes_limit is None:
        bytes_limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    dim = spec.dimension
    plane = batch_size * max(num_channels, 1) * dim * dim * 4
    if bytes_limit is None or dim * plane <= bytes_limit // 8:
        return None
    fits = [s for s in range(1, dim) if dim % s == 0 and s * plane <= bytes_limit // 8]
    return max(fits) if fits else 1


def voxelize_batch_sliced(
    coords,
    weights,
    radii,
    mask,
    centers,
    keys,
    random_translation=0.0,
    *,
    spec: GridSpec,
    slab_depth: int,
    out: "np.ndarray | None" = None,
    **kw,
):
    """Assemble a FULL (B, C, D, H, W) grid from depth slabs, bounded memory.

    Grids too large for the device (pick_slab_depth) run as a loop of
    ``d_count=slab_depth`` slabs — the same unit depth-sharding distributes
    across a mesh (parallel/sharded.py), here executed sequentially on one
    device with a 2-slab in-flight window: slab k+1 dispatches (async) while
    slab k's bytes land in the host buffer, so device memory stays
    O(B * C * slab * H * W) and host memory holds only the result.  Every
    slab reuses the SAME per-molecule PRNG keys, so the random rigid
    transform is consistent across the assembled grid.

    Returns the host ndarray (``out`` if given — e.g. a np.memmap for
    library-scale grids)."""
    import numpy as np

    dim = spec.dimension
    if dim % slab_depth:
        raise ValueError(f"dimension {dim} not divisible by slab_depth {slab_depth}")
    b, _, c = weights.shape
    dtype = np.dtype(jnp.dtype(kw.get("out_dtype", "float32")))
    if out is None:
        out = np.empty((b, c, dim, dim, dim), dtype)
    pending = None
    for d0 in range(0, dim, slab_depth):
        cur = voxelize_batch(
            coords, weights, radii, mask, centers, keys, random_translation,
            spec=spec, d_offset=d0, d_count=slab_depth, **kw,
        )
        if pending is not None:
            out[:, :, pending[0] : pending[0] + slab_depth] = np.asarray(pending[1])
        pending = (d0, cur)
    out[:, :, pending[0] : pending[0] + slab_depth] = np.asarray(pending[1])
    return out
