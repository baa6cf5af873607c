"""Sharded voxelization: data-parallel batches and depth-sharded grids.

Three execution schemes, all over a (data, depth) Mesh (parallel/mesh.py):

1. ``voxelize_batch_dp`` — shard the molecule batch across the data axis
   (shard_map; each device voxelizes its local molecules).  Linear scaling,
   no communication in the forward path.
2. ``voxelize_depth_sharded`` — one big molecule, grid depth partitioned
   across the depth axis: every device holds all atoms (replicate atoms,
   partition voxels — SURVEY.md section 5: no halo needed because each shard
   evaluates density only against its own voxel slab).
3. ``voxelize_batch_2d`` — both at once: batch over "data", depth over
   "depth"; the full-step collective is a psum of per-shard deposited mass
   (the library's throughput/qc metric).

Inside every shard the compute is the same batched op the single-device path
uses (ops.batch.voxelize_batch -> the batched deposit kernel on the GPU).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import GridSpec
from ..core.transform import do_random_transform
from ..ops.batch import voxelize_batch
from ..ops.voxelize import voxelize
from .mesh import DATA_AXIS, DEPTH_AXIS


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "spec", "density_type", "sigma", "random_rotation", "channelwise", "impl",
        "out_dtype", "presorted",
    ),
)
def voxelize_batch_dp(
    coords: jnp.ndarray,  # (B, V, 3), B divisible by mesh data axis
    weights: jnp.ndarray,  # (B, V, C)
    radii: jnp.ndarray,  # (V,) or (C,) shared
    mask: jnp.ndarray | None,  # (B, V)
    centers: jnp.ndarray | None,  # (B, 3)
    keys: jnp.ndarray,  # (B,) PRNG keys
    random_translation=0.0,
    *,
    mesh: Mesh,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
    out_dtype: str = "float32",
    presorted: bool = False,
) -> jnp.ndarray:
    """Data-parallel batched voxelization -> (B, C, D, H, W) sharded on B."""
    b = coords.shape[0]
    if centers is None:
        centers = jnp.zeros((b, 3), coords.dtype)
    if mask is None:
        mask = jnp.ones(coords.shape[:2], bool)
    rt = jnp.asarray(random_translation, coords.dtype)

    def local(coords, weights, mask, centers, keys):
        return voxelize_batch(
            coords, weights, radii, mask, centers, keys, rt,
            spec=spec, density_type=density_type, sigma=sigma,
            random_rotation=random_rotation, channelwise=channelwise, impl=impl,
            out_dtype=out_dtype, presorted=presorted,
        )

    shard = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,  # the Pallas deposit's output carries no varying-axes type
    )
    return shard(coords, weights, mask, centers, keys)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "spec", "density_type", "sigma", "random_rotation", "channelwise", "impl"),
)
def voxelize_depth_sharded(
    coords: jnp.ndarray,  # (V, 3) replicated
    weights: jnp.ndarray,  # (V, C)
    radii: jnp.ndarray,
    mask: jnp.ndarray | None,
    center: jnp.ndarray | None,
    key: jnp.ndarray,
    random_translation=0.0,
    *,
    mesh: Mesh,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
) -> jnp.ndarray:
    """Depth-sharded single voxelization -> (C, D, H, W) sharded on D.

    Requires spec.dimension divisible by the mesh depth axis.  The random
    transform uses the same key on every shard, so all shards see identical
    transformed coordinates (replicated-randomness correctness).
    """
    nd = mesh.shape[DEPTH_AXIS]
    dim = spec.dimension
    if dim % nd != 0:
        raise ValueError(f"dimension {dim} not divisible by depth shards {nd}")
    local_d = dim // nd
    if center is None:
        center = jnp.zeros((3,), coords.dtype)
    if mask is None:
        mask = jnp.ones((coords.shape[0],), bool)
    rt = jnp.asarray(random_translation, coords.dtype)

    def local(coords, weights, mask, center, key):
        d0 = jax.lax.axis_index(DEPTH_AXIS) * local_d
        crd = coords - center[None, :].astype(coords.dtype)
        crd = do_random_transform(key, crd, None, rt, random_rotation)
        return voxelize(
            crd, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
            channelwise_radii=channelwise, impl=impl, d_offset=d0, d_count=local_d,
        )

    shard = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(None, DEPTH_AXIS, None, None),
        check_vma=False,  # the Pallas deposit's output carries no varying-axes type
    )
    return shard(coords, weights, mask, center, key)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "spec", "density_type", "sigma", "random_rotation", "channelwise", "impl"),
)
def voxelize_batch_2d(
    coords: jnp.ndarray,  # (B, V, 3)
    weights: jnp.ndarray,  # (B, V, C)
    radii: jnp.ndarray,
    mask: jnp.ndarray | None,
    centers: jnp.ndarray | None,
    keys: jnp.ndarray,  # (B,)
    random_translation=0.0,
    *,
    mesh: Mesh,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    random_rotation: bool = False,
    channelwise: bool = False,
    impl: str = "auto",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batch sharded over "data" AND grid depth sharded over "depth".

    Returns (grids (B, C, D, H, W) sharded on (B, D), total deposited mass
    (scalar) — a cross-shard psum over both axes, the step's collective).
    """
    nd = mesh.shape[DEPTH_AXIS]
    dim = spec.dimension
    if dim % nd != 0:
        raise ValueError(f"dimension {dim} not divisible by depth shards {nd}")
    local_d = dim // nd
    b = coords.shape[0]
    if centers is None:
        centers = jnp.zeros((b, 3), coords.dtype)
    if mask is None:
        mask = jnp.ones(coords.shape[:2], bool)
    rt = jnp.asarray(random_translation, coords.dtype)

    def local(coords, weights, mask, centers, keys):
        d0 = jax.lax.axis_index(DEPTH_AXIS) * local_d
        out = voxelize_batch(
            coords, weights, radii, mask, centers, keys, rt,
            spec=spec, density_type=density_type, sigma=sigma,
            random_rotation=random_rotation, channelwise=channelwise, impl=impl,
            d_offset=d0, d_count=local_d,
        )
        mass = jax.lax.psum(jnp.sum(out), axis_name=(DATA_AXIS, DEPTH_AXIS))
        return out, mass

    shard = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS, None, DEPTH_AXIS, None, None), P()),
        check_vma=False,  # the Pallas deposit's output carries no varying-axes type
    )
    return shard(coords, weights, mask, centers, keys)
