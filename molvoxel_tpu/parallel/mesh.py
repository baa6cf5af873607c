"""Device-mesh construction and multi-host initialization.

The reference has no distributed execution of any kind (SURVEY.md section
2.5); scaling here is native JAX: a ``jax.sharding.Mesh`` with named axes

- ``"data"``  — data parallelism over molecules (the embarrassing axis),
- ``"depth"`` — spatial parallelism over the grid's depth (D) axis for
  protein-scale volumes: atoms are replicated (they are tiny), voxels are
  partitioned, so no halo exchange is needed at all.

Collectives (psum for metrics, all_gather when a full grid must be
assembled) are inserted by XLA from shard_map/pjit annotations; on the GPU
they run over NCCL.  Multi-host execution uses the same code after
``jax.distributed.initialize`` (each process feeds its local shard).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"
DEPTH_AXIS = "depth"


def make_mesh(
    data: int | None = None,
    depth: int = 1,
    *,
    devices=None,
) -> Mesh:
    """Build a (data, depth) mesh over the available devices.

    With defaults, all devices go to the data axis.  ``depth`` splits the
    grid's D axis that many ways (must divide the device count).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if data is None:
        if n % depth != 0:
            raise ValueError(f"depth={depth} does not divide device count {n}")
        data = n // depth
    if data * depth != n:
        raise ValueError(f"mesh {data}x{depth} != device count {n}")
    arr = np.asarray(devices).reshape(data, depth)
    return Mesh(arr, (DATA_AXIS, DEPTH_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for batch-leading arrays: shard dim 0 over the data axis."""
    return NamedSharding(mesh, PartitionSpec(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def pad_batch_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Batch size padded up to a multiple of the data-axis size."""
    d = mesh.shape[DATA_AXIS]
    return int(math.ceil(batch_size / d) * d)


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry: wraps jax.distributed.initialize (fail-fast default).

    On a single-host (or already-initialized) runtime this is a no-op.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # already initialized or single-process environment
        pass
