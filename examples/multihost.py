"""Multi-host / multi-device scaling example.

On a cluster, launch one copy of this script per host, with
``jax.distributed`` told the coordinator address, the process count and
each process's id; it wires the processes into one mesh and each host feeds
its local shard of the molecule library.  One process drives all the GPUs of
its host.  On a single host it runs on whatever devices exist — simulate
several with:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multihost.py

Multi-process correctness: jit inputs on a multi-process runtime must be
GLOBAL arrays whose shards live on each process's own devices — built with
``jax.make_array_from_process_local_data`` (wrapped here as
``parallel.globalize_batch``).  Building global-shape arrays with
``jnp.asarray`` per process works single-host but fails across hosts with
non-addressable-shard errors.
"""

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.parallel import (
    StreamingVoxelizer,
    globalize_batch,
    initialize_distributed,
    make_mesh,
    voxelize_batch_dp,
)


def main():
    initialize_distributed()  # no-op single-process
    n = len(jax.devices())
    pid, nproc = jax.process_index(), jax.process_count()
    n_local = len(jax.local_devices())
    print(f"process {pid}/{nproc}, {n} global devices ({n_local} local)")

    mesh = make_mesh(data=n)
    spec = GridSpec(resolution=0.5, dimension=32)

    # each process generates (in production: reads) its LOCAL slice of the
    # global batch — local rows only, globalized onto the mesh below
    rng = np.random.default_rng(pid)
    local_b = n_local * 4
    global_b = local_b * nproc
    vp, v, c = 128, 40, 4
    coords = np.zeros((local_b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-5, 5, (local_b, v, 3))
    weights = np.zeros((local_b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(local_b, v, c))
    mask = np.zeros((local_b, vp), bool)
    mask[:, :v] = True

    import jax.numpy as jnp

    # identical key schedule everywhere; each process globalizes its rows
    keys = jax.device_get(jax.random.split(jax.random.PRNGKey(0), global_b))
    local_keys = keys[pid * local_b : (pid + 1) * local_b]
    centers = np.zeros((local_b, 3), np.float32)

    grids = voxelize_batch_dp(
        globalize_batch(mesh, coords),
        globalize_batch(mesh, weights),
        jnp.ones((vp,), jnp.float32),
        globalize_batch(mesh, mask),
        globalize_batch(mesh, centers),
        globalize_batch(mesh, local_keys),
        0.5,
        mesh=mesh, spec=spec, random_rotation=True,
    )
    grids.block_until_ready()
    from jax.sharding import NamedSharding, PartitionSpec as P

    mass = float(jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(grids))
    print(f"grids {grids.shape} sharded over {mesh.shape}; global mass = {mass:.1f}")

    # streaming an SDF library across every process: disjoint file stripes ->
    # global DP batches -> per-host gridstore shards (parallel/multihost.py)
    from molvoxel_tpu.data.parsers import SimpleMolecule, write_sdf
    from molvoxel_tpu.parallel import stream_dp_multiprocess

    lib = Path(f"/tmp/multihost_lib_{pid}.sdf")  # demo fixture; use a real library path
    if pid == 0:
        parts = []
        for i in range(64):
            m = SimpleMolecule(
                coords=rng.uniform(-4, 4, (24, 3)), symbols=["C", "N", "O"] * 8,
                bonds=[], name=f"demo-{i}",
            )
            tmp = lib.with_suffix(f".{i}")
            write_sdf(m, tmp)
            parts.append(tmp.read_text())
            tmp.unlink()
        Path("/tmp/multihost_lib.sdf").write_text("".join(parts))
    if nproc > 1:
        import time

        while not Path("/tmp/multihost_lib.sdf").exists():
            time.sleep(0.2)  # pod filesystems are per-host; in production the
            # library lives on shared storage — this wait is demo-only
    stats = stream_dp_multiprocess(
        "/tmp/multihost_lib.sdf", ["C", "N", "O"], spec,
        mesh=mesh, batch_size=n_local * 2, bucket=128, unknown=True,
        store_root="/tmp/multihost_store",
    )
    print(
        f"process {pid}: streamed {stats.molecules} molecules in {stats.batches} "
        f"batches -> /tmp/multihost_store/proc-{pid:03d}"
    )

    # the in-process streaming driver still works for host-local workloads
    def clouds():
        for i in range(local_b):
            yield coords[i, :v], weights[i, :v]

    sv = StreamingVoxelizer(spec, batch_size=n_local * 2, mesh=mesh if nproc == 1 else None)
    stats = sv.run(clouds())
    print(f"streamed {stats.molecules} local molecules in {stats.batches} batches")


if __name__ == "__main__":
    main()
