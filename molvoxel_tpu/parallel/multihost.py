"""Multi-process (multi-host) streaming voxelization.

The scale-out recipe of SURVEY.md §5 ("each host voxelizes its shard of the
library") made real end-to-end:

1. every process reads a disjoint stripe of the SDF via the feeder's span
   striping (``span_offset=process_index, span_stride=process_count`` —
   data/feed.py SDFBatchFeeder), so the file is covered exactly once with no
   cross-host coordination;
2. per-process padded batches become ONE global data-parallel batch via
   ``jax.make_array_from_process_local_data`` (the only correct way to build
   jit inputs on a multi-process runtime: each process contributes the shard
   living on its own devices — constructing global-shape arrays with
   ``jnp.asarray`` per process fails on a real pod with non-addressable
   shard errors);
3. the sharded compute is the same ``voxelize_batch_dp`` shard_map the
   single-host path uses;
4. each process stores its own rows in a per-host gridstore shard directory
   whose manifest records ``process_index`` (data/gridstore.py), so the
   library is reassembled by reading ``proc-*/`` in process order.

Processes may run out of stripe data at different steps; a per-step global
max over a tiny flag array keeps the SPMD programs in lockstep — exhausted
processes feed all-padding batches until every stripe is drained.

Single-process meshes work unchanged (the collective degenerates), so the
same code runs on one device, a virtual CPU mesh, or several hosts.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import GridSpec
from .mesh import DATA_AXIS
from .sharded import voxelize_batch_dp
from .stream import StreamStats


def globalize_batch(mesh: Mesh, arr: np.ndarray) -> jax.Array:
    """Process-local rows -> global array sharded on the data axis.

    ``arr`` holds this process's rows of the global batch (same row count on
    every process); the result is a (num_processes * rows, ...) global array
    whose shards live where the data already is."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(DATA_AXIS)), np.ascontiguousarray(arr)
    )


@functools.lru_cache(maxsize=8)
def _global_max_fn(mesh: Mesh):
    return jax.jit(jnp.max, out_shardings=NamedSharding(mesh, P()))


def _any_process(mesh: Mesh, flag: bool) -> bool:
    """Global OR of a per-process flag (keeps SPMD programs in lockstep)."""
    n_local = len(mesh.local_devices)
    flags = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(DATA_AXIS)),
        np.full((n_local,), 1.0 if flag else 0.0, np.float32),
    )
    return bool(float(_global_max_fn(mesh)(flags)) > 0.0)


def _local_rows(out: jax.Array) -> np.ndarray:
    """This process's rows of a batch-sharded result, in global row order."""
    shards = sorted(out.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def stream_dp_multiprocess(
    path: str | Path,
    symbols: Sequence[str],
    spec: GridSpec,
    *,
    mesh: Mesh,
    batch_size: int = 64,
    bucket: int = 128,
    unknown: bool = False,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    radii: float = 1.0,
    random_translation: float = 0.0,
    random_rotation: bool = False,
    out_dtype: str = "float32",
    seed: int = 0,
    store_root: str | Path | None = None,
    presort: bool = False,
    feeder_kwargs: dict | None = None,
    consumer=None,
    resume: bool = False,
    store_target_bytes: int = 64 << 20,
) -> StreamStats:
    """Stream an SDF library across all processes of a distributed runtime.

    ``batch_size`` is the PER-PROCESS batch (global batch = batch_size *
    num_processes); it must be divisible by the per-process device count.
    ``bucket`` fixes the atom padding so every process compiles one program
    shape.  With ``store_root`` each process writes ``store_root/proc-NNN``
    (manifest carries process_index/num_processes).  ``consumer(images,
    batch)`` receives this process's rows as numpy + its PaddedBatch.

    ``resume=True`` (needs ``store_root``) restarts an interrupted run:
    every flush leaves a provisional manifest, so each process skips the
    batches its shard already holds and re-feeds the rest — crash-anywhere
    fail-fast + restart is the job-level fault model (SURVEY.md section 5).
    Processes may resume at different offsets; the per-step lockstep flag
    handles the uneven tails exactly like uneven stripes.

    Returns this process's StreamStats (molecules = locally fed molecules;
    ``skipped`` = molecules already durable from the prior run).
    """
    from ..data.feed import SDFBatchFeeder

    pid = jax.process_index()
    nproc = jax.process_count()
    n_local = len(mesh.local_devices)
    if batch_size % n_local:
        raise ValueError(f"batch_size {batch_size} not divisible by local device count {n_local}")

    feeder = SDFBatchFeeder(
        path, list(symbols),
        batch_size=batch_size, bucket=bucket, unknown=unknown,
        span_offset=pid, span_stride=nproc,
        presort=presort, spec=spec if presort else None,
        **(feeder_kwargs or {}),
    )
    nch = feeder.num_channels

    writer = None
    resumed_rows = 0
    if store_root is not None:
        from ..data.gridstore import GridShardWriter

        writer = GridShardWriter(
            Path(store_root) / f"proc-{pid:03d}", list(symbols) + (["*"] if unknown else []),
            resolution=spec.resolution, dimension=spec.dimension,
            extra_manifest={"process_index": pid, "num_processes": nproc},
            resume=resume, target_bytes=store_target_bytes,
        )
        if resume:
            # flushed rows are whole batches (appends are batch-sized until
            # the final tail); skip exactly those batches from the stripe
            resumed_rows = writer.rows
    elif resume:
        raise ValueError("resume=True needs store_root (the store holds the progress)")

    radii_dev = jnp.full((bucket,), float(radii), jnp.float32)
    base_key = jax.random.PRNGKey(seed)
    stats = StreamStats()
    t0 = time.time()

    empty = None  # lazily built all-padding batch for drained stripes
    source = iter(feeder)
    skip_batches = resumed_rows // batch_size
    for _ in range(skip_batches):
        if next(source, None) is None:
            break
    stats.skipped = resumed_rows
    # start the step counter past the skipped batches so the per-step PRNG
    # schedule matches the uninterrupted run (resume-stable augmentation)
    step = skip_batches
    while True:
        batch = next(source, None)
        has = batch is not None
        if not _any_process(mesh, has):
            break
        if not has:
            if empty is None:
                from ..data.pipeline import PaddedBatch

                empty = PaddedBatch(
                    coords=np.zeros((batch_size, bucket, 3), np.float32),
                    weights=np.zeros((batch_size, bucket, nch), np.float32),
                    mask=np.zeros((batch_size, bucket), bool),
                    radii=None,
                    centers=np.zeros((batch_size, 3), np.float32),
                    num_atoms=np.zeros((batch_size,), np.int32),
                )
            batch = empty

        # identical global key schedule on every process
        keys = jax.device_get(
            jax.random.split(jax.random.fold_in(base_key, step), batch_size * nproc)
        )
        local_keys = keys[pid * batch_size : (pid + 1) * batch_size]
        centers = batch.centers if batch.centers is not None else np.zeros((batch_size, 3), np.float32)

        out = voxelize_batch_dp(
            globalize_batch(mesh, batch.coords),
            globalize_batch(mesh, batch.weights),
            radii_dev,
            globalize_batch(mesh, batch.mask),
            globalize_batch(mesh, centers),
            globalize_batch(mesh, local_keys),
            random_translation,
            mesh=mesh, spec=spec, density_type=density_type, sigma=sigma,
            random_rotation=random_rotation, out_dtype=out_dtype, presorted=presort,
        )
        if has:
            stats.batches += 1
            stats.molecules += int((batch.num_atoms > 0).sum())
            if writer is not None or consumer is not None:
                local = _local_rows(out)
                if writer is not None:
                    writer.append(local, batch.num_atoms)
                if consumer is not None:
                    consumer(local, batch)
        step += 1

    if writer is not None:
        writer.finalize(resumed_rows + stats.molecules)
    stats.wall_seconds = time.time() - t0
    return stats
