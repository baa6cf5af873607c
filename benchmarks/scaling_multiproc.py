"""Multi-process weak-scaling measurement -> SCALING artifact.

Records the evidence the in-process harness (benchmarks/scaling.py) cannot:
throughput of the REAL process-boundary path — ``jax.distributed`` +
shard_map collectives over gRPC, one virtual CPU device per process (the same
machinery tests/test_multiprocess.py proves correct).  Weak scaling: constant
molecules-per-process per step, an in-graph cross-process checksum reduction
every step (the collective a training step would have).

On this environment the processes share 2 physical cores, so the absolute
numbers are indicative; the artifact's point is per-process-count rows from
the genuine distributed code path plus the in-process virtual-mesh rows.
Every worker forces the CPU platform: several JAX processes must not share
one GPU.

Run:  python benchmarks/scaling_multiproc.py            # writes scaling_artifacts/*.json
      python benchmarks/scaling_multiproc.py worker <port> <pid> <n>  # internal
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

B0 = 32  # molecules per process per step
ITERS = 12
DIM = 32
VP = 64
C = 4


def worker(port: int, pid: int, nproc: int) -> int:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
        )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, str(REPO))
    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from molvoxel_tpu.parallel.sharded import voxelize_batch_dp

    n_global = len(jax.devices())
    assert n_global == nproc, (n_global, nproc)
    mesh = make_mesh(data=n_global)
    spec = GridSpec(resolution=0.5, dimension=DIM)
    b = B0 * n_global

    rng = np.random.default_rng(0)
    coords_l = rng.uniform(-6, 6, (B0, VP, 3)).astype(np.float32)
    weights_l = rng.uniform(size=(B0, VP, C)).astype(np.float32)
    mask_l = np.ones((B0, VP), bool)
    shard = NamedSharding(mesh, P(DATA_AXIS))
    glob = lambda a: jax.make_array_from_process_local_data(shard, a)
    coords, weights, mask = glob(coords_l), glob(weights_l), glob(mask_l)
    radii = jnp.ones((VP,), jnp.float32)

    @functools.partial(jax.jit, static_argnames=("n",))
    def loop(coords, weights, mask, key, n):
        # global arrays must arrive as arguments (closing over non-addressable
        # multi-process arrays is rejected by jax)
        def body(i, acc):
            keys = jax.random.split(jax.random.fold_in(key, i), b)
            out = voxelize_batch_dp(
                coords, weights, radii, mask, None, keys, 0.5,
                mesh=mesh, spec=spec, random_rotation=True, out_dtype="bfloat16",
            )
            # cross-process reduction every step: the training-step collective
            return acc + jnp.sum(out.astype(jnp.float32)) * 1e-6
        return jax.lax.fori_loop(0, n, body, 0.0)

    rep = NamedSharding(mesh, P())
    fetch = jax.jit(lambda x: x, out_shardings=rep)
    key = jax.random.PRNGKey(0)
    float(fetch(loop(coords, weights, mask, key, 1)))  # compile
    t0 = time.time()
    float(fetch(loop(coords, weights, mask, key, ITERS)))
    dt = time.time() - t0
    t0 = time.time()
    float(fetch(loop(coords, weights, mask, key, 1)))
    base = time.time() - t0
    mols = (ITERS - 1) * b / max(dt - base, 1e-9)
    if pid == 0:
        print(json.dumps({"procs": nproc, "mols_per_s": round(mols, 1)}), flush=True)
    return 0


def run_procs(nproc: int) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ncores = os.cpu_count() or 1
    procs = [
        subprocess.Popen(
            # pin each worker to its own core: without pinning a single
            # process already saturates every core, so "weak scaling" would
            # measure core division, not communication overhead
            ["taskset", "-c", str(pid % ncores), sys.executable, __file__,
             "worker", str(port), str(pid), str(nproc)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        )
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed rc={p.returncode}:\n{so}\n{se}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        return worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))

    rows = []
    for nproc in (1, 2):
        row = run_procs(nproc)
        rows.append(row)
        print(f"procs={nproc}: {row['mols_per_s']:.1f} mols/s", file=sys.stderr, flush=True)
    base = rows[0]["mols_per_s"]
    for row in rows:
        row["efficiency"] = round(row["mols_per_s"] / (base * row["procs"]), 3)

    # in-process virtual-mesh rows (8 devices over the same 2 cores)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "benchmarks" / "scaling.py")],
        capture_output=True, text=True, timeout=1200, env=env, cwd=str(REPO),
    )
    virt = None
    if out.returncode == 0:
        for line in reversed(out.stdout.strip().splitlines()):
            try:
                virt = json.loads(line)
                break
            except json.JSONDecodeError:
                continue

    artifact = {
        "metric": "weak_scaling",
        "workload": {"b0_per_process": B0, "dim": DIM, "vp": VP, "channels": C,
                     "density": "gaussian", "out_dtype": "bfloat16"},
        "environment": "2 physical cores, each worker pinned to its own core "
        "(taskset); 1 virtual CPU device per process; jax.distributed over "
        "local gRPC",
        "multiprocess_rows": rows,
        "virtual_mesh_rows": (virt or {}).get("rows"),
        "virtual_mesh_note": "8 virtual devices oversubscribe the same 2 "
        "cores (no pinning possible in-process): total throughput is flat by "
        "construction, so per-device efficiency ~1/d is a host artifact — "
        "the multiprocess rows are the meaningful scaling evidence here",
    }
    path = REPO / os.environ.get("SCALING_ARTIFACT", "scaling_artifacts/scaling_multiproc.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    print(json.dumps(artifact))
    print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
