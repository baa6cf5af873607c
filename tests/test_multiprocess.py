"""True multi-process distributed execution: 2 jax.distributed processes on a
CPU local cluster (4 virtual devices each -> 8 global), driving the
data-parallel voxelize path across the process boundary.

The in-process 8-device mesh tests (tests/test_parallel.py) exercise the
sharding math; this one proves the *process-boundary* machinery — coordinator
handshake, global device discovery, make_array_from_process_local_data, and
shard_map collectives over gRPC — actually runs.
The reference has no distributed execution of any kind (SURVEY.md §2.5).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).parent / "multiproc_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_data_parallel():
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        # the workers configure their own platform/devices; strip the
        # conftest-driven single-process settings
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")
    }
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(pid), "2"],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=str(WORKER.parent.parent),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=220)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"CHECK process={pid}" in out and "ok=True" in out, out
    # both processes fetched the same replicated global checksum
    vals = [line for out in outs for line in out.splitlines() if line.startswith("CHECK")]
    got = {line.split("got=")[1].split()[0] for line in vals}
    assert len(got) == 1, vals


STREAM_WORKER = Path(__file__).parent / "multiproc_stream_worker.py"


def _fixture_sdf(path, n=18, seed=7):
    import numpy as np

    from molvoxel_tpu.data.parsers import SimpleMolecule, write_sdf

    rng = np.random.default_rng(seed)
    syms = np.array(["C", "N", "O", "P"])
    with open(path, "w") as fh:
        pass
    import io

    buf = []
    for i in range(n):
        v = int(rng.integers(3, 40))
        mol = SimpleMolecule(
            coords=rng.uniform(-3, 3, (v, 3)),
            symbols=list(syms[rng.integers(0, 4, v)]),
            bonds=[], name=f"mol-{i}",
        )
        tmp = Path(path).with_suffix(f".tmp{i}")
        write_sdf(mol, tmp)
        buf.append(tmp.read_text())
        tmp.unlink()
    Path(path).write_text("".join(buf))
    return n


def _reference_sum(sdf, tmp_path):
    """Single-process grid sum over the whole file (independent code path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from molvoxel_tpu.core import GridSpec
    from molvoxel_tpu.data.feed import SDFBatchFeeder
    from molvoxel_tpu.ops.batch import voxelize_batch

    spec = GridSpec(resolution=0.5, dimension=16)
    feeder = SDFBatchFeeder(sdf, ["C", "N", "O"], batch_size=4, bucket=64, unknown=True)
    total = 0.0
    nmol = 0
    for b in feeder:
        keys = jax.random.split(jax.random.PRNGKey(0), b.batch_size)
        out = voxelize_batch(
            jnp.asarray(b.coords), jnp.asarray(b.weights), jnp.ones((64,), jnp.float32),
            jnp.asarray(b.mask), jnp.asarray(b.centers), keys, 0.0,
            spec=spec, density_type="gaussian", sigma=0.5,
        )
        total += float(jnp.sum(out))
        nmol += int((b.num_atoms > 0).sum())
    return total, nmol


def test_two_process_stream_end_to_end(tmp_path):
    """parse (striped) -> global DP batch -> voxelize -> per-host gridstore."""
    import numpy as np

    sdf = tmp_path / "lib.sdf"
    n = _fixture_sdf(sdf)
    store = tmp_path / "store"
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")
    }
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(STREAM_WORKER), str(port), str(pid), "2", str(sdf), str(store)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=str(STREAM_WORKER.parent.parent),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=220)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"STREAM process={pid}" in out, out

    # both per-host stores exist, identify themselves, and cover the file
    from molvoxel_tpu.data.gridstore import read_grid_shards

    total = 0.0
    nmol = 0
    for pid in range(2):
        grids, manifest = read_grid_shards(store / f"proc-{pid:03d}")
        assert manifest["process_index"] == pid
        assert manifest["num_processes"] == 2
        if manifest["num_molecules"]:
            total += float(np.asarray(grids, np.float32).sum())
        nmol += manifest["num_molecules"]
    want_sum, want_n = _reference_sum(sdf, tmp_path)
    assert nmol == want_n == n
    assert abs(total - want_sum) <= 1e-3 * max(abs(want_sum), 1.0), (total, want_sum)


def test_two_process_stream_crash_resume(tmp_path):
    """Fault model: fail-fast crash anywhere + restart with resume=True.

    Phase 1 crashes both workers after their first durably-flushed batch
    (provisional manifests on disk); phase 2 restarts with resume and must
    complete the library — skipping what survived — to the same checksum as
    an uninterrupted single-process run."""
    import numpy as np

    sdf = tmp_path / "lib.sdf"
    n = _fixture_sdf(sdf)
    store = tmp_path / "store"

    def launch(extra):
        port = _free_port()
        env = {
            k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES")
        }
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        procs = [
            subprocess.Popen(
                [sys.executable, str(STREAM_WORKER), str(port), str(pid), "2",
                 str(sdf), str(store), *extra],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                cwd=str(STREAM_WORKER.parent.parent),
            )
            for pid in range(2)
        ]
        return [p.communicate(timeout=220)[0] for p in procs], procs

    outs, procs = launch(["1"])  # crash after 1 durable batch
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert "CRASHED" in out, out
    # provisional manifests exist and hold a whole-batch prefix
    import json

    for pid in range(2):
        m = json.loads((store / f"proc-{pid:03d}" / "manifest.json").read_text())
        assert m.get("final") is False
        assert m["num_molecules"] > 0 and m["num_molecules"] % 4 == 0

    outs, procs = launch(["0", "resume"])  # restart, no crash
    total_skipped = 0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"STREAM process={pid}" in out, out
        total_skipped += int(out.split("skipped=")[1].split()[0])
    assert total_skipped >= 8  # both prefixes were actually skipped

    from molvoxel_tpu.data.gridstore import read_grid_shards

    total = 0.0
    nmol = 0
    for pid in range(2):
        grids, manifest = read_grid_shards(store / f"proc-{pid:03d}")
        assert manifest.get("final") is True
        if manifest["num_molecules"]:
            total += float(np.asarray(grids, np.float32).sum())
        nmol += manifest["num_molecules"]
    want_sum, want_n = _reference_sum(sdf, tmp_path)
    assert nmol == want_n == n
    assert abs(total - want_sum) <= 1e-3 * max(abs(want_sum), 1.0), (total, want_sum)
