"""Weak-scaling efficiency report: data-parallel voxelization over a mesh.

BASELINE.md sets a >=90%-efficiency multi-host target; the reference has no
distributed execution to compare against (SURVEY.md §2.5).  On several GPUs
it measures real scaling; on a virtual CPU mesh it validates the measurement
path only.

Per device count d in {1, 2, 4, ...}: build a (data=d) mesh over the first d
devices, voxelize a batch of d*B0 molecules per step (weak scaling: constant
work per device), time warm calls ended by block_until_ready
(utils/timing.py), report mols/s and efficiency vs d=1.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
          python benchmarks/scaling.py          # simulated 8-device mesh
      python benchmarks/scaling.py              # real devices
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from molvoxel_tpu.utils.timing import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import os  # noqa: E402

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax.numpy as jnp  # noqa: E402

from molvoxel_tpu.core.config import GridSpec  # noqa: E402
from molvoxel_tpu.parallel.mesh import make_mesh  # noqa: E402
from molvoxel_tpu.parallel.sharded import voxelize_batch_dp  # noqa: E402
from molvoxel_tpu.utils.timing import measure_device_fn  # noqa: E402


def measure_at(d: int, *, b0: int = 32, dim: int = 32, vp: int = 64, c: int = 4, iters: int = 17) -> float:
    """mols/s at d devices, b0 molecules per device per step."""
    mesh = make_mesh(data=d, devices=jax.devices()[:d])
    spec = GridSpec(resolution=0.5, dimension=dim)
    b = b0 * d
    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.uniform(-6, 6, (b, vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(size=(b, vp, c)).astype(np.float32))
    mask = jnp.ones((b, vp), bool)
    radii = jnp.ones((vp,), jnp.float32)

    def step(key):
        keys = jax.random.split(key, b)
        return voxelize_batch_dp(
            coords, weights, radii, mask, None, keys, 0.5,
            mesh=mesh, spec=spec, random_rotation=True, out_dtype="bfloat16",
        ).astype(jnp.float32)

    sec = measure_device_fn(step, iters=iters)
    return b / sec


def main() -> int:
    n = len(jax.devices())
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n]
    # the virtual CPU mesh oversubscribes 2 physical cores 8x: shrink the
    # workload so the harness validates in minutes (numbers are indicative
    # only there; the harness exists for real multi-chip hardware)
    kw = dict(b0=8, dim=16, iters=9) if jax.default_backend() == "cpu" else {}
    rows = []
    base = None
    for d in counts:
        mols = measure_at(d, **kw)
        base = mols if base is None else base
        eff = mols / (base * d)
        rows.append({"devices": d, "mols_per_s": round(mols, 1), "efficiency": round(eff, 3)})
        print(f"devices={d:3d}  {mols:12.1f} mols/s  weak-scaling efficiency {eff:6.1%}", flush=True)
    print(json.dumps({"metric": "weak_scaling", "backend": jax.default_backend(), "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
