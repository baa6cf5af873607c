"""Headline benchmark: ligand voxelizations/s, 64^3 grid x 4 channels, gaussian.

Workload: the vendored fixture ligand (61 atoms, molvoxel_tpu/data/fixtures)
in batches of 64, with a fresh random rotation and 0.5 A translation per
molecule per call (the reference timing protocol's augmentation), at
64^3 x 4 channels, gaussian sigma 0.5, through ``voxelize_batch`` with the
default routing.

Lanes: the exact cutoff gaussian with bf16 (headline), fp8 and f32 grids,
and the no-cutoff gaussian (the reference torch backend's semantics) with
bf16 and f32 grids.

Timing: each lane is compiled and run once, then timed over warm calls, each
on fresh keys and ended by ``block_until_ready`` (utils/timing.py); the
median call time gives mols/s.  Prints ONE JSON line that names the device.
Needs a GPU: on any other backend it exits without a result.

Run:  python bench.py
"""

import json
import subprocess
import sys

import numpy as np

from molvoxel_tpu.data.fixtures import LIGAND_SDF


def card() -> str:
    """`name, power limit` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    from molvoxel_tpu.utils.timing import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.data.parsers import read_sdf
    from molvoxel_tpu.ops.batch import voxelize_batch
    from molvoxel_tpu.utils.timing import measure_device_fn

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")

    spec = GridSpec(resolution=0.5, dimension=64)
    batch, vp = 64, 64
    lig = read_sdf(str(LIGAND_SDF))
    lc = (lig.coords - lig.coords.mean(0)).astype(np.float32)
    v, c = lc.shape[0], 4

    rng = np.random.default_rng(0)
    coords = np.zeros((batch, vp, 3), np.float32)
    coords[:, :v] = lc[None, :, :]
    weights = np.zeros((batch, vp, c), np.float32)
    weights[:, :v] = (rng.uniform(size=(batch, v, c)) < 0.3).astype(np.float32)
    radii = jnp.ones((vp,), jnp.float32)
    mask = np.zeros((batch, vp), bool)
    mask[:, :v] = True
    coords, weights, mask = jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(mask)

    def mols_per_s(density, out_dtype):
        def step(key):
            keys = jax.random.split(key, batch)
            return voxelize_batch(
                coords, weights, radii, mask, None, keys, 0.5,
                spec=spec, density_type=density, sigma=0.5,
                random_rotation=True, out_dtype=out_dtype,
            )

        return batch / measure_device_fn(step, iters=50)

    exact_bf16 = mols_per_s("gaussian", "bfloat16")
    print(
        json.dumps(
            {
                "metric": "ligand_voxelizations_per_s_64c4_gaussian",
                "value": exact_bf16,
                "unit": "mols/s",
                "out_dtype": "bfloat16",
                "fp8_mols_per_s": mols_per_s("gaussian", "float8_e4m3fn"),
                "f32_mols_per_s": mols_per_s("gaussian", "float32"),
                "notrunc_mols_per_s": mols_per_s("gaussian_notrunc", "bfloat16"),
                "notrunc_f32_mols_per_s": mols_per_s("gaussian_notrunc", "float32"),
                "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
                "card": card(),
            }
        )
    )


if __name__ == "__main__":
    main()
