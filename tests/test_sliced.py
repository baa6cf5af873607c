"""Full-grid assembly from depth slabs (ops/batch.py voxelize_batch_sliced).

The 256^3 configuration: batches of grids too large for the device run as
a sequential slab loop with host assembly — these tests prove the slab
path is bit-consistent with the single-launch full grid, on every surface
that composes with it (stream driver, CLI auto-pick, bf16, augmentation).
"""

import jax
import jax.numpy as jnp
import numpy as np

from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.ops.batch import pick_slab_depth, voxelize_batch, voxelize_batch_sliced

SPEC = GridSpec(resolution=0.5, dimension=16)


def cloud(rng, b=3, vp=128, v=25, c=3):
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    return jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(mask), keys


def test_slab_assembly_matches_full_grid(rng):
    coords, weights, mask, keys = cloud(rng)
    radii = jnp.ones((128,), jnp.float32)
    full = np.asarray(
        voxelize_batch(coords, weights, radii, mask, None, keys, 0.0, spec=SPEC)
    )
    sliced = voxelize_batch_sliced(
        coords, weights, radii, mask, None, keys, 0.0, spec=SPEC, slab_depth=4
    )
    np.testing.assert_allclose(sliced, full, atol=1e-6)


def test_slab_assembly_with_augmentation_is_consistent(rng):
    # every slab must see the SAME random transform (same keys)
    coords, weights, mask, keys = cloud(rng)
    radii = jnp.ones((128,), jnp.float32)
    full = np.asarray(
        voxelize_batch(coords, weights, radii, mask, None, keys, 0.3,
                       spec=SPEC, random_rotation=True)
    )
    sliced = voxelize_batch_sliced(
        coords, weights, radii, mask, None, keys, 0.3, spec=SPEC, slab_depth=8,
        random_rotation=True,
    )
    np.testing.assert_allclose(sliced, full, atol=1e-5)


def test_slab_assembly_bf16_out(rng):
    coords, weights, mask, keys = cloud(rng)
    radii = jnp.ones((128,), jnp.float32)
    sliced = voxelize_batch_sliced(
        coords, weights, radii, mask, None, keys, 0.0, spec=SPEC, slab_depth=4,
        out_dtype="bfloat16",
    )
    assert str(sliced.dtype) == "bfloat16"
    full = np.asarray(
        voxelize_batch(coords, weights, radii, mask, None, keys, 0.0, spec=SPEC,
                       out_dtype="bfloat16")
    )
    np.testing.assert_array_equal(
        np.asarray(sliced, np.float32), np.asarray(full, np.float32)
    )


def test_pick_slab_depth():
    limit = 60 * 2**30  # what an 80 GB card gives one JAX process
    assert pick_slab_depth(GridSpec(0.5, 64), 4, 64, bytes_limit=limit) is None
    assert pick_slab_depth(GridSpec(0.5, 128), 4, 1, bytes_limit=limit) is None
    slab = pick_slab_depth(GridSpec(0.5, 256), 4, 64, bytes_limit=limit)
    assert slab == 64  # largest divisor of 256 whose slab fits an eighth of the memory
    assert 64 * 4 * slab * 256 * 256 * 4 <= limit // 8
    # the CPU reports no memory limit and never slices
    assert pick_slab_depth(GridSpec(0.5, 256)) is None


def test_streaming_voxelizer_slab_mode(rng, tmp_path):
    from molvoxel_tpu.parallel import StreamingVoxelizer

    sv = StreamingVoxelizer(SPEC, batch_size=2, slab_depth=4)
    sv_ref = StreamingVoxelizer(SPEC, batch_size=2)
    clouds = [
        (rng.uniform(-2, 2, (10, 3)).astype(np.float32),
         rng.uniform(size=(10, 2)).astype(np.float32))
        for _ in range(4)
    ]
    got, want = [], []
    sv.run(iter(clouds), consumer=lambda im, b: got.append(np.asarray(im, np.float32)))
    sv_ref.run(iter(clouds), consumer=lambda im, b: want.append(np.asarray(im, np.float32)))
    np.testing.assert_allclose(
        np.concatenate(got), np.concatenate(want), atol=1e-6
    )
