"""Small-bucket batches (32/64 atoms) on the deposit kernel match the dense path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.core.config import small_atom_bucket
from molvoxel_tpu.ops.batch import voxelize_batch

SPEC = GridSpec(resolution=0.5, dimension=16)


def test_small_atom_bucket():
    assert small_atom_bucket(10) == 32
    assert small_atom_bucket(32) == 32
    assert small_atom_bucket(33) == 64
    assert small_atom_bucket(64) == 64
    assert small_atom_bucket(65) == 128
    assert small_atom_bucket(200) == 256


@pytest.mark.parametrize("vp,b", [(64, 4), (64, 5), (32, 8), (32, 3)])
def test_packed_matches_dense(rng, vp, b):
    c, v = 3, vp - 7
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    radii = jnp.ones((vp,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)

    got = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), radii, jnp.asarray(mask),
        None, keys, 0.0, spec=SPEC, impl="pallas",
    )
    want = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), radii, jnp.asarray(mask),
        None, keys, 0.0, spec=SPEC, impl="dense",
    )
    assert got.shape == (b, c, 16, 16, 16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_packed_batched_radii(rng):
    b, vp, c, v = 4, 64, 2, 50
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    radii = np.ones((b, vp), np.float32)
    radii[:, :v] = rng.uniform(0.8, 1.5, (b, v))
    keys = jax.random.split(jax.random.PRNGKey(0), b)

    got = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), jnp.asarray(mask),
        None, keys, 0.0, spec=SPEC, impl="pallas", radii_batched=True,
    )
    want = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), jnp.asarray(mask),
        None, keys, 0.0, spec=SPEC, impl="dense", radii_batched=True,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_packed_notrunc_matches_dense(rng):
    b, vp, c, v = 4, 64, 3, 55
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    radii = jnp.ones((vp,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    got = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), radii, jnp.asarray(mask),
        None, keys, 0.0, spec=SPEC, density_type="gaussian_notrunc",
    )
    want = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), radii, jnp.asarray(mask),
        None, keys, 0.0, spec=SPEC, density_type="gaussian", impl="dense",
    )
    assert got.shape == want.shape
    from molvoxel_tpu.ops.dense import voxelize_dense

    want_nt = voxelize_dense(
        jnp.asarray(coords[0]), jnp.asarray(weights[0]), radii,
        spec=SPEC, density_type="gaussian_notrunc", mask=jnp.asarray(mask[0]),
    )
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want_nt), atol=1e-4)


@pytest.mark.parametrize("vp", [40, 100])
def test_atom_count_off_chunk_multiple(rng, vp):
    # the wrapper pads V to a whole number of atom chunks with masked atoms
    b, c, v = 3, 2, vp - 3
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.broadcast_to(np.arange(vp) < v, (b, vp))
    keys = jax.random.split(jax.random.PRNGKey(2), b)
    args = (jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32), jnp.asarray(mask), None, keys, 1.0)
    got = voxelize_batch(*args, spec=SPEC, impl="pallas", random_rotation=True)
    want = voxelize_batch(*args, spec=SPEC, impl="dense", random_rotation=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("vp,c,b", [(64, 1, 9), (64, 3, 4), (64, 2, 6), (32, 1, 5)])
def test_channel_aligned_packing_matches_dense(rng, vp, c, b):
    v = vp - 5
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    radii = jnp.ones((vp,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), b)

    for density in ("gaussian", "binary", "gaussian_notrunc"):
        got = voxelize_batch(
            jnp.asarray(coords), jnp.asarray(weights), radii, jnp.asarray(mask),
            None, keys, 0.0, spec=SPEC, impl="pallas", density_type=density,
        )
        want = voxelize_batch(
            jnp.asarray(coords), jnp.asarray(weights), radii, jnp.asarray(mask),
            None, keys, 0.0, spec=SPEC, impl="dense", density_type=density,
        )
        assert got.shape == (b, c, 16, 16, 16)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
