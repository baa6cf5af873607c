"""gaussian_notrunc density mode: oracle parity, API surface, batch/shard paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from molvoxel_tpu import create_voxelizer
from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.ops.batch import voxelize_batch
from molvoxel_tpu.ops.dense import voxelize_dense
from molvoxel_tpu.ops.separable import voxelize_separable

from .oracle import grid_points

SPEC = GridSpec(resolution=0.5, dimension=16)


def oracle_notrunc(coords, weights, radii, resolution, dimension, sigma=0.5, channelwise=False):
    pts = grid_points(resolution, dimension)
    d2 = (((np.asarray(coords, np.float64)[:, None, :] - pts[None]) ** 2).sum(-1))
    weights = np.asarray(weights, np.float64)
    v, c = weights.shape
    if channelwise:
        out = np.empty((c, pts.shape[0]))
        for ci in range(c):
            dens = np.exp(-0.5 * d2 / (radii[ci] ** 2 * sigma**2))
            out[ci] = weights[:, ci] @ dens
    else:
        r = np.broadcast_to(np.asarray(radii, np.float64), (v,))
        dens = np.exp(-0.5 * d2 / (r[:, None] ** 2 * sigma**2))
        out = weights.T @ dens
    return out.reshape(c, dimension, dimension, dimension)


def test_separable_matches_oracle(rng):
    coords = rng.uniform(-2, 2, (20, 3)).astype(np.float32)
    weights = rng.uniform(size=(20, 3)).astype(np.float32)
    radii = rng.uniform(0.8, 1.5, size=(20,)).astype(np.float32)
    got = np.asarray(
        voxelize_separable(jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), spec=SPEC, sigma=0.5)
    )
    want = oracle_notrunc(coords, weights, radii, 0.5, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_separable_channelwise_matches_oracle(rng):
    coords = rng.uniform(-2, 2, (15, 3)).astype(np.float32)
    weights = rng.uniform(size=(15, 4)).astype(np.float32)
    radii = np.asarray([0.8, 1.0, 1.2, 1.5], np.float32)
    got = np.asarray(
        voxelize_separable(
            jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
            spec=SPEC, sigma=0.5, channelwise_radii=True,
        )
    )
    want = oracle_notrunc(coords, weights, radii, 0.5, 16, channelwise=True)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_matches_dense_notrunc_path(rng):
    # the slab dense path with density_sq(gaussian_notrunc) is the second
    # implementation of the same semantics
    coords = jnp.asarray(rng.uniform(-2, 2, (20, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(size=(20, 3)).astype(np.float32))
    radii = jnp.ones((20,), jnp.float32)
    a = np.asarray(voxelize_separable(coords, weights, radii, spec=SPEC, sigma=0.5))
    b = np.asarray(voxelize_dense(coords, weights, radii, spec=SPEC, density_type="gaussian_notrunc", sigma=0.5))
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_api_surface(rng):
    vox = create_voxelizer(resolution=0.5, dimension=16, density_type="gaussian_notrunc")
    assert vox.density_type == "gaussian_notrunc"
    coords = rng.uniform(-2, 2, (10, 3)).astype(np.float32)
    feats = rng.uniform(size=(10, 2)).astype(np.float32)
    out = vox.forward_features(coords, None, feats, 1.0)
    assert out.shape == (2, 16, 16, 16)
    # no cutoff: strictly positive everywhere
    assert out.min() > 0

    types = rng.integers(0, 2, size=(10,)).astype(np.int32)
    out_t = vox.forward_types(coords, None, types, 1.0)
    onehot = np.eye(2, dtype=np.float32)[types]
    out_f = vox.forward_features(coords, None, onehot, 1.0)
    np.testing.assert_allclose(out_t, out_f, atol=1e-5)

    out_s = vox.forward_single(coords, None, 1.0)
    assert out_s.shape == (1, 16, 16, 16)


def test_density_setter():
    vox = create_voxelizer(resolution=0.5, dimension=16)
    vox.density_type = "gaussian_notrunc"
    assert vox.density_type == "gaussian_notrunc"
    with pytest.raises(AssertionError):
        vox.density_type = "bogus"


def test_batch_path(rng):
    b, vp, v, c = 3, 128, 20, 3
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-2, 2, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    out = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32),
        jnp.asarray(mask), None, keys, 0.0,
        spec=SPEC, density_type="gaussian_notrunc",
    )
    assert out.shape == (b, c, 16, 16, 16)
    want = oracle_notrunc(coords[0, :v], weights[0, :v], 1.0, 0.5, 16)
    np.testing.assert_allclose(np.asarray(out[0]), want, atol=1e-4)


def test_depth_sharded_notrunc(rng):
    from molvoxel_tpu.parallel import make_mesh, voxelize_depth_sharded

    mesh = make_mesh(data=1, depth=8)
    coords = jnp.asarray(rng.uniform(-2, 2, (12, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(size=(12, 2)).astype(np.float32))
    radii = jnp.ones((12,), jnp.float32)
    out = voxelize_depth_sharded(
        coords, weights, radii, None, None, jax.random.PRNGKey(0), 0.0,
        mesh=mesh, spec=SPEC, density_type="gaussian_notrunc", impl="dense",
    )
    want = np.asarray(voxelize_separable(coords, weights, radii, spec=SPEC, sigma=0.5))
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_pallas_notrunc_matches_separable(rng):
    # the pruned kernel lane (underflow-radius thresh, coef from the true
    # radius) must reproduce the separable/no-cutoff semantics
    from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas

    v, vp, c = 25, 128, 3
    coords = np.zeros((vp, 3), np.float32)
    coords[:v] = rng.uniform(-2.5, 2.5, (v, 3))
    weights = np.zeros((vp, c), np.float32)
    weights[:v] = rng.uniform(size=(v, c))
    radii = np.ones((vp,), np.float32)
    radii[:v] = rng.uniform(0.7, 1.6, size=(v,))
    mask = np.zeros((vp,), bool)
    mask[:v] = True
    got = np.asarray(
        voxelize_pallas(
            jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
            spec=SPEC, density_type="gaussian_notrunc", sigma=0.5, mask=jnp.asarray(mask),
        )
    )
    want = np.asarray(
        voxelize_separable(
            jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
            spec=SPEC, sigma=0.5, mask=jnp.asarray(mask),
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_notrunc_thresh_is_conservative():
    # worst case for the eps-pruning bound: many atoms stacked far from a
    # voxel — the summed dropped tail must stay under V * eps << 1e-5
    from molvoxel_tpu.ops.pallas_deposit import NOTRUNC_EPS, notrunc_r2_thresh

    r2 = np.float32(1.0)
    th = float(notrunc_r2_thresh(r2, 0.5))
    # density exactly at the cutoff distance equals eps
    dens = np.exp(-0.5 * th / (1.0 * 0.25))
    assert dens == pytest.approx(NOTRUNC_EPS, rel=1e-3)


def test_batch_routes_large_v_to_pallas(rng, monkeypatch):
    # at protein scale the batch path must route notrunc through the pruned
    # kernel and still match the separable result
    import molvoxel_tpu.ops.voxelize as vx

    b, vp, v, c = 1, 1024, 300, 2
    monkeypatch.setattr(vx, "NOTRUNC_KERNEL_MIN_ATOMS", 1024)
    monkeypatch.setattr(vx, "NOTRUNC_KERNEL_MIN_DIM", 16)
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-2.5, 2.5, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    from molvoxel_tpu.ops.separable import voxelize_separable_batch

    got = voxelize_batch(
        jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32),
        jnp.asarray(mask), None, keys, 0.0,
        spec=SPEC, density_type="gaussian_notrunc", impl="pallas",
    )
    want = voxelize_separable_batch(
        jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32),
        spec=SPEC, sigma=0.5, mask=jnp.asarray(mask),
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
