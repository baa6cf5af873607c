"""Pallas deposit kernel parity vs the dense XLA path (interpret mode on CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.ops import voxelize_dense, voxelize_dense_channelwise
from tests.oracle import voxelize_oracle

from molvoxel_tpu.ops.pallas_deposit import (
    voxelize_pallas,
    voxelize_pallas_batch,
    voxelize_pallas_channelwise,
)

SPEC = GridSpec(resolution=0.5, dimension=16)


def padded_cloud(rng, v=30, vp=128, c=5):
    coords = np.zeros((vp, 3), np.float32)
    coords[:v] = rng.uniform(-3.0, 3.0, size=(v, 3))
    weights = np.zeros((vp, c), np.float32)
    weights[:v] = rng.uniform(0.0, 1.0, size=(v, c))
    radii = np.ones((vp,), np.float32)
    radii[:v] = rng.uniform(0.7, 1.8, size=(v,))
    mask = np.zeros((vp,), bool)
    mask[:v] = True
    return (jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii), jnp.asarray(mask))


@pytest.mark.parametrize("density", ["gaussian", "binary"])
def test_pallas_matches_dense(rng, density):
    coords, weights, radii, mask = padded_cloud(rng)
    got = np.asarray(
        voxelize_pallas(coords, weights, radii, spec=SPEC, density_type=density, sigma=0.5, mask=mask)
    )
    want = np.asarray(
        voxelize_dense(coords, weights, radii, spec=SPEC, density_type=density, sigma=0.5, mask=mask)
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("density", ["gaussian", "binary"])
def test_pallas_channelwise_matches_dense(rng, density):
    coords, weights, _, mask = padded_cloud(rng, c=4)
    radii_c = jnp.asarray([0.8, 1.0, 1.4, 2.0], dtype=jnp.float32)
    got = np.asarray(
        voxelize_pallas_channelwise(
            coords, weights, radii_c, spec=SPEC, density_type=density, sigma=0.5, mask=mask
        )
    )
    want = np.asarray(
        voxelize_dense_channelwise(
            coords, weights, radii_c, spec=SPEC, density_type=density, sigma=0.5, mask=mask
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_multi_atom_chunk(rng):
    # Vp = 256 spans many atom chunks: the per-brick chunk loop accumulates
    coords, weights, radii, mask = padded_cloud(rng, v=200, vp=256, c=3)
    got = np.asarray(voxelize_pallas(coords, weights, radii, spec=SPEC, mask=mask))
    want = np.asarray(voxelize_dense(coords, weights, radii, spec=SPEC, mask=mask))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_nonaligned_hw(rng):
    # dimension 12 is not a multiple of the 8^3 brick: masked edge stores
    spec = GridSpec(resolution=0.5, dimension=12)
    coords, weights, radii, mask = padded_cloud(rng, v=20)
    got = np.asarray(voxelize_pallas(coords, weights, radii, spec=spec, mask=mask))
    want = np.asarray(voxelize_dense(coords, weights, radii, spec=spec, mask=mask))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_many_channels(rng):
    # C=14: one accumulator per channel, all in one program
    coords, weights, radii, mask = padded_cloud(rng, c=14)
    got = np.asarray(voxelize_pallas(coords, weights, radii, spec=SPEC, mask=mask))
    want = np.asarray(voxelize_dense(coords, weights, radii, spec=SPEC, mask=mask))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dim", [7, 12, 20, 24])
def test_bricks_overhanging_the_grid(rng, dim):
    # dimensions that are not multiples of the 8^3 brick: masked edge stores
    spec = GridSpec(resolution=0.5, dimension=dim)
    coords, weights, radii, mask = padded_cloud(rng, v=40, vp=64, c=3)
    got = np.asarray(
        voxelize_pallas_batch(coords[None], weights[None], radii, spec=spec, mask=mask[None])
    )[0]
    want = np.asarray(voxelize_dense(coords, weights, radii, spec=spec, mask=mask))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_batched_matches_dense(rng):
    import jax

    from molvoxel_tpu.ops.batch import voxelize_batch
    from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_batch

    b, vp, v, c = 3, 128, 30, 5
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-3, 3, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    radii = np.ones((vp,), np.float32)
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    got = np.asarray(
        voxelize_pallas_batch(
            jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
            spec=SPEC, density_type="gaussian", sigma=0.5, mask=jnp.asarray(mask),
        )
    )
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    want = np.asarray(
        voxelize_batch(
            jnp.asarray(coords), jnp.asarray(weights), jnp.asarray(radii),
            jnp.asarray(mask), None, keys, 0.0, spec=SPEC, impl="dense",
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_depth_slab(rng):
    coords, weights, radii, mask = padded_cloud(rng)
    full = np.asarray(voxelize_pallas(coords, weights, radii, spec=SPEC, mask=mask))
    lower = np.asarray(
        voxelize_pallas(coords, weights, radii, spec=SPEC, mask=mask, d_offset=0, d_count=8)
    )
    upper = np.asarray(
        voxelize_pallas(coords, weights, radii, spec=SPEC, mask=mask, d_offset=8, d_count=8)
    )
    np.testing.assert_allclose(np.concatenate([lower, upper], axis=1), full, atol=1e-6)


@pytest.mark.parametrize("vp", [32, 64])
def test_subchunk_atom_bucket(rng, vp):
    """vp of the unbatched API's small-molecule buckets (32/64) deposits
    exactly, with padded atoms inside the last chunk."""
    from molvoxel_tpu.ops.pallas_deposit import (
        voxelize_pallas, voxelize_pallas_channelwise)

    spec = GridSpec(resolution=0.5, dimension=16)
    v, c = vp - 3, 3
    coords = np.zeros((vp, 3), np.float32)
    coords[:v] = rng.uniform(-3, 3, (v, 3))
    weights = np.zeros((vp, c), np.float32)
    weights[:v] = rng.uniform(size=(v, c))
    mask = np.zeros((vp,), bool)
    mask[:v] = True

    got = voxelize_pallas(
        jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32),
        spec=spec, mask=jnp.asarray(mask))
    want = voxelize_oracle(coords[:v], weights[:v], 1.0, 0.5, 16)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)

    gotc = voxelize_pallas_channelwise(
        jnp.asarray(coords), jnp.asarray(weights), jnp.ones((c,), jnp.float32),
        spec=spec, mask=jnp.asarray(mask))
    wantc = voxelize_oracle(coords[:v], weights[:v], np.ones(c), 0.5, 16,
                            channelwise_radii=True)
    np.testing.assert_allclose(np.asarray(gotc), wantc, atol=1e-5)


def test_pallas_channelwise_many_channels(rng):
    # large-C expansion (17 virtual chunks) against the dense path
    coords, weights, _, mask = padded_cloud(rng, c=17)
    radii_c = jnp.asarray(np.linspace(0.7, 2.0, 17), dtype=jnp.float32)
    got = np.asarray(
        voxelize_pallas_channelwise(
            coords, weights, radii_c, spec=SPEC, density_type="gaussian", sigma=0.5, mask=mask
        )
    )
    want = np.asarray(
        voxelize_dense_channelwise(
            coords, weights, radii_c, spec=SPEC, density_type="gaussian", sigma=0.5, mask=mask
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_channelwise_notrunc_matches_separable(rng):
    from molvoxel_tpu.ops.separable import voxelize_separable

    coords, weights, _, mask = padded_cloud(rng, c=3)
    radii_c = jnp.asarray([0.8, 1.1, 1.5], dtype=jnp.float32)
    got = np.asarray(
        voxelize_pallas_channelwise(
            coords, weights, radii_c, spec=SPEC, density_type="gaussian_notrunc", sigma=0.5, mask=mask
        )
    )
    want = np.asarray(
        voxelize_separable(
            coords, weights, radii_c, spec=SPEC, sigma=0.5, mask=mask, channelwise_radii=True
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pallas_channelwise_bf16_out(rng):
    from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_batch_channelwise

    coords, weights, _, mask = padded_cloud(rng, c=4)
    radii_c = jnp.asarray([0.8, 1.0, 1.4, 2.0], dtype=jnp.float32)
    f32 = np.asarray(
        voxelize_pallas_batch_channelwise(
            coords[None], weights[None], radii_c, spec=SPEC, density_type="gaussian",
            sigma=0.5, mask=mask[None],
        )
    )
    bf16 = np.asarray(
        voxelize_pallas_batch_channelwise(
            coords[None], weights[None], radii_c, spec=SPEC, density_type="gaussian",
            sigma=0.5, mask=mask[None], out_dtype="bfloat16",
        ).astype(jnp.float32)
    )
    assert bf16.dtype == np.float32
    # bf16 grids track f32 within the 2^-8 relative quantization floor
    np.testing.assert_allclose(bf16, f32, atol=1e-2, rtol=1e-2)
