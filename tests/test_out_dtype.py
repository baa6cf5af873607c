"""bf16 output lane: tolerance goldens + API plumbing.

out_dtype="bfloat16" halves the grid bytes written: the deposit kernel
accumulates in f32 and narrows only its store (ops/pallas_deposit.py); the
separable path runs a bf16 einsum.  Accuracy contract: accumulation stays
f32; only input/output quantization at 2^-8 relative applies — so every
bf16 grid must match its f32 twin within ~1% relative, and the f32 paths
must be bit-identical to before (the parity suite enforces that separately).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from molvoxel_tpu.core.config import GridSpec
from molvoxel_tpu.ops.batch import voxelize_batch

SPEC = GridSpec(resolution=0.5, dimension=16)


def _inputs(b=3, v=256, c=4, seed=0):
    rng = np.random.default_rng(seed)
    coords = jnp.asarray(rng.uniform(-3.5, 3.5, (b, v, 3)).astype(np.float32))
    weights = jnp.asarray((rng.uniform(size=(b, v, c)) < 0.3).astype(np.float32))
    mask = jnp.asarray(rng.uniform(size=(b, v)) < 0.9)
    keys = jax.random.split(jax.random.PRNGKey(1), b)
    return coords, weights, mask, keys


def _run(density, impl, out_dtype, channelwise=False, v=256, c=4):
    coords, weights, mask, keys = _inputs(v=v, c=c)
    radii = jnp.full((c,) if channelwise else (v,), 1.0, jnp.float32)
    return voxelize_batch(
        coords, weights, radii, mask, None, keys, 0.0,
        spec=SPEC, density_type=density, sigma=0.5, channelwise=channelwise,
        impl=impl, out_dtype=out_dtype,
    )


@pytest.mark.parametrize("impl", ["pallas", "dense"])
@pytest.mark.parametrize("density", ["gaussian", "binary", "gaussian_notrunc"])
def test_bf16_matches_f32_within_quantization(impl, density):
    f32 = _run(density, impl, "float32")
    bf = _run(density, impl, "bfloat16")
    assert bf.dtype == jnp.bfloat16
    assert f32.dtype == jnp.float32
    ref = np.asarray(f32)
    got = np.asarray(bf, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=0.015 * scale)


@pytest.mark.parametrize("density", ["gaussian", "gaussian_notrunc"])
def test_bf16_channelwise(density):
    f32 = _run(density, "pallas", "float32", channelwise=True)
    bf = _run(density, "pallas", "bfloat16", channelwise=True)
    assert bf.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(bf, np.float32), np.asarray(f32), atol=0.015 * max(1.0, float(np.abs(f32).max()))
    )


def test_bf16_small_molecule_packed_path():
    # vp=64: the small-molecule bucket
    f32 = _run("gaussian", "pallas", "float32", v=64)
    bf = _run("gaussian", "pallas", "bfloat16", v=64)
    assert bf.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(bf, np.float32), np.asarray(f32), atol=0.015 * max(1.0, float(np.abs(f32).max()))
    )


@pytest.mark.parametrize("impl", ["pallas", "dense"])
@pytest.mark.parametrize("density", ["gaussian", "gaussian_notrunc"])
def test_fp8_matches_f32_within_quantization(impl, density):
    """fp8 (e4m3) output lane: halves the bf16 write wall again.  Tolerance =
    e4m3's 2^-4 relative quantization (plus bf16 matmul inputs underneath)."""
    f32 = _run(density, impl, "float32")
    lo = _run(density, impl, "float8_e4m3fn")
    assert lo.dtype == jnp.float8_e4m3fn
    ref = np.asarray(f32)
    got = np.asarray(lo, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=0.08 * scale)


def test_fp8_small_molecule_packed_path():
    f32 = _run("gaussian", "pallas", "float32", v=64)
    lo = _run("gaussian", "pallas", "float8_e4m3fn", v=64)
    assert lo.dtype == jnp.float8_e4m3fn
    np.testing.assert_allclose(
        np.asarray(lo, np.float32), np.asarray(f32),
        atol=0.08 * max(1.0, float(np.abs(f32).max())),
    )


def test_materialize_honored_on_channelwise_separable():
    # regression for ADVICE r1: materialize was silently dropped here
    coords, weights, mask, keys = _inputs()
    radii = jnp.full((4,), 1.0, jnp.float32)
    kw = dict(spec=SPEC, density_type="gaussian_notrunc", sigma=0.5, channelwise=True, impl="auto")
    plain = voxelize_batch(coords, weights, radii, mask, None, keys, 0.0, **kw)
    fenced = voxelize_batch(coords, weights, radii, mask, None, keys, 0.0, materialize=True, **kw)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(fenced))


def test_materialize_honored_on_dense_path():
    coords, weights, mask, keys = _inputs()
    radii = jnp.ones((256,), jnp.float32)
    kw = dict(spec=SPEC, density_type="gaussian", sigma=0.5, impl="dense")
    plain = voxelize_batch(coords, weights, radii, mask, None, keys, 0.0, **kw)
    fenced = voxelize_batch(coords, weights, radii, mask, None, keys, 0.0, materialize=True, **kw)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(fenced))


def test_forward_batch_out_dtype_and_num_channels():
    from molvoxel_tpu import create_voxelizer

    vox = create_voxelizer(resolution=0.5, dimension=16, seed=3)
    rng = np.random.default_rng(5)
    clouds = [
        (rng.uniform(-3, 3, (17, 3)).astype(np.float32), rng.integers(0, 3, (17,)))
        for _ in range(4)
    ]
    # explicit num_channels pins the output channel count (> batch max+1)
    out = vox.forward_batch(clouds, radii=1.0, num_channels=7)
    assert out.shape == (4, 7, 16, 16, 16)

    out_bf = vox.forward_batch(clouds, radii=1.0, num_channels=7, out_dtype="bfloat16")
    assert out_bf.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        out_bf.astype(np.float32), out, atol=0.015 * max(1.0, float(np.abs(out).max()))
    )


def test_precision64_without_x64_warns():
    from molvoxel_tpu import create_voxelizer

    with pytest.warns(UserWarning, match="x64 is disabled"):
        create_voxelizer(resolution=0.5, dimension=16, precision=64)
