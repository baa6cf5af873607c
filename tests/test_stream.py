"""Streaming driver tests: batching, consumer, metrics, checkpoint/resume."""

import numpy as np
import pytest

from molvoxel_tpu.data.fixtures import LIGAND_SDF
from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.parallel import StreamingVoxelizer, make_mesh

SPEC = GridSpec(resolution=0.5, dimension=16)


def make_clouds(rng, n, c=3):
    out = []
    for _ in range(n):
        v = int(rng.integers(5, 40))
        out.append(
            (rng.uniform(-3, 3, (v, 3)).astype(np.float32), rng.uniform(size=(v, c)).astype(np.float32))
        )
    return out


def test_stream_processes_all(rng):
    clouds = make_clouds(rng, 11)
    got = []

    def consumer(images, batch):
        got.append(np.asarray(images))

    sv = StreamingVoxelizer(SPEC, batch_size=4)
    stats = sv.run(clouds, consumer)
    assert stats.molecules == 11
    assert stats.batches == 3
    assert len(got) == 3
    assert got[0].shape == (4, 3, 16, 16, 16)
    # padded tail molecule produces a zero grid
    assert np.all(got[-1][-1] == 0)
    assert stats.mols_per_second > 0


def test_stream_results_match_direct(rng):
    import jax
    import jax.numpy as jnp

    from molvoxel_tpu.ops.dense import voxelize_dense

    clouds = make_clouds(rng, 2)
    results = []
    sv = StreamingVoxelizer(SPEC, batch_size=2)
    sv.run(clouds, lambda images, batch: results.append(np.asarray(images)))
    for i, (crd, w) in enumerate(clouds):
        want = np.asarray(
            voxelize_dense(
                jnp.asarray(crd), jnp.asarray(w), jnp.ones((crd.shape[0],), jnp.float32), spec=SPEC
            )
        )
        np.testing.assert_allclose(results[0][i], want, atol=1e-5)


def test_stream_checkpoint_resume(rng, tmp_path):
    clouds = make_clouds(rng, 8)
    ckpt = tmp_path / "manifest.json"

    sv = StreamingVoxelizer(SPEC, batch_size=2, checkpoint_path=ckpt, checkpoint_every=1)
    stats = sv.run(clouds[:4])
    assert stats.molecules == 4
    assert ckpt.exists()

    # resume: skips the first 4, processes the remaining 4
    sv2 = StreamingVoxelizer(SPEC, batch_size=2, checkpoint_path=ckpt)
    stats2 = sv2.run(clouds)
    assert stats2.skipped == 4
    assert stats2.molecules == 4


def test_stream_sharded_mesh(rng):
    clouds = make_clouds(rng, 16)
    mesh = make_mesh()
    sv = StreamingVoxelizer(SPEC, batch_size=8, mesh=mesh)
    got = []
    stats = sv.run(clouds, lambda images, batch: got.append(np.asarray(images)))
    assert stats.molecules == 16
    assert got[0].shape == (8, 3, 16, 16, 16)


def test_stream_checksum_radii_by_type(tmp_path):
    """Per-type radii in the fused step == per-atom radii through the batch
    path (gathered in-graph from the type lane, zero extra wire bytes)."""
    import jax

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.data.feed import SDFBatchFeeder
    from molvoxel_tpu.ops.batch import voxelize_batch
    from molvoxel_tpu.parallel.stream import stream_checksum

    rec = open(str(LIGAND_SDF), "rb").read()
    path = tmp_path / "lib.sdf"
    path.write_bytes(rec * 4)
    spec = GridSpec(resolution=0.5, dimension=16)
    rbt = (0.9, 1.2, 1.4, 1.7)

    batches = list(SDFBatchFeeder(path, ["C", "N", "O", "S"], batch_size=4, compact=True))
    _, cs = stream_checksum(iter(batches), spec, chunk=2, radii_by_type=rbt)
    _, cs_wire = stream_checksum(iter(batches), spec, chunk=2, radii_by_type=rbt, wire=True)

    (b,) = batches
    t = b.types
    mask = t >= 0
    w = np.eye(4, dtype=np.float32)[np.maximum(t, 0)] * mask[..., None]
    r = np.where(mask, np.asarray(rbt, np.float32)[np.maximum(t, 0)], 1.0)
    keys = jax.random.split(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 0), 2)
    want = 0.0
    for ci in range(2):
        sl = slice(ci * 2, (ci + 1) * 2)
        keys = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), ci), 2
        )
        out = voxelize_batch(
            np.asarray(b.coords[sl]), np.asarray(w[sl]), np.asarray(r[sl]),
            np.asarray(mask[sl]), np.asarray(b.centers[sl]), keys, 0.0,
            spec=spec, density_type="gaussian", sigma=0.5, radii_batched=True,
        )
        want += float(np.asarray(out, np.float64).sum())
    assert abs(cs - want) < 1e-2 * max(abs(want), 1.0)
    assert abs(cs_wire - want) < 1e-2 * max(abs(want), 1.0)
    # and it differs from the scalar-radii checksum (the radii actually bite)
    _, cs_scalar = stream_checksum(iter(batches), spec, chunk=2)
    assert abs(cs - cs_scalar) > 1e-3 * max(abs(cs), 1.0)


def test_witness_consumer_checksum_consistency(tmp_path, rng):
    """The witness consumer (r4 throughput protocol) produces a nonzero
    checksum that agrees between the wire and 3-array fused steps, and the
    full-read checksum strictly exceeds it (it sums every grid)."""
    import jax
    import jax.numpy as jnp

    from molvoxel_tpu.core import GridSpec
    from molvoxel_tpu.data.feed import pack_wire, wire_scale
    from molvoxel_tpu.data.pipeline import PaddedBatch
    from molvoxel_tpu.parallel.stream import _fused_scan_step, _fused_scan_step_wire

    spec = GridSpec(resolution=0.5, dimension=16)
    b, vp = 8, 64
    coords = rng.uniform(-3, 3, (b, vp, 3)).astype(np.float32)
    types = rng.integers(0, 4, (b, vp)).astype(np.int8)
    types[:, -8:] = -1
    kwargs = dict(chunk=4, num_channels=4, radii_value=1.0, random_translation=0.0,
                  spec=spec, density_type="gaussian", sigma=0.5, random_rotation=False,
                  out_dtype="float32")
    key = jax.random.PRNGKey(0)
    zc = jnp.zeros((b, 3), jnp.float32)

    full = float(_fused_scan_step(jnp.asarray(coords), jnp.asarray(types), zc, key,
                                  jnp.int32(0), **kwargs))
    wit = float(_fused_scan_step(jnp.asarray(coords), jnp.asarray(types), zc, key,
                                 jnp.int32(0), witness=True, **kwargs))
    assert 0 < wit < full

    scale = wire_scale(spec)
    batch = PaddedBatch(coords, None, types >= 0, None, None,
                        np.full((b,), vp, np.int32), types=types, num_channels=4)
    wit_wire = float(_fused_scan_step_wire(jnp.asarray(pack_wire(batch, scale)), key,
                                           jnp.int32(0), witness=True,
                                           inv_scale=1.0 / scale, **kwargs))
    assert wit_wire == pytest.approx(wit, rel=1e-3)
