"""The README quick-start snippets must actually run."""

import numpy as np
from molvoxel_tpu.data.fixtures import LIGAND_SDF


def test_quickstart_snippet():
    from molvoxel_tpu import create_voxelizer

    voxelizer = create_voxelizer(resolution=0.5, dimension=16,
                                 radii_type="scalar", density_type="gaussian")

    coords = np.random.randn(30, 3).astype(np.float32)
    center = coords.mean(0)
    features = np.random.rand(30, 5).astype(np.float32)

    image = voxelizer.forward_features(coords, center, features, radii=1.0,
                                       random_translation=0.5, random_rotation=True)
    assert image.shape == (5, 16, 16, 16)

    types = np.random.randint(0, 5, size=(30,))
    image = voxelizer.forward_types(coords, center, types, radii=1.0)
    image = voxelizer.forward_single(coords, center, radii=1.0)
    assert image.shape == (1, 16, 16, 16)


def test_chemistry_snippet():
    from molvoxel_tpu import create_voxelizer
    from molvoxel_tpu.data import (AtomTypeGetter, BondTypeGetter,
                                   MolPointCloudMaker, MolWrapper, read_sdf)

    mol = read_sdf(str(LIGAND_SDF))
    maker = MolPointCloudMaker(AtomTypeGetter(["C", "N", "O", "S"], unknown=True),
                               BondTypeGetter.default(), channel_type="features")
    voxelizer = create_voxelizer(resolution=0.5, dimension=16)
    wrapper = MolWrapper(maker, voxelizer)
    image = wrapper.run(mol, center=mol.coords.mean(0), radii=1.0)
    assert image.shape == (9, 16, 16, 16)


def test_batched_sharded_snippet(rng):
    import jax

    from molvoxel_tpu.core import GridSpec
    from molvoxel_tpu.data import pad_point_clouds
    from molvoxel_tpu.parallel import make_mesh, voxelize_batch_dp

    clouds = [
        (rng.uniform(-3, 3, (20, 3)).astype(np.float32), rng.uniform(size=(20, 4)).astype(np.float32))
        for _ in range(8)
    ]
    batch = pad_point_clouds(clouds)
    mesh = make_mesh()
    keys = jax.random.split(jax.random.PRNGKey(0), batch.batch_size)
    import jax.numpy as jnp

    grids = voxelize_batch_dp(
        jnp.asarray(batch.coords), jnp.asarray(batch.weights),
        jnp.ones((batch.padded_atoms,), jnp.float32), jnp.asarray(batch.mask),
        None, keys, 0.5, mesh=mesh, spec=GridSpec(0.5, 16), random_rotation=True,
    )
    assert grids.shape == (8, 4, 16, 16, 16)
