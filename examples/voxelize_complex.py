"""End-to-end example: the reference's protein-ligand complex workflow.

Mirrors /root/reference/test/test_run_numpy.py: build a ComplexWrapper over
the 10gs ligand + pocket, voxelize types and features channels, and emit a
PyMOL session (or a .pml script + OpenDX volumes when PyMOL is absent).

Run:  python examples/voxelize_complex.py [output_dir]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from molvoxel_tpu import create_voxelizer
from molvoxel_tpu.data import (
    AtomTypeGetter,
    BondTypeGetter,
    ComplexPointCloudMaker,
    ComplexWrapper,
    read_pdb,
    read_sdf,
)
from molvoxel_tpu.data.fixtures import LIGAND_SDF, POCKET_PDB
from molvoxel_tpu.viz import Visualizer

OUT = Path(sys.argv[1]) if len(sys.argv) > 1 else Path("voxelize_complex_artifacts")


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    ligand = read_sdf(LIGAND_SDF).without_hydrogens()
    pocket = read_pdb(POCKET_PDB).without_hydrogens()
    center = ligand.coords.mean(0)

    atom_getter = AtomTypeGetter(["C", "N", "O", "S"])
    bond_getter = BondTypeGetter.default()

    # same channel layout as the reference test harness
    maker = ComplexPointCloudMaker(atom_getter, bond_getter, atom_getter, None, channel_type="features")
    voxelizer = create_voxelizer(resolution=0.5, dimension=48, density_type="gaussian")
    wrapper = ComplexWrapper(maker, voxelizer, visualizer=Visualizer())

    image = wrapper.run(ligand, pocket, center=center, radii=1.0)
    print(f"image: {image.shape}, occupied voxels: {(image > 0.1).sum()}")

    np.savez_compressed(OUT / "complex.npz", image=image, channels=np.asarray(maker.channels))
    result = wrapper.visualize(str(OUT / "complex.pse"), ligand, pocket, image, center)
    print(f"session artifacts: {result}")

    # reproducible augmentation: same key -> same transform
    import jax

    key = jax.random.PRNGKey(7)
    aug1 = wrapper.run(ligand, pocket, center=center, radii=1.0, random_translation=0.5,
                       random_rotation=True, key=key)
    aug2 = wrapper.run(ligand, pocket, center=center, radii=1.0, random_translation=0.5,
                       random_rotation=True, key=key)
    assert np.allclose(aug1, aug2)
    print("augmentation reproducible by key: OK")


if __name__ == "__main__":
    main()
