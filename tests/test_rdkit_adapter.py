"""RDKit bridge tests — skipped when RDKit is not installed.

The getters/makers accept RDKit objects by duck typing regardless; this file
exercises the explicit conversions when the dependency is present.
"""

import numpy as np
import pytest

from molvoxel_tpu.data.fixtures import LIGAND_SDF
from molvoxel_tpu.data.rdkit_adapter import RDKIT_AVAILABLE

pytestmark = pytest.mark.skipif(not RDKIT_AVAILABLE, reason="rdkit not installed")


def test_roundtrip(rng):
    from molvoxel_tpu.data.rdkit_adapter import from_rdkit, to_rdkit

    from .test_data import make_mol

    mol = make_mol(rng, n=6, nb=3)
    rd = to_rdkit(mol)
    back = from_rdkit(rd)
    assert back.symbols == mol.symbols
    assert back.bonds == mol.bonds
    np.testing.assert_allclose(back.coords, mol.coords, atol=1e-6)


def test_load_and_voxelize():
    from molvoxel_tpu import create_voxelizer
    from molvoxel_tpu.data import AtomTypeGetter, MolPointCloudMaker, MolWrapper
    from molvoxel_tpu.data.rdkit_adapter import load_rdkit_mol

    rdmol = load_rdkit_mol(str(LIGAND_SDF))
    maker = MolPointCloudMaker(AtomTypeGetter(["C", "N", "O", "S"], unknown=True), None, "features")
    vox = create_voxelizer(resolution=0.5, dimension=16)
    wrapper = MolWrapper(maker, vox)
    out = wrapper.run(rdmol, center=None, radii=1.0)
    assert out.shape == (5, 16, 16, 16)
