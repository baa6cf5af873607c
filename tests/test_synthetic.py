"""The vendored fixture and the seeded synthetic inputs (molvoxel_tpu.data)."""

from pathlib import Path

import numpy as np

from molvoxel_tpu.data.fixtures import LIGAND_SDF, POCKET_PDB
from molvoxel_tpu.data.parsers import iter_sdf, read_pdb, read_sdf
from molvoxel_tpu.data.synthetic import library_atom_counts, random_protein, write_library_sdf

GOLDENS = Path(__file__).parent / "goldens"


def test_fixture_coordinates_are_the_goldens():
    lig = np.load(GOLDENS / "lig_types_gaussian.npz")
    pocket = np.load(GOLDENS / "pocket_types_gaussian.npz")
    np.testing.assert_allclose(read_sdf(LIGAND_SDF).coords, lig["coords"], atol=1e-4)
    np.testing.assert_allclose(read_pdb(POCKET_PDB).coords, pocket["coords"][61:], atol=1e-3)
    # element channels agree with the goldens' C/N/O/other typing
    table = {"C": 0, "N": 1, "O": 2}
    types = [table.get(s, 3) for s in read_pdb(POCKET_PDB).symbols]
    np.testing.assert_array_equal(types, pocket["channels"][61:] - 4)


def test_random_protein_is_seeded_and_protein_dense():
    a, b = random_protein(seed=3), random_protein(seed=3)
    np.testing.assert_array_equal(a.coords, b.coords)
    assert a.num_atoms == 3262 and set(a.symbols) <= {"C", "N", "O", "S"}
    radius = np.linalg.norm(a.coords, axis=1)
    assert radius.max() <= 20.0
    density = a.num_atoms / (4.0 / 3.0 * np.pi * 20.0**3)
    assert 0.08 < density < 0.12  # atoms per cubic angstrom of a folded protein


def test_library_counts_are_heavy_tailed_in_range():
    counts = library_atom_counts(5000, seed=1)
    assert counts.min() >= 10 and counts.max() <= 70
    assert np.median(counts) < counts.mean()  # right-skewed
    assert (counts >= 50).sum() > 0


def test_library_sdf_round_trips(tmp_path):
    path = tmp_path / "lib.sdf"
    counts = write_library_sdf(path, 50, seed=2)
    mols = list(iter_sdf(path))
    assert [m.num_atoms for m in mols] == list(counts)
    assert all(m.num_bonds == m.num_atoms - 1 for m in mols)
    steps = np.linalg.norm(np.diff(mols[0].coords, axis=0), axis=1)
    np.testing.assert_allclose(steps, 1.5, atol=1e-3)
