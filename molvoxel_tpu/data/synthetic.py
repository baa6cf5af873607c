"""Seeded synthetic inputs at the sizes users run.

- ``random_protein``: a protein-sized heavy-atom cloud, uniform in a sphere.
  At the defaults (3,262 atoms, radius 20 A) the density is about 0.1 atoms
  per cubic angstrom, that of a folded protein.
- ``write_library_sdf``: a screening library of drug-sized molecules with
  heavy-tailed heavy-atom counts, as one multi-record SDF.

Element proportions follow protein and drug-like compositions (mostly C,
then N and O, a little S).  Geometry is a self-avoiding-ish random walk with
1.5 A bonds: not chemistry, but the sizes, spacings and channel mix the
voxelizer sees.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .parsers import SimpleMolecule, sdf_record

ELEMENTS = ["C", "N", "O", "S"]
PROTEIN_FRACTIONS = [0.63, 0.17, 0.19, 0.01]
LIGAND_FRACTIONS = [0.72, 0.13, 0.13, 0.02]


def random_protein(n_atoms: int = 3262, radius: float = 20.0, seed: int = 0) -> SimpleMolecule:
    """``n_atoms`` heavy atoms uniform in a sphere of ``radius`` angstroms."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_atoms, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    coords = u * radius * rng.uniform(size=(n_atoms, 1)) ** (1.0 / 3.0)
    symbols = list(rng.choice(ELEMENTS, size=n_atoms, p=PROTEIN_FRACTIONS))
    return SimpleMolecule(coords=coords, symbols=symbols, name="protein")


def random_ligand(rng: np.random.Generator, n_atoms: int, name: str = "") -> SimpleMolecule:
    """A chain of ``n_atoms`` heavy atoms, 1.5 A apart, bonded in sequence."""
    steps = rng.normal(size=(n_atoms, 3))
    steps = 1.5 * steps / np.linalg.norm(steps, axis=1, keepdims=True)
    steps[0] = 0.0
    coords = np.cumsum(steps, axis=0)
    symbols = list(rng.choice(ELEMENTS, size=n_atoms, p=LIGAND_FRACTIONS))
    bonds = [(i, i + 1, "SINGLE") for i in range(n_atoms - 1)]
    return SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name=name)


def library_atom_counts(n_mols: int, seed: int = 0, lo: int = 10, hi: int = 70) -> np.ndarray:
    """Heavy-tailed heavy-atom counts in [lo, hi]: log-normal around 25."""
    rng = np.random.default_rng(seed)
    counts = np.exp(rng.normal(np.log(25.0), 0.4, size=n_mols))
    return np.clip(np.rint(counts), lo, hi).astype(int)


def write_library_sdf(path: str | Path, n_mols: int, seed: int = 0, lo: int = 10, hi: int = 70) -> np.ndarray:
    """Write ``n_mols`` random ligands to one SDF; returns their atom counts."""
    counts = library_atom_counts(n_mols, seed, lo, hi)
    rng = np.random.default_rng(seed + 1)
    with open(path, "w") as fh:
        for i, n in enumerate(counts):
            fh.write(sdf_record(random_ligand(rng, int(n), name=f"mol{i}")))
    return counts
