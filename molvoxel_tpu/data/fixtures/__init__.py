"""Vendored fixture: the ligand and pocket of one protein-ligand complex.

- ``ligand.sdf``: 61 atoms (33 heavy: C, N, O, S; 28 H) and 62 bonds.
- ``pocket.pdb``: 407 heavy atoms (C, N, O, S) as HETATM records.

Coordinates are those stored with the parity goldens (tests/goldens: the
ligand and the hydrogen-free pocket of PDB entry 10GS).  Element symbols come
from the goldens' channel index, with S and H told apart by bond length;
bonds are inferred from interatomic distances (double below 1.28 A,
aromatic for the two phenyl rings).
"""

from pathlib import Path

FIXTURES = Path(__file__).parent
LIGAND_SDF = FIXTURES / "ligand.sdf"
POCKET_PDB = FIXTURES / "pocket.pdb"
