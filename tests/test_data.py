"""Data-layer tests: parsers, getters, point-cloud makers, wrappers, pipeline."""

import numpy as np
import pytest

from molvoxel_tpu.data.fixtures import LIGAND_SDF, POCKET_PDB
from molvoxel_tpu import create_voxelizer
from molvoxel_tpu.data import (
    AtomTypeGetter,
    BondTypeGetter,
    ComplexPointCloudMaker,
    ComplexWrapper,
    FeatureGetter,
    MolPointCloudMaker,
    MolSystemPointCloudMaker,
    MolWrapper,
    SimpleMolecule,
    iter_batches,
    pad_point_clouds,
    read_pdb,
    read_sdf,
    types_to_onehot,
)
from molvoxel_tpu.data.parsers import write_pdb, write_sdf

REF_LIGAND = str(LIGAND_SDF)
REF_POCKET = str(POCKET_PDB)


def make_mol(rng, n=8, nb=4):
    coords = rng.uniform(-3, 3, (n, 3))
    symbols = [["C", "N", "O", "S"][i % 4] for i in range(n)]
    bonds = [(i, i + 1, ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"][i % 4]) for i in range(nb)]
    return SimpleMolecule(coords=coords, symbols=symbols, bonds=bonds, name="test")


class TestParsers:
    def test_read_sdf_fixture(self):
        mol = read_sdf(REF_LIGAND)
        assert mol.num_atoms == 61
        assert mol.num_bonds == 62
        assert mol.coords.shape == (61, 3)
        assert mol.symbols[0] == "N"
        np.testing.assert_allclose(mol.coords[0], [15.088, 10.798, 23.547], atol=1e-4)
        mids = mol.bond_midpoints()
        assert mids.shape == (62, 3)

    def test_read_pdb_fixture(self):
        mol = read_pdb(REF_POCKET)
        assert mol.num_atoms == 407
        assert set(mol.symbols) == {"C", "N", "O", "S"}
        assert mol.without_hydrogens().num_atoms == mol.num_atoms  # heavy atoms only
        lig = read_sdf(REF_LIGAND)
        noh = lig.without_hydrogens()
        assert noh.num_atoms == 33 < lig.num_atoms
        assert "H" not in noh.symbols

    def test_sdf_roundtrip(self, rng, tmp_path):
        mol = make_mol(rng)
        write_sdf(mol, tmp_path / "m.sdf")
        back = read_sdf(tmp_path / "m.sdf")
        assert back.symbols == mol.symbols
        assert [(i, j, t) for i, j, t in back.bonds] == mol.bonds
        np.testing.assert_allclose(back.coords, mol.coords, atol=1e-3)

    def test_pdb_roundtrip(self, rng, tmp_path):
        mol = make_mol(rng, nb=0)
        write_pdb(mol, tmp_path / "m.pdb")
        back = read_pdb(tmp_path / "m.pdb")
        assert back.symbols == mol.symbols
        np.testing.assert_allclose(back.coords, mol.coords, atol=1e-3)


class TestGetters:
    def test_atom_type_getter(self):
        g = AtomTypeGetter(["C", "N", "O", "S"])
        assert g.num_channels == 4
        assert g.get_type("N") == 1
        assert g.get_feature("O") == [0.0, 0.0, 1.0, 0.0]
        with pytest.raises(KeyError):
            g.get_type("Fe")

    def test_unknown_channel(self):
        g = AtomTypeGetter(["C", "N"], unknown=True)
        assert g.num_channels == 3
        assert g.channels[-1] == "Unknown"
        assert g.get_type("Fe") == 2

    def test_bond_type_getter_default(self):
        g = BondTypeGetter.default()
        assert g.num_channels == 4
        assert g.channels == ["SingleBond", "DoubleBond", "TripleBond", "AromaticBond"]
        assert g.get_type("AROMATIC") == 3

    def test_to_feature_getter(self):
        g = AtomTypeGetter(["C", "N"]).to_feature_getter()
        assert isinstance(g, FeatureGetter)
        assert g.get_feature("N") == [0.0, 1.0]


class TestMakers:
    def test_atoms_only_types(self, rng):
        mol = make_mol(rng)
        maker = MolPointCloudMaker(AtomTypeGetter(["C", "N", "O", "S"]), None, channel_type="types")
        coords, types = maker.run(mol)
        assert coords.shape == (8, 3)
        assert types.shape == (8,)
        assert types.dtype == np.int32
        assert list(types[:4]) == [0, 1, 2, 3]

    def test_bond_midpoints_appended(self, rng):
        mol = make_mol(rng, n=8, nb=4)
        maker = MolPointCloudMaker(
            AtomTypeGetter(["C", "N", "O", "S"]), BondTypeGetter.default(), channel_type="types"
        )
        coords, types = maker.run(mol)
        assert coords.shape == (12, 3)
        np.testing.assert_allclose(coords[8], (mol.coords[0] + mol.coords[1]) / 2)
        # bond types offset by atom channel count
        assert list(types[8:]) == [4, 5, 6, 7]
        assert maker.num_channels == 8

    def test_features_onehot_layout(self, rng):
        mol = make_mol(rng, n=4, nb=2)
        maker = MolPointCloudMaker(
            AtomTypeGetter(["C", "N", "O", "S"]), BondTypeGetter.default(), channel_type="features"
        )
        coords, feats = maker.run(mol)
        assert feats.shape == (6, 8)
        assert feats[0, 0] == 1.0 and feats[0, 1:].sum() == 0
        assert feats[4, 4] == 1.0  # first bond: SINGLE -> channel 4
        assert feats[5, 5] == 1.0  # second bond: DOUBLE -> channel 5

    def test_coords_override(self, rng):
        # reference Q4: coords override via kwargs is broken there; works here
        mol = make_mol(rng)
        maker = MolPointCloudMaker(AtomTypeGetter(["C", "N", "O", "S"]), None, channel_type="types")
        custom = np.zeros((8, 3))
        coords, _ = maker.run(mol, coords=custom)
        assert coords is custom

    def test_system_maker_channel_offsets(self, rng):
        lig, prot = make_mol(rng, n=4, nb=0), make_mol(rng, n=6, nb=0)
        ag = AtomTypeGetter(["C", "N", "O", "S"])
        maker = MolSystemPointCloudMaker((ag, None), (ag, None), channel_type="types")
        assert maker.num_channels == 8
        coords, types = maker.run([lig, prot])
        assert coords.shape == (10, 3)
        assert types[:4].max() < 4 and types[4:].min() >= 4

    def test_split_channel(self, rng):
        mol = make_mol(rng, n=4, nb=0)
        maker = MolPointCloudMaker(AtomTypeGetter(["C", "N", "O", "S"]), None, channel_type="features")
        image = np.arange(4 * 2 * 2 * 2).reshape(4, 2, 2, 2)
        d = maker.split_channel(image)
        assert list(d.keys()) == ["C", "N", "O", "S"]
        np.testing.assert_array_equal(d["N"], image[1])


class TestWrappers:
    def test_mol_wrapper_end_to_end(self, rng):
        mol = make_mol(rng)
        maker = MolPointCloudMaker(
            AtomTypeGetter(["C", "N", "O", "S"]), BondTypeGetter.default(), channel_type="features"
        )
        vox = create_voxelizer(resolution=0.5, dimension=16)
        wrapper = MolWrapper(maker, vox)
        out = wrapper.run(mol, center=mol.coords.mean(0), radii=1.0)
        assert out.shape == (8, 16, 16, 16)
        assert out.max() > 0

    def test_complex_wrapper_matches_manual(self, rng):
        lig = read_sdf(REF_LIGAND).without_hydrogens()
        pocket = read_pdb(REF_POCKET).without_hydrogens()
        ag = AtomTypeGetter(["C", "N", "O", "S"])
        maker = ComplexPointCloudMaker(ag, None, ag, None, channel_type="types")
        vox = create_voxelizer(resolution=0.5, dimension=24)
        wrapper = ComplexWrapper(maker, vox)
        center = lig.coords.mean(0)
        out = wrapper.run(lig, pocket, center=center, radii=1.0)
        assert out.shape == (8, 24, 24, 24)

        coords, types = maker.run([lig, pocket])
        manual = vox.forward_types(
            vox.asarray(coords, "coords"), vox.asarray(center, "center"), vox.asarray(types, "types"), 1.0
        )
        np.testing.assert_allclose(out, manual, atol=1e-6)

    def test_wrapper_types_vs_features_consistency(self, rng):
        # the reference sanity assertion (test_time_numpy.py:67-69)
        lig = read_sdf(REF_LIGAND).without_hydrogens()
        ag = AtomTypeGetter(["C", "N", "O", "S"])
        bg = BondTypeGetter.default()
        vox = create_voxelizer(resolution=0.5, dimension=24)
        w_t = MolWrapper(MolPointCloudMaker(ag, bg, channel_type="types"), vox)
        w_f = MolWrapper(MolPointCloudMaker(ag, bg, channel_type="features"), vox)
        center = lig.coords.mean(0)
        np.testing.assert_allclose(
            w_t.run(lig, center=center, radii=1.0), w_f.run(lig, center=center, radii=1.0), atol=1e-5
        )


class TestPipeline:
    def test_pad_point_clouds(self, rng):
        clouds = [
            (rng.uniform(-3, 3, (v, 3)).astype(np.float32), rng.uniform(size=(v, 4)).astype(np.float32))
            for v in [5, 60, 33]
        ]
        batch = pad_point_clouds(clouds)
        assert batch.coords.shape == (3, 64, 3)  # small-molecule bucket
        assert batch.mask.sum() == 5 + 60 + 33
        assert list(batch.num_atoms) == [5, 60, 33]
        assert batch.weights[0, 5:].sum() == 0

    def test_types_to_onehot(self):
        oh = types_to_onehot(np.asarray([0, 2, 1]), 3)
        np.testing.assert_array_equal(oh, [[1, 0, 0], [0, 0, 1], [0, 1, 0]])

    def test_iter_batches_pads_tail(self, rng):
        clouds = [
            (rng.uniform(-3, 3, (9, 3)).astype(np.float32), rng.uniform(size=(9, 2)).astype(np.float32))
            for _ in range(5)
        ]
        batches = list(iter_batches(clouds, batch_size=2))
        assert len(batches) == 3
        assert batches[-1].mask[1].sum() == 0  # padded empty molecule

    def test_batch_feeds_ops(self, rng):
        import jax
        import jax.numpy as jnp

        from molvoxel_tpu.core import GridSpec
        from molvoxel_tpu.ops.batch import voxelize_batch

        clouds = [
            (rng.uniform(-3, 3, (v, 3)).astype(np.float32), rng.uniform(size=(v, 4)).astype(np.float32))
            for v in [5, 20]
        ]
        batch = pad_point_clouds(clouds)
        keys = jax.random.split(jax.random.PRNGKey(0), batch.batch_size)
        out = voxelize_batch(
            jnp.asarray(batch.coords), jnp.asarray(batch.weights), jnp.ones((batch.padded_atoms,), jnp.float32),
            jnp.asarray(batch.mask), None, keys, 0.0,
            spec=GridSpec(0.5, 16), impl="dense",
        )
        assert out.shape == (2, 4, 16, 16, 16)


class TestSystemWrapperRadii:
    def test_atomwise_per_mol_scalar_list(self, rng):
        # reference wrapper.py:105-114: per-molecule scalar radii expand per point
        from molvoxel_tpu.data import MolSystemPointCloudMaker, MolSystemWrapper

        lig, prot = make_mol(rng, n=4, nb=2), make_mol(rng, n=6, nb=0)
        ag = AtomTypeGetter(["C", "N", "O", "S"])
        bg = BondTypeGetter.default()
        maker = MolSystemPointCloudMaker((ag, bg), (ag, None), channel_type="features")
        vox = create_voxelizer(resolution=0.5, dimension=16, radii_type="atom-wise")
        wrapper = MolSystemWrapper(maker, vox, name_list=["A", "B"])
        out = wrapper.run([lig, prot], radii=[1.0, 1.5])
        assert out.shape == (12, 16, 16, 16)

        # manual expansion: 6 points (4 atoms + 2 bonds) at 1.0, 6 atoms at 1.5
        coords, feats = maker.run([lig, prot])
        radii = np.concatenate([np.full(6, 1.0), np.full(6, 1.5)]).astype(np.float32)
        manual = vox.forward_features(
            vox.asarray(coords, "coords"), None, vox.asarray(feats, "features"), radii
        )
        np.testing.assert_allclose(out, manual, atol=1e-6)

    def test_channelwise_radii_list_concat(self, rng):
        from molvoxel_tpu.data import MolSystemPointCloudMaker, MolSystemWrapper

        lig, prot = make_mol(rng, n=4, nb=0), make_mol(rng, n=6, nb=0)
        ag = AtomTypeGetter(["C", "N", "O", "S"])
        maker = MolSystemPointCloudMaker((ag, None), (ag, None), channel_type="features")
        vox = create_voxelizer(resolution=0.5, dimension=16, radii_type="channel-wise")
        wrapper = MolSystemWrapper(maker, vox, name_list=["A", "B"])
        r1 = rng.uniform(0.8, 1.4, 4).astype(np.float32)
        r2 = rng.uniform(0.8, 1.4, 4).astype(np.float32)
        out = wrapper.run([lig, prot], radii=[r1, r2])
        assert out.shape == (8, 16, 16, 16)


class TestTransformFacade:
    def test_get_transform_reusable(self, rng):
        import jax

        from molvoxel_tpu.core import RandomTransform

        t = RandomTransform(0.5, True)
        concrete = t.get_transform(jax.random.PRNGKey(5))
        coords = rng.normal(size=(7, 3)).astype(np.float32)
        a = np.asarray(concrete(coords))
        b = np.asarray(concrete(coords))
        np.testing.assert_array_equal(a, b)  # a concrete T is deterministic
        # and respects the center argument (rotation about centroid)
        center = coords.mean(0)
        c = np.asarray(concrete(coords, center))
        np.testing.assert_allclose(c.mean(0) - concrete.translation, center, atol=1e-5)


def test_apply_coords_simple(rng):
    from molvoxel_tpu.data.rdkit_adapter import apply_coords

    mol = make_mol(rng)
    new = rng.normal(size=(mol.num_atoms, 3))
    out = apply_coords(mol, new)
    np.testing.assert_allclose(out.coords, new)
    assert out.symbols == mol.symbols and out.bonds == mol.bonds
    assert mol.coords is not out.coords  # original untouched


class TestParserRobustness:
    def test_sdf_with_property_block(self, tmp_path):
        sdf = (
            "mol1\n  prog\ncomment\n"
            "  2  1  0  0  0  0  0  0  0  0999 V2000\n"
            "    0.0000    0.0000    0.0000 C   0  0  0  0  0\n"
            "    1.5000    0.0000    0.0000 O   0  0  0  0  0\n"
            "  1  2  2  0\n"
            "M  CHG  1   2  -1\n"
            "M  END\n"
            ">  <LogP>\n2.5\n\n"
            ">  <Name>\nsomething\n\n"
            "$$$$\n"
            "mol2\n  prog\ncomment\n"
            "  1  0  0  0  0  0  0  0  0  0999 V2000\n"
            "    9.0000    9.0000    9.0000 N   0  0  0  0  0\n"
            "M  END\n$$$$\n"
        )
        path = tmp_path / "props.sdf"
        path.write_text(sdf)
        from molvoxel_tpu.data.parsers import iter_sdf

        mols = list(iter_sdf(path))
        assert len(mols) == 2
        assert mols[0].symbols == ["C", "O"]
        assert mols[0].bonds == [(0, 1, "DOUBLE")]
        assert mols[1].symbols == ["N"]
        np.testing.assert_allclose(mols[1].coords[0], [9, 9, 9])

        if True:  # native parser agrees
            from molvoxel_tpu.native import NATIVE_AVAILABLE, parse_sdf_buffer

            if NATIVE_AVAILABLE:
                nmols = parse_sdf_buffer(sdf.encode())
                assert len(nmols) == 2
                assert nmols[0].symbols == mols[0].symbols
                assert nmols[1].symbols == mols[1].symbols

    def test_pdb_multimodel_reads_first(self, tmp_path):
        pdb = (
            "MODEL        1\n"
            "ATOM      1  CA  ALA A   1       1.000   2.000   3.000  1.00  0.00           C\n"
            "ENDMDL\n"
            "MODEL        2\n"
            "ATOM      1  CA  ALA A   1       9.000   9.000   9.000  1.00  0.00           C\n"
            "ENDMDL\n"
            "END\n"
        )
        path = tmp_path / "m.pdb"
        path.write_text(pdb)
        mol = read_pdb(path)
        assert mol.num_atoms == 1
        np.testing.assert_allclose(mol.coords[0], [1, 2, 3])

    def test_pdb_element_from_atom_name(self, tmp_path):
        # no element columns: fall back to the atom-name field
        line = "ATOM      1  CA  ALA A   1       1.000   2.000   3.000"
        path = tmp_path / "short.pdb"
        path.write_text(line + "\nEND\n")
        mol = read_pdb(path)
        assert mol.symbols == ["C"]

    def test_empty_sdf(self, tmp_path):
        path = tmp_path / "empty.sdf"
        path.write_text("")
        from molvoxel_tpu.data.parsers import iter_sdf

        assert list(iter_sdf(path)) == []


class TestXYZ:
    """XYZ parsing (QM9-style multi-record, Fortran exponents)."""

    def test_roundtrip_and_multirecord(self, tmp_path):
        from molvoxel_tpu.data import iter_xyz, read_molecule, read_xyz, write_xyz
        from molvoxel_tpu.data.parsers import SimpleMolecule

        mol = SimpleMolecule(
            coords=np.array([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.0, 1.1, 0.0]]),
            symbols=["C", "O", "H"], bonds=[], name="test mol",
        )
        p = tmp_path / "one.xyz"
        write_xyz(mol, p)
        got = read_xyz(p)
        assert got.symbols == ["C", "O", "H"] and got.name == "test mol"
        np.testing.assert_allclose(got.coords, mol.coords, atol=1e-8)
        assert read_molecule(p).num_atoms == 3

        # multi-record with QM9 quirks: extra columns + Fortran exponent
        (tmp_path / "multi.xyz").write_text(
            "2\nrec1\nC 0.0 0.0 0.0 -0.53\nH 1.0*^-1 0.0 2.5*^-2 0.12\n"
            "1\nrec2\nN 1.0 2.0 3.0\n"
        )
        mols = list(iter_xyz(tmp_path / "multi.xyz"))
        assert [m.num_atoms for m in mols] == [2, 1]
        np.testing.assert_allclose(mols[0].coords[1], [0.1, 0.0, 0.025])
        assert mols[1].symbols == ["N"]

    def test_xyz_voxelizes_through_wrapper(self, tmp_path):
        from molvoxel_tpu import create_voxelizer
        from molvoxel_tpu.data import AtomTypeGetter, MolPointCloudMaker, MolWrapper, read_xyz
        from molvoxel_tpu.data.parsers import SimpleMolecule, write_xyz

        mol = SimpleMolecule(
            coords=np.random.default_rng(0).uniform(-2, 2, (8, 3)),
            symbols=["C", "N", "O", "C", "C", "O", "N", "C"], bonds=[], name="x",
        )
        p = tmp_path / "m.xyz"
        write_xyz(mol, p)
        maker = MolPointCloudMaker(AtomTypeGetter(["C", "N", "O"]), None, channel_type="types")
        vox = create_voxelizer(resolution=0.5, dimension=16)
        img = MolWrapper(maker, vox).run(read_xyz(p), center=mol.coords.mean(0), radii=1.0)
        assert img.shape == (3, 16, 16, 16) and float(np.abs(img).sum()) > 0


class TestMol2:
    """Tripos MOL2 parsing (docking-ecosystem format)."""

    MOL2 = """@<TRIPOS>MOLECULE
benzene-ish
 4 3 0 0 0
SMALL
NO_CHARGES
@<TRIPOS>ATOM
      1 C1    0.0000  0.0000  0.0000 C.ar  1 LIG1  0.0
      2 C2    1.4000  0.0000  0.0000 C.ar  1 LIG1  0.0
      3 N1    2.1000  1.2000  0.0000 N.3   1 LIG1 -0.3
      4 H1    0.5000  0.9000  0.0000 H     1 LIG1  0.1
@<TRIPOS>BOND
     1    1    2 ar
     2    2    3 1
     3    1    4 1
"""

    def test_parse_and_channels(self, tmp_path):
        from molvoxel_tpu.data import read_mol2, read_molecule

        p = tmp_path / "lig.mol2"
        p.write_text(self.MOL2)
        mol = read_mol2(p)
        assert mol.symbols == ["C", "C", "N", "H"] and mol.name == "benzene-ish"
        assert mol.bonds == [(0, 1, "AROMATIC"), (1, 2, "SINGLE"), (0, 3, "SINGLE")]
        np.testing.assert_allclose(mol.coords[1], [1.4, 0.0, 0.0])
        noh = mol.without_hydrogens()
        assert noh.num_atoms == 3 and len(noh.bonds) == 2
        assert read_molecule(p).num_atoms == 4

    def test_multirecord_and_wrapper(self, tmp_path):
        from molvoxel_tpu import create_voxelizer
        from molvoxel_tpu.data import (AtomTypeGetter, BondTypeGetter,
                                       MolPointCloudMaker, MolWrapper, iter_mol2)

        p = tmp_path / "two.mol2"
        p.write_text(self.MOL2 + self.MOL2)
        mols = list(iter_mol2(p))
        assert len(mols) == 2
        maker = MolPointCloudMaker(AtomTypeGetter(["C", "N"]), BondTypeGetter.default(),
                                   channel_type="features")
        vox = create_voxelizer(resolution=0.5, dimension=16)
        img = MolWrapper(maker, vox).run(mols[0].without_hydrogens(),
                                         center=mols[0].coords.mean(0), radii=1.0)
        assert img.shape == (6, 16, 16, 16) and float(np.abs(img).sum()) > 0


class TestV3000:
    """SDF V3000 (the >999-atom extension) via the python parser."""

    V3 = """big mol
  program
  comment
  0  0  0     0  0            999 V3000
M  V30 BEGIN CTAB
M  V30 COUNTS 3 2 0 0 0
M  V30 BEGIN ATOM
M  V30 1 C 0.0 0.0 0.0 0
M  V30 2 O 1.2 0.0 0.0 0
M  V30 7 N 0.0 1.3 0.0 0
M  V30 END ATOM
M  V30 BEGIN BOND
M  V30 1 2 1 2
M  V30 2 1 2 7
M  V30 END BOND
M  V30 END CTAB
M  END
$$$$
"""

    def test_parse_v3000(self, tmp_path):
        from molvoxel_tpu.data import read_sdf
        from molvoxel_tpu.native.fastparse import parse_sdf_buffer

        p = tmp_path / "big.sdf"
        p.write_text(self.V3)
        mol = read_sdf(p)
        assert mol.symbols == ["C", "O", "N"]
        assert mol.bonds == [(0, 1, "DOUBLE"), (1, 2, "SINGLE")]  # idx 7 remapped to 2
        np.testing.assert_allclose(mol.coords[2], [0.0, 1.3, 0.0])
        # native entry point falls back to python for V3000 buffers
        mols = parse_sdf_buffer(self.V3.encode())
        assert len(mols) == 1 and mols[0].symbols == ["C", "O", "N"]

    def test_mixed_v2000_v3000_stream(self, tmp_path):
        from molvoxel_tpu.data import iter_sdf
        from molvoxel_tpu.data.feed import SDFBatchFeeder

        v2 = open(REF_LIGAND).read()
        if not v2.endswith("\n"):
            v2 += "\n"
        p = tmp_path / "mix.sdf"
        p.write_text(v2 + self.V3 + v2)
        mols = list(iter_sdf(p))
        assert [m.num_atoms for m in mols] == [61, 3, 61]
        # the feeder routes V3000-containing shards through the python parser
        feeder = SDFBatchFeeder(p, ["C", "N", "O", "S"], batch_size=3, compact=True)
        (batch,) = list(feeder)
        assert feeder.records_fed == 3
        assert sorted(batch.num_atoms.tolist(), reverse=True) == [33, 33, 3]  # H-stripped ligands + V3000 mol


class TestPDBModels:
    """Multi-MODEL PDB iteration (NMR ensembles / MD snapshots)."""

    def test_single_model_unchanged(self):
        from molvoxel_tpu.data import iter_pdb_models, read_pdb

        mols = list(iter_pdb_models(REF_POCKET))
        assert len(mols) == 1
        ref = read_pdb(REF_POCKET)
        assert mols[0].num_atoms == ref.num_atoms == 407

    def test_nmr_ensemble(self, tmp_path):
        from molvoxel_tpu.data import iter_pdb_models

        body = (
            "MODEL        1\n"
            "ATOM      1  N   ALA A   1      10.000  10.000  10.000  1.00  0.00           N\n"
            "ATOM      2  CA  ALA A   1      11.000  10.000  10.000  1.00  0.00           C\n"
            "ENDMDL\n"
            "MODEL        2\n"
            "ATOM      1  N   ALA A   1      10.100  10.000  10.000  1.00  0.00           N\n"
            "ATOM      2  CA  ALA A   1      11.100  10.000  10.000  1.00  0.00           C\n"
            "ENDMDL\n"
            "END\n"
        )
        p = tmp_path / "ens.pdb"
        p.write_text(body)
        mols = list(iter_pdb_models(p))
        assert len(mols) == 2
        assert mols[0].symbols == ["N", "C"] and mols[1].name.endswith("model-2")
        np.testing.assert_allclose(mols[1].coords[0, 0] - mols[0].coords[0, 0], 0.1, atol=1e-6)

    def test_empty_model_yields_0x3_coords(self, tmp_path):
        # degenerate MODEL/ENDMDL pair must still carry (0, 3) coords so
        # downstream coords[:, 0] indexing cannot crash
        from molvoxel_tpu.data import iter_pdb_models

        body = (
            "MODEL        1\n"
            "ENDMDL\n"
            "MODEL        2\n"
            "ATOM      1  N   ALA A   1      10.000  10.000  10.000  1.00  0.00           N\n"
            "ENDMDL\n"
        )
        p = tmp_path / "empty_model.pdb"
        p.write_text(body)
        mols = list(iter_pdb_models(p))
        assert mols[0].coords.shape == (0, 3)
        assert mols[1].coords.shape == (1, 3)


class TestMalformedInputs:
    """Truncated/malformed files fail with clear errors, not IndexErrors."""

    def test_truncated_xyz(self, tmp_path):
        from molvoxel_tpu.data import read_xyz

        p = tmp_path / "t.xyz"
        p.write_text("5\ncomment\nC 0 0 0\n")
        with pytest.raises(ValueError, match="claims 5 atoms"):
            read_xyz(p)
        p.write_text("2\ncomment\nC 0 0 0\nN 1 1\n")
        with pytest.raises(ValueError, match="truncated atom row"):
            read_xyz(p)
        p.write_text("nonsense\n")
        with pytest.raises(ValueError, match="atom count"):
            read_xyz(p)

    def test_truncated_mol2(self, tmp_path):
        from molvoxel_tpu.data import read_mol2

        p = tmp_path / "t.mol2"
        p.write_text("@<TRIPOS>MOLECULE\nx\n 3 0\nSMALL\n\n@<TRIPOS>ATOM\n1 C1 0 0 0 C\n")
        with pytest.raises(ValueError, match="claims 3 atoms"):
            read_mol2(p)
        p.write_text("@<TRIPOS>MOLECULE\nx\n 1 1\nSMALL\n\n@<TRIPOS>ATOM\n"
                     "1 C1 0 0 0 C\n@<TRIPOS>BOND\n1 1\n")
        with pytest.raises(ValueError, match="truncated bond row"):
            read_mol2(p)
