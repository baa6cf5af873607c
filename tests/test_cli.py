"""CLI smoke tests."""

import json

import numpy as np

from molvoxel_tpu.data.fixtures import POCKET_PDB
from molvoxel_tpu.cli import main

from .test_data import REF_LIGAND


def test_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "molvoxel-tpu" in out
    assert "jax" in out


def test_voxelize_npz(tmp_path):
    out = tmp_path / "grids.npz"
    rc = main(
        [
            "voxelize", REF_LIGAND, "-o", str(out),
            "--dimension", "16", "--channels", "C,N,O,S", "--unknown",
        ]
    )
    assert rc == 0
    data = np.load(out)
    assert data["grids"].shape == (1, 5, 16, 16, 16)
    assert list(data["channels"]) == ["C", "N", "O", "S", "Unknown"]
    assert data["grids"].max() > 0


def test_voxelize_dx(tmp_path):
    dxdir = tmp_path / "dx"
    rc = main(
        ["voxelize", REF_LIGAND, "--dx", str(dxdir), "--dimension", "16", "--channels", "C,N,O,S"]
    )
    assert rc == 0
    assert len(list(dxdir.glob("*.dx"))) == 4


def test_voxelize_pdb(tmp_path):
    out = tmp_path / "pocket.npz"
    rc = main(
        [
            "voxelize", str(POCKET_PDB),
            "-o", str(out), "--dimension", "16", "--channels", "C,N,O,S",
        ]
    )
    assert rc == 0
    assert np.load(out)["grids"].shape == (1, 4, 16, 16, 16)


_ALLH_RECORD = (
    "allh\n  gen\n\n"
    "  2  0  0  0  0  0  0  0  0  0999 V2000\n"
    "    0.0000    0.0000    0.0000 H   0  0  0  0  0\n"
    "    1.0000    0.0000    0.0000 H   0  0  0  0  0\n"
    "M  END\n$$$$\n"
)


def _mixed_sdf(tmp_path, tail_copies=1):
    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    path = tmp_path / "mixed.sdf"
    path.write_text(rec + _ALLH_RECORD + rec * tail_copies)
    return path


def test_voxelize_npz_keeps_empty_record_slots(tmp_path):
    """A mid-stream record that filters to 0 atoms keeps its (all-zero) grid
    slot; the last real molecule's grid is not dropped."""
    path = _mixed_sdf(tmp_path)
    out = tmp_path / "grids.npz"
    rc = main(
        ["voxelize", str(path), "-o", str(out), "--dimension", "16",
         "--channels", "C,N,O,S", "--batch", "2"]
    )
    assert rc == 0
    grids = np.load(out)["grids"]
    assert grids.shape[0] == 3  # 3 records, incl. the empty one
    sums = grids.sum(axis=(1, 2, 3, 4))
    assert sums[0] > 0 and sums[2] > 0  # last real molecule present
    assert sums[1] == 0  # the all-H record's slot
    np.testing.assert_allclose(grids[0], grids[2], atol=1e-5)


def test_voxelize_sharded_store(tmp_path):
    """Directory output streams shards with bounded memory and round-trips."""
    from molvoxel_tpu.data.gridstore import GridShardReader, read_grid_shards

    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    path = tmp_path / "lib.sdf"
    path.write_text(rec * 9)
    store = tmp_path / "store"
    rc = main(
        ["voxelize", str(path), "-o", str(store), "--dimension", "16",
         "--channels", "C,N,O,S", "--batch", "2"]
    )
    assert rc == 0
    grids, manifest = read_grid_shards(store)
    assert manifest["num_molecules"] == 9
    assert grids.shape == (9, 4, 16, 16, 16)
    np.testing.assert_allclose(grids[0], grids[8], atol=1e-5)
    r = GridShardReader(store)
    np.testing.assert_array_equal(r[8], grids[8])


def test_voxelize_npz_limit(tmp_path):
    import pytest

    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    path = tmp_path / "lib.sdf"
    path.write_text(rec * 5)
    with pytest.raises(SystemExit, match="npz-limit"):
        main(
            ["voxelize", str(path), "-o", str(tmp_path / "g.npz"), "--dimension", "16",
             "--channels", "C,N,O,S", "--batch", "2", "--npz-limit", "3"]
        )


def test_voxelize_multi_file_throughput(tmp_path, capsys):
    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    p1 = tmp_path / "a.sdf"
    p2 = tmp_path / "b.sdf"
    p1.write_text(rec * 3)
    p2.write_text(rec * 4)
    rc = main(
        ["voxelize", str(p1), str(p2), "--throughput", "--wire", "--dimension", "16",
         "--channels", "C,N,O,S", "--batch", "4"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["molecules"] == 7


def test_voxelize_throughput_trials(tmp_path, capsys):
    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    p = tmp_path / "lib.sdf"
    p.write_text(rec * 4)
    rc = main(
        ["voxelize", str(p), "--throughput", "--wire", "--dimension", "16",
         "--channels", "C,N,O,S", "--batch", "4", "--trials", "2"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["trials"]) == 2
    assert out["value"] == max(out["trials"])  # best pass reported as the value
    assert out["median_mols_per_s"] > 0


def test_voxelize_gz_and_multi_file_grids(tmp_path, capsys):
    import gzip

    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    pgz = tmp_path / "a.sdf.gz"
    pgz.write_bytes(gzip.compress((rec * 2).encode()))
    p2 = tmp_path / "b.sdf"
    p2.write_text(rec * 3)
    # multi-file grids run through the maker path; .sdf.gz parses natively
    rc = main(
        ["voxelize", str(pgz), str(p2), "--dimension", "16",
         "--channels", "C,N,O,S", "--batch", "2"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["molecules"] == 5 and out["shape"][0] == 5


def test_voxelize_xyz_input(tmp_path, capsys):
    (tmp_path / "m.xyz").write_text("3\nwater-ish\nO 0.0 0.0 0.0\nC 1.2 0.0 0.0\nN 0.0 1.2 0.0\n")
    rc = main(
        ["voxelize", str(tmp_path / "m.xyz"), "--dimension", "16", "--channels", "C,N,O"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["molecules"] == 1 and out["shape"] == [1, 3, 16, 16, 16]


def test_voxelize_throughput_full_read_flag(tmp_path, capsys):
    """--full-read restores the every-grid-summed consumer (pre-r4 protocol);
    both protocols must run and count the same molecules."""
    rec = open(REF_LIGAND).read()
    if not rec.endswith("\n"):
        rec += "\n"
    p = tmp_path / "lib.sdf"
    p.write_text(rec * 4)
    for extra in ([], ["--full-read"]):
        rc = main(
            ["voxelize", str(p), "--throughput", "--wire", "--dimension", "16",
             "--channels", "C,N,O,S", "--batch", "4", *extra]
        )
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["molecules"] == 4
