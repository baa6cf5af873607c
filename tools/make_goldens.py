"""Generate golden parity fixtures by running the *reference* numpy backend.

Runs /root/reference's numpy voxelizer (deps: numpy + scipy only) on the 10gs
test structures and records inputs + outputs as .npz under tests/goldens/.
The pytest parity suite (tests/test_parity_golden.py) then asserts the
framework reproduces these within atol 1e-5 (the reference's own reproduction
tolerance, /root/reference/test/test_run_numpy.py:47).

Run once (results are committed):  python tools/make_goldens.py
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
OUT_DIR = REPO / "tests" / "goldens"

sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REFERENCE))

from molvoxel.voxelizer.numpy.voxelizer import Voxelizer as RefVoxelizer  # noqa: E402

from molvoxel_tpu.data.parsers import read_pdb, read_sdf  # noqa: E402

SYMBOL_TABLE = {"C": 0, "N": 1, "O": 2, "S": 3}  # same channel set as reference tests


def load_points():
    ligand = read_sdf(REFERENCE / "test" / "10gs" / "10gs_ligand.sdf")
    pocket = read_pdb(REFERENCE / "test" / "10gs" / "10gs_pocket_nowater.pdb").without_hydrogens()
    protein = read_pdb(REFERENCE / "test" / "10gs" / "10gs_protein_nowater.pdb").without_hydrogens()
    return ligand, pocket, protein


def types_for(mol):
    return np.asarray([SYMBOL_TABLE.get(s, 3) for s in mol.symbols], dtype=np.int16)


def onehot(types, c):
    return np.eye(c, dtype=np.float32)[types]


def main():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    ligand, pocket, protein = load_points()
    rng = np.random.default_rng(12345)

    lig_coords = ligand.coords  # (61, 3) f64
    lig_center = lig_coords.mean(0)
    lig_types = types_for(ligand)
    c = 4
    lig_feat_onehot = onehot(lig_types, c)
    lig_feat_dense = rng.uniform(0.0, 1.0, size=(ligand.num_atoms, 6)).astype(np.float32)
    lig_radii_atom = rng.uniform(0.7, 1.8, size=(ligand.num_atoms,)).astype(np.float32)
    radii_chan4 = np.asarray([0.9, 1.1, 1.3, 1.6], dtype=np.float32)
    radii_chan6 = np.asarray([0.8, 0.9, 1.0, 1.2, 1.4, 1.7], dtype=np.float32)

    pp_coords = np.concatenate([lig_coords, pocket.coords], axis=0)
    pp_types = np.concatenate([types_for(ligand), types_for(pocket) + 4]).astype(np.int16)
    pp_feat = onehot(pp_types, 8)

    prot_coords = protein.coords

    cases = []

    def case(name, *, coords, center, mode, channels, radii, dim=48, res=0.5,
             radii_type="scalar", density="gaussian", sigma=0.5):
        # blockdim=dim -> num_blocks == 1: the reference's exact (unbinned) path.
        # The default blockdim=8 binning has an off-by-half-voxel bug: block
        # boundaries are computed as axis[idx*blockdim] + res/2
        # (/root/reference/molvoxel/voxelizer/numpy/voxelizer.py:55), one
        # half-voxel above the true midpoint between the adjacent voxel
        # centers, so atoms within (atom_size - res/2, atom_size] below a
        # block's first-voxel plane are dropped from that block — the default
        # reference output is missing up to ~0.44 of density in shells at
        # block boundaries vs its own single-block result.  The golden
        # contract is the mathematically exact single-block semantics.
        vox = RefVoxelizer(resolution=res, dimension=dim, radii_type=radii_type,
                           density_type=density, precision=32, sigma=sigma, blockdim=dim)
        coords64 = np.asarray(coords, dtype=np.float64)
        center64 = np.asarray(center, dtype=np.float64) if center is not None else None
        if mode == "features":
            out = vox.forward_features(coords64, center64, np.asarray(channels, np.float32), radii)
        elif mode == "types":
            out = vox.forward_types(coords64, center64, np.asarray(channels, np.int16), radii)
        elif mode == "single":
            out = vox.forward_single(coords64, center64, radii)
        else:
            raise ValueError(mode)
        path = OUT_DIR / f"{name}.npz"
        np.savez_compressed(
            path,
            coords=coords64.astype(np.float32),
            center=(np.asarray(center, np.float32) if center is not None else np.zeros(0, np.float32)),
            mode=np.array(mode),
            channels=(np.asarray(channels) if channels is not None else np.zeros(0)),
            radii=np.asarray(radii, dtype=np.float32),
            radii_type=np.array(radii_type),
            density=np.array(density),
            sigma=np.float32(sigma),
            resolution=np.float32(res),
            dimension=np.int32(dim),
            expected=np.asarray(out, dtype=np.float32),
        )
        cases.append((name, out.shape, float(np.abs(out).max())))
        print(f"  {name}: out {out.shape} max {np.abs(out).max():.4f} -> {path.name}")

    print("ligand cases (61 atoms):")
    case("lig_features_gaussian", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_onehot, radii=1.0)
    case("lig_features_binary", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_onehot, radii=1.0, density="binary")
    case("lig_features_sigma1", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_dense, radii=1.0, sigma=1.0)
    case("lig_types_gaussian", coords=lig_coords, center=lig_center, mode="types",
         channels=lig_types, radii=1.0)
    case("lig_types_binary", coords=lig_coords, center=lig_center, mode="types",
         channels=lig_types, radii=1.0, density="binary")
    case("lig_single_gaussian", coords=lig_coords, center=lig_center, mode="single",
         channels=None, radii=1.0)
    case("lig_single_binary", coords=lig_coords, center=lig_center, mode="single",
         channels=None, radii=1.0, density="binary")
    case("lig_features_atomwise", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_dense, radii=lig_radii_atom, radii_type="atom-wise")
    case("lig_single_atomwise", coords=lig_coords, center=lig_center, mode="single",
         channels=None, radii=lig_radii_atom, radii_type="atom-wise")
    case("lig_features_channelwise", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_onehot, radii=radii_chan4, radii_type="channel-wise")
    case("lig_features_channelwise6", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_dense, radii=radii_chan6, radii_type="channel-wise", density="binary")
    case("lig_types_channelwise", coords=lig_coords, center=lig_center, mode="types",
         channels=lig_types, radii=radii_chan4, radii_type="channel-wise")
    case("lig_features_dim64", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_onehot, radii=1.0, dim=64)
    case("lig_features_res025", coords=lig_coords, center=lig_center, mode="features",
         channels=lig_feat_onehot, radii=1.0, dim=32, res=0.25)
    case("lig_features_nocenter", coords=lig_coords - lig_center, center=None, mode="features",
         channels=lig_feat_onehot, radii=1.0)

    # reference *torch* backend golden: its gaussian has no radius cutoff
    # (dead masked_fill_, torch/voxelizer.py:564-567) — our "gaussian_notrunc"
    # must reproduce it.
    import torch  # noqa: F401  (cpu build, baked into the image)
    from molvoxel.voxelizer.torch.voxelizer import Voxelizer as RefTorchVoxelizer

    tvox = RefTorchVoxelizer(resolution=0.5, dimension=48, radii_type="scalar",
                             density_type="gaussian", blockdim=48, device="cpu")
    tout = tvox.forward_features(
        torch.tensor(lig_coords, dtype=torch.float32),
        torch.tensor(lig_center, dtype=torch.float32),
        torch.tensor(lig_feat_onehot), 1.0,
    )
    np.savez_compressed(
        OUT_DIR / "lig_features_gaussian_torchref.npz",
        coords=lig_coords.astype(np.float32),
        center=lig_center.astype(np.float32),
        mode=np.array("features"),
        channels=lig_feat_onehot,
        radii=np.float32(1.0),
        radii_type=np.array("scalar"),
        density=np.array("gaussian_notrunc"),
        sigma=np.float32(0.5),
        resolution=np.float32(0.5),
        dimension=np.int32(48),
        expected=np.asarray(tout.cpu().numpy(), dtype=np.float32),
    )
    print("  lig_features_gaussian_torchref (torch backend, no-cutoff gaussian)")

    # torch types path: validates the one-hot-matmul types implementation
    # against the reference's scatter_add_ (torch/voxelizer.py:378)
    tout_types = tvox.forward_types(
        torch.tensor(lig_coords, dtype=torch.float32),
        torch.tensor(lig_center, dtype=torch.float32),
        torch.tensor(lig_types.astype(np.int64)), 1.0,
    )
    np.savez_compressed(
        OUT_DIR / "lig_types_gaussian_torchref.npz",
        coords=lig_coords.astype(np.float32), center=lig_center.astype(np.float32),
        mode=np.array("types"), channels=lig_types,
        radii=np.float32(1.0), radii_type=np.array("scalar"),
        density=np.array("gaussian_notrunc"), sigma=np.float32(0.5),
        resolution=np.float32(0.5), dimension=np.int32(48),
        expected=np.asarray(tout_types.cpu().numpy(), dtype=np.float32),
    )
    print("  lig_types_gaussian_torchref (torch scatter_add types path)")

    # torch binary path (cutoff works for binary: le_ before any in-place exp)
    tvox_bin = RefTorchVoxelizer(resolution=0.5, dimension=48, radii_type="scalar",
                                 density_type="binary", blockdim=48, device="cpu")
    tout_bin = tvox_bin.forward_features(
        torch.tensor(lig_coords, dtype=torch.float32),
        torch.tensor(lig_center, dtype=torch.float32),
        torch.tensor(lig_feat_onehot), 1.0,
    )
    np.savez_compressed(
        OUT_DIR / "lig_features_binary_torchref.npz",
        coords=lig_coords.astype(np.float32), center=lig_center.astype(np.float32),
        mode=np.array("features"), channels=lig_feat_onehot,
        radii=np.float32(1.0), radii_type=np.array("scalar"),
        density=np.array("binary"), sigma=np.float32(0.5),
        resolution=np.float32(0.5), dimension=np.int32(48),
        expected=np.asarray(tout_bin.cpu().numpy(), dtype=np.float32),
    )
    print("  lig_features_binary_torchref (torch binary path)")

    print(f"pocket complex cases ({pp_coords.shape[0]} atoms):")
    case("pocket_features_gaussian", coords=pp_coords, center=lig_center, mode="features",
         channels=pp_feat, radii=1.0)
    case("pocket_types_gaussian", coords=pp_coords, center=lig_center, mode="types",
         channels=pp_types, radii=1.0)

    print(f"protein cases ({prot_coords.shape[0]} atoms):")
    case("protein_single_gaussian", coords=prot_coords, center=lig_center, mode="single",
         channels=None, radii=1.0)
    case("protein_single_binary", coords=prot_coords, center=lig_center, mode="single",
         channels=None, radii=1.0, density="binary")

    total = sum(p.stat().st_size for p in OUT_DIR.glob("*.npz"))
    print(f"{len(cases)} goldens, {total/1e6:.1f} MB")


if __name__ == "__main__":
    main()
