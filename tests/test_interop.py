"""PyTorch interop: dtype-faithful conversion + the streaming torch dataset."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from molvoxel_tpu.data.fixtures import LIGAND_SDF
from molvoxel_tpu.interop import VoxelGridDataset, from_torch, to_torch  # noqa: E402

LIG = str(LIGAND_SDF)


def test_to_torch_f32_roundtrip():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32))
    t = to_torch(x)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(from_torch(t), np.asarray(x))


def test_to_torch_bf16_bit_exact():
    x = jnp.asarray(np.linspace(-3, 3, 64, dtype=np.float32)).astype(jnp.bfloat16)
    t = to_torch(x)
    assert t.dtype == torch.bfloat16
    # same bits: upcasting both sides to f32 must agree exactly
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x).astype(np.float32))


@pytest.mark.skipif(not hasattr(torch, "float8_e4m3fn"), reason="torch lacks fp8")
def test_to_torch_fp8_bit_exact():
    x = jnp.asarray(np.linspace(0, 1, 32, dtype=np.float32)).astype(jnp.float8_e4m3fn)
    t = to_torch(x)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x).astype(np.float32))


def test_from_torch_bf16_upcasts():
    t = torch.linspace(-1, 1, 16, dtype=torch.bfloat16)
    arr = from_torch(t)
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr, t.float().numpy())


@pytest.fixture(scope="module")
def sdf10(tmp_path_factory):
    p = tmp_path_factory.mktemp("interop") / "lig10.sdf"
    p.write_bytes(open(LIG, "rb").read() * 10)
    return str(p)


def test_voxel_grid_dataset_stream(sdf10):
    from molvoxel_tpu.core.config import GridSpec

    ds = VoxelGridDataset(
        sdf10, ["C", "N", "O", "S"], GridSpec(0.5, 24),
        batch_size=4, unknown=True, out_dtype="float32",
    )
    grids, counts = [], []
    for g, n in ds:
        assert isinstance(g, torch.Tensor) and isinstance(n, torch.Tensor)
        assert g.shape[0] == 4 and g.shape[1] == 5 and g.shape[2:] == (24, 24, 24)
        assert g.dtype == torch.float32
        grids.append(g)
        counts.append(n)
    n_all = torch.cat(counts)
    assert int((n_all > 0).sum()) == 10  # 10 real molecules
    total = torch.stack([g.sum() for g in grids]).sum()
    assert float(total) > 0
    # padded tail slots produce all-zero grids
    last = grids[-1]
    for i, n in enumerate(counts[-1]):
        if int(n) == 0:
            assert float(last[i].abs().sum()) == 0.0


def test_voxel_grid_dataset_bf16_and_dataloader(sdf10):
    from torch.utils.data import DataLoader

    from molvoxel_tpu.core.config import GridSpec

    ds = VoxelGridDataset(
        sdf10, ["C", "N", "O"], GridSpec(0.5, 16),
        batch_size=8, unknown=True, out_dtype="bfloat16",
        augment=True, random_translation=0.3, seed=7,
    )
    seen = 0
    for g, n in DataLoader(ds, batch_size=None):
        assert g.dtype == torch.bfloat16
        assert g.shape[1:] == (4, 16, 16, 16)
        seen += int((n > 0).sum())
    assert seen == 10


def test_dataset_matches_direct_voxelization(sdf10):
    """Dataset grids == voxelize_batch on the same padded batch (augment off)."""
    import jax

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.data.feed import SDFBatchFeeder
    from molvoxel_tpu.ops.batch import voxelize_batch

    spec = GridSpec(0.5, 24)
    ds = VoxelGridDataset(
        sdf10, ["C", "N", "O", "S"], spec, batch_size=16, unknown=True,
    )
    got = [g for g, _ in ds]
    assert len(got) == 1

    feeder = SDFBatchFeeder(sdf10, ["C", "N", "O", "S"], batch_size=16, unknown=True)
    (batch,) = list(feeder)
    keys = jax.random.split(jax.random.PRNGKey(0), batch.batch_size)
    want = voxelize_batch(
        jnp.asarray(batch.coords), jnp.asarray(batch.weights),
        jnp.ones((batch.padded_atoms,), jnp.float32), jnp.asarray(batch.mask),
        None if batch.centers is None else jnp.asarray(batch.centers), keys, 0.0,
        spec=spec, density_type="gaussian", sigma=0.5, random_rotation=False,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-6)


def test_dataset_worker_striping_no_duplication(sdf10, monkeypatch):
    """Two simulated DataLoader workers cover the file disjointly — the
    IterableDataset duplication trap is handled via span striping."""
    from molvoxel_tpu.core.config import GridSpec

    class Info:
        def __init__(self, wid, n):
            self.id = wid
            self.num_workers = n

    totals = []
    for wid in range(2):
        monkeypatch.setattr(torch.utils.data, "get_worker_info", lambda w=wid: Info(w, 2))
        ds = VoxelGridDataset(
            sdf10, ["C", "N", "O", "S"], GridSpec(0.5, 16),
            batch_size=4, unknown=True,
            feeder_kwargs={"shards": 4},
        )
        totals.append(sum(int((n > 0).sum()) for _, n in ds))
    assert sum(totals) == 10 and all(t > 0 for t in totals)


def test_dataset_shuffle_reorders_per_epoch(sdf10):
    """shuffle=True permutes shard order deterministically per epoch while
    covering every molecule."""
    from molvoxel_tpu.core.config import GridSpec

    ds = VoxelGridDataset(
        sdf10, ["C", "N", "O", "S"], GridSpec(0.5, 16),
        batch_size=2, unknown=True, shuffle=True, seed=3,
        feeder_kwargs={"shards": 5},
    )
    for _ in range(2):  # two epochs, both complete
        assert sum(int((n > 0).sum()) for _, n in ds) == 10


def test_dataset_set_epoch_changes_shuffle(sdf10):
    """set_epoch (the num_workers>0 contract) drives the shard permutation."""
    from molvoxel_tpu.core.config import GridSpec

    ds = VoxelGridDataset(
        sdf10, ["C", "N", "O", "S"], GridSpec(0.5, 16),
        batch_size=2, unknown=True, shuffle=True, seed=11,
        feeder_kwargs={"shards": 5},
    )
    ds.set_epoch(0)
    f0 = ds._feeder(0, 1, ds._epoch)
    ds.set_epoch(3)
    f3 = ds._feeder(0, 1, ds._epoch)
    assert f0.shuffle_seed != f3.shuffle_seed
    # both epochs still cover every molecule
    ds.set_epoch(5)
    assert sum(int((n > 0).sum()) for _, n in ds) == 10


def test_grid_store_dataset(tmp_path, sdf10):
    """Map-style dataset over a precomputed store: DataLoader shuffling works."""
    from torch.utils.data import DataLoader

    from molvoxel_tpu.cli import main as cli_main
    from molvoxel_tpu.interop import GridStoreDataset

    store = tmp_path / "store"
    rc = cli_main([
        "voxelize", sdf10, "-o", str(store), "--dimension", "16",
        "--channels", "C,N,O,S", "--batch", "4", "--out-dtype", "bfloat16",
    ])
    assert rc == 0
    ds = GridStoreDataset(store)
    assert len(ds) == 10 and ds.channels == ["C", "N", "O", "S"]
    g, n = ds[3]
    assert g.dtype == torch.bfloat16 and g.shape == (4, 16, 16, 16) and n > 0
    seen = 0
    for grids, counts in DataLoader(ds, batch_size=4, shuffle=True):
        assert grids.shape[1:] == (4, 16, 16, 16)
        seen += grids.shape[0]
    assert seen == 10


def test_to_torch_returns_writable_tensor():
    # JAX arrays export read-only numpy views; to_torch must copy so the
    # tensor is safely writable (no UserWarning, no UB on in-place writes)
    import warnings

    import jax.numpy as jnp

    x = jnp.arange(12, dtype=jnp.float32).reshape(3, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = to_torch(x)
    t[0, 0] = 99.0  # must not throw or corrupt the source
    assert float(t[0, 0]) == 99.0
    assert float(x[0, 0]) == 0.0
