"""Direct tests for public surfaces that were previously only exercised
indirectly (or not at all): routing decision functions, config helpers,
feed utilities, the native flat-parse object API, wrapper/system
visualization plumbing, and small parallel/timing helpers.

These pin behavior the rest of the suite reaches only through composite
paths, so a regression in any of them fails here with a direct message
instead of somewhere deep in a stream or wrapper test.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from molvoxel_tpu import create_voxelizer
from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.core.config import VoxelizerConfig, grid_flat_padding, round_up
from molvoxel_tpu.core.transform import Transform, random_translation_vector

from .test_data import REF_LIGAND, make_mol


# --------------------------------------------------------------------------
# routing decision functions (ops/voxelize.py)
# --------------------------------------------------------------------------


class TestRouting:
    def test_default_impl_cpu_is_dense(self, monkeypatch):
        from molvoxel_tpu.ops.voxelize import default_impl

        # conftest forces the CPU platform; the auto route must be dense there
        assert default_impl() == "dense"
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert default_impl() == "pallas"
        monkeypatch.setattr(jax, "default_backend", lambda: "metal")
        with pytest.raises(RuntimeError, match="no voxelization path"):
            default_impl()

    def test_default_backend_impl_facade(self):
        from molvoxel_tpu.api.voxelizer import default_backend_impl
        from molvoxel_tpu.ops.voxelize import default_impl

        assert default_backend_impl() == default_impl()

    def test_notrunc_crossover_table(self):
        # measured routing (PERF.md): kernel iff f32 AND V >= 1024 AND dim >= 128
        from molvoxel_tpu.ops.voxelize import (
            NOTRUNC_KERNEL_MIN_ATOMS,
            NOTRUNC_KERNEL_MIN_DIM,
            notrunc_use_pallas,
        )

        assert notrunc_use_pallas(3262, 128)  # protein x deep grid, f32
        assert not notrunc_use_pallas(3262, 128, "bfloat16")  # separable wins bf16
        assert not notrunc_use_pallas(512, 128)  # too few atoms
        assert not notrunc_use_pallas(4096, 64)  # grid too small
        assert (NOTRUNC_KERNEL_MIN_ATOMS, NOTRUNC_KERNEL_MIN_DIM) == (1024, 128)

    def test_voxelize_rejects_unknown_impl(self, rng):
        from molvoxel_tpu.ops.voxelize import voxelize

        spec = GridSpec(resolution=0.5, dimension=8)
        coords = jnp.asarray(rng.uniform(-1, 1, (4, 3)), jnp.float32)
        weights = jnp.ones((4, 2), jnp.float32)
        radii = jnp.ones((4,), jnp.float32)
        with pytest.raises(ValueError, match="unknown impl"):
            voxelize(coords, weights, radii, spec=spec, impl="numba")

    def test_voxelize_batch_rejects_unknown_impl(self, rng):
        from molvoxel_tpu.ops.batch import voxelize_batch

        spec = GridSpec(resolution=0.5, dimension=8)
        coords = jnp.asarray(rng.uniform(-1, 1, (1, 4, 3)), jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(0), 1)
        with pytest.raises(ValueError, match="unknown impl"):
            voxelize_batch(coords, jnp.ones((1, 4, 2)), jnp.ones((4,)), None, None, keys, spec=spec, impl="numba")


# --------------------------------------------------------------------------
# config helpers (core/config.py)
# --------------------------------------------------------------------------


class TestConfigHelpers:
    def test_round_up(self):
        assert round_up(0, 128) == 0
        assert round_up(1, 128) == 128
        assert round_up(128, 128) == 128
        assert round_up(129, 8) == 136

    def test_grid_flat_padding(self):
        spec = GridSpec(resolution=0.5, dimension=20)
        hw, hwp = grid_flat_padding(spec)
        assert hw == 400
        assert hwp == 512  # next multiple of the 128 lane
        spec64 = GridSpec(resolution=0.5, dimension=64)
        assert grid_flat_padding(spec64) == (4096, 4096)  # already aligned

    def test_num_voxels(self):
        assert GridSpec(resolution=0.5, dimension=16).num_voxels == 16**3

    def test_config_radii_type_flags(self):
        grid = GridSpec(resolution=0.5, dimension=8)
        cfg = VoxelizerConfig(grid=grid, radii_type="channel-wise")
        assert cfg.is_radii_type_channel_wise and not cfg.is_radii_type_atom_wise
        cfg2 = VoxelizerConfig(grid=grid, radii_type="atom-wise")
        assert cfg2.is_radii_type_atom_wise and not cfg2.is_radii_type_channel_wise
        with pytest.raises(ValueError, match="radii_type"):
            VoxelizerConfig(grid=grid, radii_type="per-molecule")


# --------------------------------------------------------------------------
# api key-chain and radii-type property (api/voxelizer.py)
# --------------------------------------------------------------------------


class TestVoxelizerSurface:
    def test_next_key_deterministic_chain(self):
        v1 = create_voxelizer(dimension=8, seed=7)
        v2 = create_voxelizer(dimension=8, seed=7)
        k1a, k1b = v1.next_key(), v1.next_key()
        k2a, k2b = v2.next_key(), v2.next_key()
        assert not np.array_equal(np.asarray(k1a), np.asarray(k1b))  # chain advances
        np.testing.assert_array_equal(np.asarray(k1a), np.asarray(k2a))  # same seed, same chain
        np.testing.assert_array_equal(np.asarray(k1b), np.asarray(k2b))

    def test_is_radii_type_channel_wise_property(self):
        vox = create_voxelizer(dimension=8, radii_type="channel-wise")
        assert vox.is_radii_type_channel_wise and not vox.is_radii_type_atom_wise
        vox.radii_type = "atom-wise"  # property setter rebuilds the frozen config
        assert vox.is_radii_type_atom_wise and not vox.is_radii_type_channel_wise


# --------------------------------------------------------------------------
# transform surface (core/transform.py)
# --------------------------------------------------------------------------


class TestTransformSurface:
    def test_random_translation_vector_bounds(self):
        key = jax.random.PRNGKey(0)
        vs = np.stack([np.asarray(random_translation_vector(jax.random.fold_in(key, i), 0.5)) for i in range(64)])
        assert vs.shape == (64, 3)
        assert np.all(np.abs(vs) <= 0.5)
        assert vs.std() > 0.1  # actually random, not collapsed

    def test_transform_create_identity_components(self):
        key = jax.random.PRNGKey(1)
        t_id = Transform.create(key, 0.0, False)
        assert t_id.translation is None and t_id.quaternion is None
        coords = jnp.asarray([[1.0, 2.0, 3.0]])
        np.testing.assert_allclose(np.asarray(t_id(coords)), [[1, 2, 3]], atol=1e-6)

    def test_transform_create_translation_only(self):
        key = jax.random.PRNGKey(2)
        t = Transform.create(key, 0.25, False)
        assert t.quaternion is None and t.translation is not None
        coords = jnp.zeros((5, 3))
        moved = np.asarray(t(coords))
        np.testing.assert_allclose(moved, np.broadcast_to(np.asarray(t.translation), (5, 3)), atol=1e-6)

    def test_transform_rotation_preserves_norms_about_center(self):
        key = jax.random.PRNGKey(3)
        t = Transform.create(key, 0.0, True)
        coords = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (16, 3)), jnp.float32)
        center = jnp.asarray([0.5, -0.5, 1.0], jnp.float32)
        out = np.asarray(t(coords, center))
        np.testing.assert_allclose(
            np.linalg.norm(out - np.asarray(center), axis=1),
            np.linalg.norm(np.asarray(coords) - np.asarray(center), axis=1),
            atol=1e-4,
        )


# --------------------------------------------------------------------------
# feed utilities (data/feed.py)
# --------------------------------------------------------------------------


class TestFeedUtilities:
    def test_prefetch_iter_preserves_order(self):
        from molvoxel_tpu.data.feed import prefetch_iter

        assert list(prefetch_iter(iter(range(100)), depth=3)) == list(range(100))

    def test_prefetch_iter_propagates_exceptions(self):
        from molvoxel_tpu.data.feed import prefetch_iter

        def gen():
            yield 1
            yield 2
            raise ValueError("producer blew up")

        it = prefetch_iter(gen(), depth=2)
        assert next(it) == 1
        assert next(it) == 2
        with pytest.raises(ValueError, match="producer blew up"):
            next(it)

    def test_prefetch_iter_early_close_does_not_hang(self):
        from molvoxel_tpu.data.feed import prefetch_iter

        it = prefetch_iter(iter(range(10_000)), depth=1)
        assert next(it) == 0
        it.close()  # worker must notice the cancellation flag and exit

    def test_flat_clouds_slice_and_concat_roundtrip(self, rng):
        from molvoxel_tpu.data.feed import FlatClouds, concat_flat_clouds

        counts = np.asarray([3, 5, 2], np.int64)
        ta = int(counts.sum())
        fc = FlatClouds(
            coords=rng.uniform(-1, 1, (ta, 3)).astype(np.float32),
            types=rng.integers(0, 4, ta).astype(np.int32),
            counts=counts,
        )
        assert fc.num_molecules == 3
        mid = fc.slice_molecules(1, 2)
        assert mid.num_molecules == 1
        np.testing.assert_array_equal(mid.coords, fc.coords[3:8])
        np.testing.assert_array_equal(mid.types, fc.types[3:8])
        back = concat_flat_clouds([fc.slice_molecules(0, 1), fc.slice_molecules(1, 3)])
        np.testing.assert_array_equal(back.coords, fc.coords)
        np.testing.assert_array_equal(back.types, fc.types)
        np.testing.assert_array_equal(back.counts, fc.counts)
        empty = concat_flat_clouds([])
        assert empty.num_molecules == 0 and empty.coords.shape == (0, 3)


# --------------------------------------------------------------------------
# parser + native flat-parse object APIs
# --------------------------------------------------------------------------


class TestParserSurfaces:
    def test_iter_sdf_lines_multi_record(self, rng, tmp_path):
        from molvoxel_tpu.data.parsers import iter_sdf_lines, write_sdf

        m1, m2 = make_mol(rng), make_mol(rng, n=5, nb=2)
        p1, p2 = tmp_path / "a.sdf", tmp_path / "b.sdf"
        write_sdf(m1, p1)
        write_sdf(m2, p2)
        lines = (p1.read_text() + p2.read_text()).splitlines()
        mols = list(iter_sdf_lines(lines))
        assert len(mols) == 2
        for got, want in zip(mols, (m1, m2)):
            assert got.symbols == want.symbols
            assert [(i, j, t) for i, j, t in got.bonds] == want.bonds
            np.testing.assert_allclose(got.coords, want.coords, atol=1e-4)

    def test_native_flat_parse_matches_python_parser(self):
        from molvoxel_tpu.data.parsers import read_sdf
        from molvoxel_tpu.native.fastparse import parse_sdf_flat

        buf = open(REF_LIGAND, "rb").read()
        flat = parse_sdf_flat(buf)
        if flat is None:
            pytest.skip("native parser unavailable")
        assert flat.num_molecules == 1
        got = flat.to_molecules()[0]
        want = read_sdf(REF_LIGAND)
        assert got.symbols == want.symbols
        assert got.num_bonds == want.num_bonds == 62
        assert [(i, j, t) for i, j, t in got.bonds] == [(i, j, t) for i, j, t in want.bonds]
        np.testing.assert_allclose(got.coords, want.coords, atol=1e-4)

    def test_native_types_mapping(self):
        from molvoxel_tpu.native.fastparse import parse_sdf_flat

        flat = parse_sdf_flat(open(REF_LIGAND, "rb").read())
        if flat is None:
            pytest.skip("native parser unavailable")
        table = {"C": 0, "N": 1, "O": 2, "S": 3}
        types = flat.types(table, unknown=4)
        assert types.shape == (61,)
        # first atom of 10gs_ligand.sdf is nitrogen
        assert types[0] == 1
        with pytest.raises(KeyError):
            flat.types({"C": 0})  # N/O/S unmapped and no unknown catch-all


# --------------------------------------------------------------------------
# parallel helpers (parallel/mesh.py, multihost.py, stream.py)
# --------------------------------------------------------------------------


class TestParallelHelpers:
    def test_shardings_and_batch_pad(self):
        from molvoxel_tpu.parallel.mesh import (
            data_sharding,
            make_mesh,
            pad_batch_to_mesh,
            replicated_sharding,
        )

        mesh = make_mesh()
        assert pad_batch_to_mesh(1, mesh) == 8
        assert pad_batch_to_mesh(8, mesh) == 8
        assert pad_batch_to_mesh(9, mesh) == 16
        ds, rs = data_sharding(mesh), replicated_sharding(mesh)
        x = jax.device_put(np.arange(16, dtype=np.float32).reshape(8, 2), ds)
        assert not x.sharding.is_fully_replicated
        y = jax.device_put(np.arange(3, dtype=np.float32), rs)
        assert y.sharding.is_fully_replicated

    def test_initialize_distributed_single_process_noop(self):
        from molvoxel_tpu.parallel.mesh import initialize_distributed

        initialize_distributed()  # must not raise on a single-process runtime

    def test_globalize_batch_single_process(self):
        from molvoxel_tpu.parallel.mesh import make_mesh
        from molvoxel_tpu.parallel.multihost import globalize_batch

        mesh = make_mesh()
        arr = np.arange(32, dtype=np.float32).reshape(8, 4)
        g = globalize_batch(mesh, arr)
        assert g.shape == (8, 4)  # 1 process: local rows == global rows
        np.testing.assert_array_equal(np.asarray(g), arr)

    def test_stream_stats(self):
        from molvoxel_tpu.parallel.stream import StreamStats

        s = StreamStats()
        assert s.mols_per_second == 0.0  # zero-division guard
        s.molecules, s.wall_seconds = 500, 2.0
        assert s.mols_per_second == 250.0


# --------------------------------------------------------------------------
# separable channel-wise batch path (ops/separable.py)
# --------------------------------------------------------------------------


class TestSeparableChannelwiseBatch:
    def test_batch_rows_match_single(self, rng):
        from molvoxel_tpu.ops.separable import (
            voxelize_separable,
            voxelize_separable_batch_channelwise,
        )

        spec = GridSpec(resolution=0.5, dimension=12)
        b, v, c = 3, 6, 2
        coords = jnp.asarray(rng.uniform(-2, 2, (b, v, 3)), jnp.float32)
        weights = jnp.asarray(rng.uniform(0, 1, (b, v, c)), jnp.float32)
        radii = jnp.asarray([0.8, 1.3], jnp.float32)
        batch = np.asarray(
            voxelize_separable_batch_channelwise(coords, weights, radii, spec=spec, sigma=0.5)
        )
        for i in range(b):
            single = np.asarray(
                voxelize_separable(
                    coords[i], weights[i], radii, spec=spec, sigma=0.5, channelwise_radii=True
                )
            )
            np.testing.assert_allclose(batch[i], single, atol=1e-5)


# --------------------------------------------------------------------------
# wrapper visualize plumbing + system session fallback (no pymol)
# --------------------------------------------------------------------------


class TestWrapperVisualize:
    def _features_maker(self):
        from molvoxel_tpu.data import AtomTypeGetter, MolPointCloudMaker

        return MolPointCloudMaker(AtomTypeGetter(["C", "N", "O", "S"]), None, channel_type="features")

    def test_mol_wrapper_visualize_fallback(self, rng, tmp_path):
        from molvoxel_tpu.data import MolWrapper
        from molvoxel_tpu.viz import Visualizer

        mol = make_mol(rng)
        vox = create_voxelizer(dimension=16)
        wrapper = MolWrapper(self._features_maker(), vox, visualizer=Visualizer())
        image = wrapper.run(mol, center=mol.coords.mean(0), radii=1.0)
        result = wrapper.visualize(str(tmp_path / "mol.pse"), mol, np.asarray(image), mol.coords.mean(0))
        assert result.suffix == ".pml"
        assert "isosurface" in result.read_text()

    def test_system_wrapper_visualize_fallback(self, rng, tmp_path):
        from molvoxel_tpu.data import AtomTypeGetter, MolSystemPointCloudMaker, MolSystemWrapper

        ag = AtomTypeGetter(["C", "N", "O", "S"])
        maker = MolSystemPointCloudMaker((ag, None), (ag, None), channel_type="features")
        from molvoxel_tpu.viz import Visualizer

        vox = create_voxelizer(dimension=16)
        wrapper = MolSystemWrapper(maker, vox, name_list=["First", "Second"], visualizer=Visualizer())
        mols = [make_mol(rng), make_mol(rng, n=6, nb=0)]
        center = mols[0].coords.mean(0)
        image = wrapper.run(mols, center=center, radii=1.0)
        result = wrapper.visualize(str(tmp_path / "sys.pse"), mols, np.asarray(image), center)
        script = result.read_text()
        assert "First" in script and "Second" in script

    def test_complex_wrapper_visualize_fallback(self, rng, tmp_path):
        from molvoxel_tpu.data import AtomTypeGetter, ComplexPointCloudMaker, ComplexWrapper
        from molvoxel_tpu.viz import Visualizer

        ag = AtomTypeGetter(["C", "N", "O", "S"])
        maker = ComplexPointCloudMaker(ag, None, ag, None, channel_type="features")
        vox = create_voxelizer(dimension=16)
        wrapper = ComplexWrapper(maker, vox, visualizer=Visualizer())
        lig, prot = make_mol(rng), make_mol(rng, n=10, nb=0)
        center = lig.coords.mean(0)
        image = wrapper.run(lig, prot, center=center, radii=1.0)
        assert wrapper.get_coords(lig, prot).shape[0] == 18
        assert wrapper.get_channels(lig, prot).shape == (18, 8)
        result = wrapper.visualize(str(tmp_path / "cplx.pse"), lig, prot, np.asarray(image), center)
        script = result.read_text()
        assert "Ligand" in script and "Protein" in script

    def test_visualize_system_direct(self, rng, tmp_path):
        from molvoxel_tpu.viz import Visualizer

        g = np.zeros((8, 8, 8), np.float32)
        g[4, 4, 4] = 1.0
        mols = [make_mol(rng), make_mol(rng, n=6, nb=0)]
        result = Visualizer().visualize_system(
            str(tmp_path / "sys.pse"),
            mols,
            ["Alpha", "Beta/odd name"],  # exercises the name sanitizer too
            [{"C": g}, {"O": g}],
            [0, 0, 0],
            0.5,
        )
        script = result.read_text()
        assert "Alpha" in script and "Beta_odd_name" in script


# --------------------------------------------------------------------------
# timing / cache helper (utils/timing.py)
# --------------------------------------------------------------------------


def test_enable_compilation_cache(tmp_path, monkeypatch):
    from molvoxel_tpu.utils.timing import _CHECKOUT_CACHE, enable_compilation_cache

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        # the environment variable wins whenever it is set
        target = tmp_path / "jc"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
        assert enable_compilation_cache() == str(target)
        assert target.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(target)
        # otherwise the cache is <checkout>/.jax_cache, not a home directory
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert enable_compilation_cache() == str(_CHECKOUT_CACHE)
        assert jax.config.jax_compilation_cache_dir == str(_CHECKOUT_CACHE)
        assert _CHECKOUT_CACHE.parent == Path(__file__).resolve().parents[1]
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])
