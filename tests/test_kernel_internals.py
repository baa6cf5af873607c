"""Unit tests for the deposit kernel's launch helpers (pure-XLA pieces)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.ops import pallas_deposit
from molvoxel_tpu.ops.pallas_deposit import (
    BRICK,
    CHUNK,
    _chunk_lists,
    _sort_atoms_spatially,
    morton_keys,
)


def _lists(xyz, reach, spec, d_offset, dl, brick=BRICK):
    counts, order = _chunk_lists(jnp.asarray(xyz), jnp.asarray(reach), spec, d_offset, dl, brick)
    counts, order = np.asarray(counts), np.asarray(order)
    return [[set(order[b, t, : counts[b, t]]) for t in range(order.shape[1])] for b in range(order.shape[0])]


@pytest.mark.parametrize("brick,chunk", [(BRICK, CHUNK), ((4, 8, 16), 8)], ids=str)
def test_chunk_lists_cover_every_reaching_chunk(rng, brick, chunk):
    """Culling is conservative: any chunk with an atom whose cutoff sphere
    reaches a voxel centre of a brick is in that brick's list."""
    spec = GridSpec(0.5, 16)
    b, nc, a = 2, 6, chunk
    xyz = rng.uniform(-5, 5, (b, nc, a, 3)).astype(np.float32)
    reach = rng.uniform(0.5, 1.5, (b, nc, a)).astype(np.float32)
    reach[:, -1, a // 2 :] = -np.inf  # masked atoms reach nothing
    lists = _lists(xyz, reach, spec, 0, 16, brick)
    ax = np.arange(16) * 0.5 - 4.0
    bd, bh, bw = brick
    nbh, nbw = -(-16 // bh), -(-16 // bw)
    for bi in range(b):
        for t, listed in enumerate(lists[bi]):
            td, th, tw = t // (nbh * nbw), (t // nbw) % nbh, t % nbw
            vox = np.stack(np.meshgrid(ax[td * bd : (td + 1) * bd], ax[th * bh : (th + 1) * bh],
                                       ax[tw * bw : (tw + 1) * bw], indexing="ij"), -1).reshape(-1, 3)
            d2 = ((xyz[bi][:, :, None, :] - vox[None, None]) ** 2).sum(-1)  # (nc, a, n)
            reaches = ((d2 <= reach[bi][..., None] ** 2) & (reach[bi][..., None] > 0)).any(axis=(1, 2))
            assert set(np.where(reaches)[0]) <= listed


def test_chunk_lists_cull_far_chunks():
    spec = GridSpec(0.5, 32)
    a = CHUNK
    xyz = np.zeros((1, 2, a, 3), np.float32)
    xyz[0, 0] = [-2.0, -2.0, -2.0]  # chunk 0: reaches only brick (1, 1, 1)
    xyz[0, 1] = [2.0, 2.0, 2.0]  # chunk 1: reaches only brick (2, 2, 2)
    reach = np.ones((1, 2, a), np.float32)
    lists = _lists(xyz, reach, spec, 0, 32)[0]
    assert lists[1 * 16 + 1 * 4 + 1] == {0}
    assert lists[2 * 16 + 2 * 4 + 2] == {1}
    assert sum(1 for s in lists if s) == 2  # every other brick is skipped


def test_chunk_lists_depth_slab_matches_full_grid(rng):
    """A slab's lists equal the full grid's lists for the same bricks."""
    spec = GridSpec(0.5, 16)
    xyz = rng.uniform(-4, 4, (1, 4, CHUNK, 3)).astype(np.float32)
    reach = np.ones((1, 4, CHUNK), np.float32)
    full = _lists(xyz, reach, spec, 0, 16)[0]
    upper = _lists(xyz, reach, spec, 8, 8)[0]
    assert upper == full[len(full) // 2 :]


def test_interpret_mode_only_on_cpu(monkeypatch):
    assert pallas_deposit._interpret()  # the tests run on the CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not pallas_deposit._interpret()
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="no lowering"):
        pallas_deposit._interpret()


def test_morton_keys_locality():
    spec = GridSpec(0.5, 32)
    # two atoms in the same cell share a key; distant atoms differ
    coords = jnp.asarray([[[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [7.0, -7.0, 7.0]]], jnp.float32)
    keys = np.asarray(morton_keys(coords, spec))
    assert keys[0, 0] == keys[0, 1] != keys[0, 2]
    # masked atoms key to the end
    mask = jnp.asarray([[True, False, True]])
    keys_m = np.asarray(morton_keys(coords, spec, mask))
    assert keys_m[0, 1] > keys_m[0, 0] and keys_m[0, 1] > keys_m[0, 2]


def test_sort_atoms_preserves_set_and_masks(rng):
    spec = GridSpec(0.5, 16)
    b, vp, c = 2, 256, 3
    coords = jnp.asarray(rng.uniform(-4, 4, (b, vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.normal(size=(b, vp, c)).astype(np.float32))
    radii = jnp.asarray(rng.uniform(0.5, 1.5, (b, vp)).astype(np.float32))
    mask = jnp.asarray(rng.uniform(size=(b, vp)) < 0.7)

    sc, sw, sr, sm = _sort_atoms_spatially(coords, weights, radii, mask, spec)
    # same multiset of (coord, weight, radius, mask) rows
    for bi in range(b):
        orig = np.concatenate(
            [np.asarray(coords)[bi], np.asarray(weights)[bi], np.asarray(radii)[bi][:, None],
             np.asarray(mask)[bi][:, None]], axis=1)
        new = np.concatenate(
            [np.asarray(sc)[bi], np.asarray(sw)[bi], np.asarray(sr)[bi][:, None],
             np.asarray(sm)[bi][:, None]], axis=1)
        orig_sorted = orig[np.lexsort(orig.T)]
        new_sorted = new[np.lexsort(new.T)]
        np.testing.assert_allclose(orig_sorted, new_sorted)
    # masked (padded) atoms are pushed to the end
    sm_host = np.asarray(sm)
    for bi in range(b):
        idx = np.where(~sm_host[bi])[0]
        if idx.size:
            assert sm_host[bi, idx.min():].sum() == 0 or True  # padded tail grouped
        first_false = np.argmin(sm_host[bi]) if (~sm_host[bi]).any() else vp
        assert not sm_host[bi, first_false:].any()
