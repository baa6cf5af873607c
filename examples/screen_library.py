"""Grid-based shape screening: rank a library by density overlap with a query.

The ROCS-style move — score molecules by volumetric overlap with a known
active — expressed directly on voxel grids: stream the library through the
batched voxelizer and compute cosine overlap with the query grid on device,
one fused scoring matmul per batch.  The reference can produce the same
grids (slowly, one at a time) but has no batched scoring path at all.

Run:  python examples/screen_library.py     (~20 s on CPU)
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from molvoxel_tpu.data.fixtures import LIGAND_SDF
from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.data import SDFBatchFeeder, read_sdf
from molvoxel_tpu.data.parsers import SimpleMolecule, write_sdf
from molvoxel_tpu.ops.batch import voxelize_batch

DIM = 24
SYMBOLS = ["C", "N", "O", "S"]


def make_library(query: SimpleMolecule, path: Path, rng, n_decoys=30):
    """Query + jittered near-neighbors + scrambled decoys, one SDF."""
    records = [query]  # the query itself: must rank first
    for i in range(4):  # near-neighbors: small coordinate jitter
        records.append(SimpleMolecule(
            coords=query.coords + rng.normal(0, 0.15 + 0.1 * i, query.coords.shape),
            symbols=list(query.symbols), bonds=[], name=f"neighbor-{i}"))
    for i in range(n_decoys):  # decoys: same composition, scrambled shape
        records.append(SimpleMolecule(
            coords=rng.permutation(query.coords, axis=0) * rng.uniform(0.6, 1.4)
            + rng.normal(0, 1.5, query.coords.shape),
            symbols=list(query.symbols), bonds=[], name=f"decoy-{i}"))
    tmp = path.with_suffix(".tmp")
    parts = []
    for m in records:
        write_sdf(m, tmp)
        parts.append(tmp.read_bytes())
    path.write_bytes(b"".join(parts))
    tmp.unlink()
    return [m.name for m in records]


def main(n_decoys: int = 30, dim: int = DIM):
    spec = GridSpec(resolution=0.5, dimension=dim)
    query = read_sdf(str(LIGAND_SDF)).without_hydrogens()
    query = SimpleMolecule(coords=query.coords - query.coords.mean(0),
                           symbols=query.symbols, bonds=[], name="query")
    rng = np.random.default_rng(0)
    lib_path = Path(tempfile.mkdtemp()) / "library.sdf"
    names = make_library(query, lib_path, rng, n_decoys=n_decoys)

    @jax.jit
    def grid_of(coords, weights, mask, keys):
        return voxelize_batch(coords, weights, jnp.ones((coords.shape[1],), jnp.float32),
                              mask, None, keys, 0.0, spec=spec, density_type="gaussian",
                              sigma=0.5, random_rotation=False)

    # query grid (single-molecule "batch")
    feeder_q = SDFBatchFeeder(lib_path, SYMBOLS, batch_size=1, shards=1)
    first = next(iter(feeder_q))
    k1 = jax.random.split(jax.random.PRNGKey(0), 1)
    qgrid = grid_of(jnp.asarray(first.coords), jnp.asarray(first.weights),
                    jnp.asarray(first.mask), k1)[0].ravel()
    qnorm = jnp.linalg.norm(qgrid)

    @jax.jit
    def score_batch(coords, weights, mask, keys):
        grids = grid_of(coords, weights, mask, keys).reshape(coords.shape[0], -1)
        # cosine overlap on device: one (B, V) @ (V,) matmul per batch
        return (grids @ qgrid) / (jnp.linalg.norm(grids, axis=1) * qnorm + 1e-8)

    scores = []
    for batch in SDFBatchFeeder(lib_path, SYMBOLS, batch_size=8):
        keys = jax.random.split(jax.random.PRNGKey(0), batch.batch_size)
        s = score_batch(jnp.asarray(batch.coords), jnp.asarray(batch.weights),
                        jnp.asarray(batch.mask), keys)
        scores.extend(np.asarray(s)[batch.num_atoms > 0].tolist())

    order = np.argsort(scores)[::-1]
    print("rank  score   molecule")
    for r, i in enumerate(order[:6]):
        print(f"{r + 1:4d}  {scores[i]:.4f}  {names[i]}")
    assert names[order[0]] == "query", "the query must rank itself first"
    top5 = {names[i] for i in order[:5]}
    assert sum(n.startswith("neighbor") for n in top5) >= 3, \
        "near-neighbors should dominate the top ranks"
    print(f"\nscreened {len(scores)} molecules; query ranked 1st, "
          f"{sum(n.startswith('neighbor') for n in top5)}/4 neighbors in the top 5")


if __name__ == "__main__":
    main()
