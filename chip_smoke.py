"""On-card smoke test: the voxelizer's main path on one NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py              # one card, phases 1-6
    python chip_smoke.py --four-cards # phase 1, then the multi-device path only

Phases (any failure ends the run with a nonzero exit; nothing is caught):

1. Device: ``jax.devices()`` and the card's name and power limit.
2. Golden replay: every ``tests/goldens/*.npz`` through the ``Voxelizer`` API
   with default routing.
3. Kernel against the plain reference at real widths: ``voxelize_batch`` with
   default routing against the dense XLA path (``ops/dense.py``, its
   contraction at ``Precision.HIGHEST``, true float32 on the GPU), same keys.
4. Gradient: ``jax.grad`` through ``voxelize_batch`` against the dense VJP.
5. Main path end to end: the CLI voxelizes one SDF at 64^3, then streams a
   seeded screening library with ``--throughput --wire``.
6. Timings: the deposit kernel against the plain version it replaces.

Tolerances, as max |got - ref| over the grid, against the grid's peak |ref|:

- float32: 1e-5 absolute (relative above a peak of 1).  Both sides sum in
  float32, in different orders; the parity goldens use the same budget.
- bfloat16: 2^-8 of the peak.  The kernel sums in float32 and rounds once
  to 8 significant bits (<= 2^-9 relative).
- bfloat16 no-cutoff gaussian on the separable path: 2^-7 of the peak.  Its
  contraction takes bf16 inputs, adding a rounding of each factor.
- float8_e4m3fn: 2^-4 of the peak (4 significant bits, one rounding).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 1e-5, "bfloat16": 2.0**-8, "separable_bfloat16": 2.0**-7, "float8_e4m3fn": 2.0**-4}


def check(name, got, ref, lane):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if got.shape != ref.shape:
        raise SystemExit(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.isfinite(got).all():
        raise SystemExit(f"{name}: non-finite values")
    peak = float(np.abs(ref).max())
    tol = TOL[lane] * (max(peak, 1.0) if lane == "float32" else peak)
    err = float(np.abs(got - ref).max())
    print(f"  {name} [{lane}]: max|diff| {err:.3e}  tol {tol:.3e}  peak {peak:.4g}", flush=True)
    if not err <= tol:
        raise SystemExit(f"{name}: max|diff| {err} exceeds {tol}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters=20):
    """Median seconds of warm calls of ``fn()``, each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# ------------------------------------------------------------------ inputs


def ligand_batch(b=64):
    """The fixture ligand's 33 heavy atoms, one-hot C/N/O/S, padded to 64."""
    import jax.numpy as jnp

    from molvoxel_tpu.data.fixtures import LIGAND_SDF
    from molvoxel_tpu.data.parsers import read_sdf

    lig = read_sdf(LIGAND_SDF).without_hydrogens()
    v = lig.num_atoms
    types = np.asarray(["CNOS".index(s) if s in "CNOS" else 3 for s in lig.symbols])
    coords = np.zeros((b, 64, 3), np.float32)
    coords[:, :v] = lig.coords - lig.coords.mean(0)
    weights = np.zeros((b, 64, 4), np.float32)
    weights[:, np.arange(v), types] = 1.0
    mask = np.broadcast_to(np.arange(64) < v, (b, 64))
    return jnp.asarray(coords), jnp.asarray(weights), jnp.ones((64,), jnp.float32), jnp.asarray(mask)


def protein_batch(seed, n_atoms=3262, channels=4, radius=20.0, b=1):
    import jax.numpy as jnp

    from molvoxel_tpu.data.synthetic import random_protein

    rng = np.random.default_rng(seed)
    coords = np.stack([random_protein(n_atoms, radius, seed + i).coords for i in range(b)]).astype(np.float32)
    weights = np.eye(channels, dtype=np.float32)[rng.integers(0, channels, (b, n_atoms))]
    return jnp.asarray(coords), jnp.asarray(weights), jnp.ones((n_atoms,), jnp.float32), None


def keys_for(b, seed=0):
    import jax

    return jax.random.split(jax.random.PRNGKey(seed), b)


# ------------------------------------------------------------------ phases


def phase_goldens():
    from molvoxel_tpu import create_voxelizer

    files = sorted((ROOT / "tests" / "goldens").glob("*.npz"))
    for path in files:
        g = np.load(path)
        vox = create_voxelizer(
            resolution=float(g["resolution"]), dimension=int(g["dimension"]),
            radii_type=str(g["radii_type"]), density_type=str(g["density"]), sigma=float(g["sigma"]),
        )
        center = g["center"] if g["center"].size else None
        radii = float(g["radii"]) if g["radii"].ndim == 0 else g["radii"]
        mode = str(g["mode"])
        if mode == "features":
            out = vox.forward_features(g["coords"], center, g["channels"].astype(np.float32), radii)
        elif mode == "types":
            out = vox.forward_types(g["coords"], center, g["channels"].astype(np.int32), radii)
        else:
            out = vox.forward_single(g["coords"], center, radii)
        # the *_torchref goldens carry the reference torch backend's f32
        # cdist rounding (~2e-5), as in tests/test_parity_golden.py
        atol = 5e-5 if path.stem.endswith("torchref") else 1e-5
        err = float(np.abs(np.asarray(out) - g["expected"]).max())
        print(f"  {path.stem}: max|diff| {err:.3e}  atol {atol:g}", flush=True)
        if not err <= atol:
            raise SystemExit(f"golden {path.stem}: {err} > {atol}")
    print(f"  {len(files)} goldens replayed", flush=True)


def phase_kernel_vs_reference(seed):
    import jax.numpy as jnp

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.ops.batch import voxelize_batch

    def both(args, spec, out_dtype="float32", **kw):
        keys = keys_for(args[0].shape[0], seed)
        run = lambda impl, od: voxelize_batch(*args, None, keys, 0.5, spec=spec,
                                              random_rotation=True, impl=impl, out_dtype=od, **kw)
        return run("auto", out_dtype), run("dense", "float32")

    lig, spec64 = ligand_batch(64), GridSpec(0.5, 64)
    for density in ("gaussian", "binary", "gaussian_notrunc"):
        for od in ("float32", "bfloat16"):
            got, ref = both(lig, spec64, od, density_type=density)
            lane = "separable_bfloat16" if (density == "gaussian_notrunc" and od == "bfloat16") else od
            check(f"ligand 64^3x4 b64 {density}", got, ref, lane)
    radii_c = jnp.asarray([0.9, 1.1, 1.3, 1.6], jnp.float32)
    got, ref = both((lig[0], lig[1], radii_c, lig[3]), spec64, channelwise=True)
    check("ligand 64^3x4 b64 channel-wise radii", got, ref, "float32")

    # complex: the fixture ligand inside a seeded protein, 6.6k points, 13 channels
    pc, _, _, _ = protein_batch(seed, n_atoms=6600 - 64, radius=25.0, b=2)
    coords = jnp.concatenate([lig[0][:2], pc], axis=1)
    rng = np.random.default_rng(seed)
    weights = jnp.asarray(np.eye(13, dtype=np.float32)[rng.integers(0, 13, coords.shape[:2])])
    cmask = jnp.concatenate([lig[3][:2], jnp.ones(pc.shape[:2], bool)], axis=1)
    cx = (coords, weights, jnp.ones((coords.shape[1],), jnp.float32), cmask)
    spec48 = GridSpec(0.5, 48)
    for od in ("float32", "float8_e4m3fn"):
        got, ref = both(cx, spec48, od)
        check(f"complex 48^3x13 {coords.shape[1]} pts", got, ref, od)

    prot, spec128 = protein_batch(seed), GridSpec(0.5, 128)
    for density in ("gaussian", "gaussian_notrunc"):
        for od in ("float32", "bfloat16"):
            got, ref = both(prot, spec128, od, density_type=density)
            lane = "separable_bfloat16" if (density == "gaussian_notrunc" and od == "bfloat16") else od
            check(f"protein 128^3x4 3262 atoms {density}", got, ref, lane)


def phase_gradient(seed):
    import jax
    import jax.numpy as jnp

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.ops.batch import voxelize_batch

    coords, weights, radii, mask = ligand_batch(8)
    spec = GridSpec(0.5, 64)
    b, dims = coords.shape[0], (spec.dimension,) * 3
    target = jnp.asarray(np.random.default_rng(seed).normal(size=(b, 4, *dims)).astype(np.float32))

    def loss(impl):
        def f(c, w):
            out = voxelize_batch(c, w, radii, mask, None, keys_for(b, seed), 0.5, spec=spec,
                                 random_rotation=True, impl=impl)
            return jnp.sum(out * target)

        return jax.jit(jax.grad(f, argnums=(0, 1)))

    got = loss("auto")(coords, weights)
    ref = loss("dense")(coords, weights)
    for name, g, r in zip(("d/dcoords", "d/dweights"), got, ref):
        scale = float(np.abs(np.asarray(r)).max())
        err = float(np.abs(np.asarray(g) - np.asarray(r)).max())
        print(f"  grad {name}: max|diff| {err:.3e}  tol {1e-4 * scale:.3e}", flush=True)
        if not (np.isfinite(np.asarray(g)).all() and err <= 1e-4 * scale):
            raise SystemExit(f"gradient {name}: {err} > {1e-4 * scale}")


def phase_main_path(seed, card_line):
    from molvoxel_tpu.cli import main as cli_main
    from molvoxel_tpu.data.fixtures import LIGAND_SDF
    from molvoxel_tpu.data.synthetic import write_library_sdf

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ligand.npz"
        if cli_main(["voxelize", str(LIGAND_SDF), "--dimension", "64", "-o", str(out)]) != 0:
            raise SystemExit("CLI voxelize failed")
        grids = np.load(out)["grids"]
        print(f"  CLI grid {grids.shape} {grids.dtype}, sum {float(grids.sum()):.6g}", flush=True)
        if grids.shape[:2] != (1, 4) or grids.ndim != 5 or not np.isfinite(grids).all() or not grids.sum() > 0:
            raise SystemExit("CLI grid is not one finite, non-empty 4-channel grid")

        lib = Path(tmp) / "library.sdf"
        counts = write_library_sdf(lib, 4096, seed=seed)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["voxelize", str(lib), "--throughput", "--wire", "--dimension", "64",
                           "--out-dtype", "bfloat16", "--batch", "1024", "--random-rotation",
                           "--random-translation", "0.5", "--trials", "3"])
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0 or report["molecules"] != len(counts) or not np.isfinite(report["checksum"]):
            raise SystemExit(f"stream mode failed: {report}")
        print(f"  stream --throughput --wire: {len(counts)} molecules, {counts.min()}-{counts.max()} "
              f"heavy atoms, 64^3x4 bf16: {report['value']} mols/s (trials {report.get('trials')}) "
              f"on {card_line}", flush=True)


def phase_timings(seed, card_line):
    import jax

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.ops.batch import voxelize_batch
    from molvoxel_tpu.ops.pallas_deposit import voxelize_pallas_batch
    from molvoxel_tpu.ops.separable import voxelize_separable_batch

    cases = {
        "ligand 64^3x4 b64": (ligand_batch(64), GridSpec(0.5, 64)),
        "protein 128^3x4 3262 atoms": (protein_batch(seed), GridSpec(0.5, 128)),
    }
    print(f"  card: {card_line}", flush=True)
    for name, (args, spec) in cases.items():
        keys = keys_for(args[0].shape[0], seed)
        for od in ("bfloat16", "float32"):
            ms = {}
            for impl in ("pallas", "dense"):
                fn = jax.jit(lambda impl=impl: voxelize_batch(
                    *args, None, keys, 0.5, spec=spec, random_rotation=True,
                    impl=impl, out_dtype=od))
                ms[impl] = 1e3 * timed(fn, iters=20 if impl == "pallas" else 5)
            print(f"  TIMING {name} gaussian {od}: kernel {ms['pallas']:.4f} ms, dense {ms['dense']:.4f} ms, "
                  f"dense/kernel {ms['dense'] / ms['pallas']:.2f}", flush=True)
        coords, weights, radii, mask = args
        for od in ("bfloat16", "float32"):
            kern = jax.jit(lambda od=od: voxelize_pallas_batch(
                coords, weights, radii, spec=spec, mask=mask, out_dtype=od, density_type="gaussian_notrunc"))
            sep = jax.jit(lambda od=od: voxelize_separable_batch(
                coords, weights, radii, spec=spec, mask=mask, out_dtype=od, materialize=True))
            tk, ts = 1e3 * timed(kern), 1e3 * timed(sep)
            print(f"  TIMING {name} gaussian_notrunc {od}: kernel {tk:.4f} ms, separable {ts:.4f} ms, "
                  f"separable/kernel {ts / tk:.2f}", flush=True)


def phase_four_cards(seed):
    """Each multi-device layout against the one-card result for the same keys.

    ``impl="pallas"`` names the GPU route explicitly, so that a rehearsal on
    virtual CPU devices runs the kernel (interpreted) as well."""
    import jax
    import jax.numpy as jnp

    from molvoxel_tpu.core.config import GridSpec
    from molvoxel_tpu.ops.batch import voxelize_batch
    from molvoxel_tpu.parallel import make_mesh, voxelize_batch_2d, voxelize_batch_dp, voxelize_depth_sharded

    devices = jax.devices()
    if len(devices) != 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX found {len(devices)}")
    coords, weights, radii, mask = ligand_batch(64)
    spec64 = GridSpec(0.5, 64)
    keys = keys_for(coords.shape[0], seed)
    kw = dict(spec=spec64, random_rotation=True, impl="pallas")
    one = voxelize_batch(coords, weights, radii, mask, None, keys, 0.5, **kw)

    dp = voxelize_batch_dp(coords, weights, radii, mask, None, keys, 0.5, mesh=make_mesh(data=4, depth=1), **kw)
    check("voxelize_batch_dp 4x1, ligand 64^3x4 b64 vs one card", dp, one, "float32")

    grids, mass = voxelize_batch_2d(coords, weights, radii, mask, None, keys, 0.5,
                                    mesh=make_mesh(data=2, depth=2), **kw)
    check("voxelize_batch_2d 2x2, ligand 64^3x4 b64 vs one card", grids, one, "float32")
    total = float(jnp.sum(one))
    rel = abs(float(mass) - total) / total
    print(f"  voxelize_batch_2d psum mass {float(mass):.8g} vs {total:.8g}, rel diff {rel:.3e}", flush=True)
    if not rel <= 1e-5:
        raise SystemExit(f"2-D mesh mass {float(mass)} vs {total}")

    pc, pw, pr, _ = protein_batch(seed)
    key = keys_for(1, seed)[0]
    kw = dict(spec=GridSpec(0.5, 128), random_rotation=True, impl="pallas")
    sharded = voxelize_depth_sharded(pc[0], pw[0], pr, None, None, key, 0.5, mesh=make_mesh(data=1, depth=4), **kw)
    single = voxelize_depth_sharded(pc[0], pw[0], pr, None, None, key, 0.5,
                                    mesh=make_mesh(data=1, depth=1, devices=devices[:1]), **kw)
    check("voxelize_depth_sharded depth 4, protein 128^3x4 vs one card", sharded, single, "float32")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true", help="run only the multi-device path on 4 cards")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    sys.path.insert(0, str(ROOT))
    devices = jax.devices()
    print("phase 1: device", flush=True)
    print(f"  {devices}", flush=True)
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devices[0].platform!r}")
    from molvoxel_tpu.utils.timing import enable_compilation_cache

    enable_compilation_cache()
    card_line = card()
    print(card_line, flush=True)

    t0 = time.time()
    if args.four_cards:
        print("four cards: multi-device path against one card", flush=True)
        phase_four_cards(args.seed)
    else:
        phases = [
            ("phase 2: golden replay", phase_goldens, ()),
            ("phase 3: kernel vs dense reference at real widths", phase_kernel_vs_reference, (args.seed,)),
            ("phase 4: gradient vs dense VJP", phase_gradient, (args.seed,)),
            ("phase 5: main path end to end", phase_main_path, (args.seed, card_line)),
            ("phase 6: timings", phase_timings, (args.seed, card_line)),
        ]
        for title, fn, fargs in phases:
            print(f"{title}  [{time.time() - t0:.1f} s]", flush=True)
            fn(*fargs)
    print(f"done in {time.time() - t0:.1f} s", flush=True)
    print(card_line, flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
