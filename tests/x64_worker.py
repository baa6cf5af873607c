"""Subprocess worker for the f64 golden lane (run by tests/test_x64.py).

Enables jax x64 BEFORE any jax use (it cannot be toggled inside the normal
suite process, whose conftest already initialized f32 CPU jax), then replays
the f64 goldens through ``precision=64`` voxelizers at atol 1e-9 — three
orders tighter than the f32 parity bar, only meaningful when the whole
pipeline really computes in float64 (reference semantics,
/root/reference/molvoxel/voxelizer/numpy/voxelizer.py:34,125-126,545).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from molvoxel_tpu import create_voxelizer

    golden_dir = Path(__file__).parent / "goldens_x64"
    paths = sorted(golden_dir.glob("*.npz"))
    assert paths, f"no x64 goldens in {golden_dir} (run tools/make_goldens_x64.py)"

    for path in paths:
        g = np.load(path, allow_pickle=False)
        vox = create_voxelizer(
            resolution=0.5,
            dimension=48,
            radii_type=str(g["radii_type"]),
            density_type=str(g["density"]),
            sigma=0.5,
            precision=64,
            impl="dense",  # the portable XLA path runs f64 end-to-end on CPU
        )
        coords = g["coords"]
        assert coords.dtype == np.float64
        center = g["center"]
        radii = g["radii"]
        radii_arg = float(radii) if radii.ndim == 0 else radii
        mode = str(g["mode"])
        if mode == "features":
            out = vox.forward_features(coords, center, g["channels"], radii_arg)
        elif mode == "types":
            out = vox.forward_types(coords, center, g["channels"].astype(np.int32), radii_arg)
        else:
            out = vox.forward_single(coords, center, radii_arg)
        assert out.dtype == np.float64, f"{path.stem}: output dtype {out.dtype}, not f64"
        err = np.abs(np.asarray(out) - g["expected"]).max()
        print(f"{path.stem}: max abs err {err:.3e}")
        assert err < 1e-9, f"{path.stem}: {err:.3e} exceeds the 1e-9 f64 bar"
    print("x64 golden lane OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
