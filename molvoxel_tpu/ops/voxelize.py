"""Backend dispatch for the voxelization op.

One logical op, two implementations:

- ``dense``: pure XLA (ops/dense.py); runs everywhere and is the parity
  reference.
- ``pallas``: the fused cutoff deposit (ops/pallas_deposit.py), a Pallas
  kernel compiled through Triton; the production path on the GPU.

``impl="auto"`` picks the kernel on the GPU and the dense path on the CPU.
This replaces the reference's ``library=`` string dispatch between numpy/
numba/torch classes: the choice here is per call and purely about which
compiled program computes the identical result.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import GridSpec
from .dense import voxelize_dense, voxelize_dense_channelwise


def default_impl() -> str:
    """"pallas" on the GPU, "dense" on the CPU; any other platform raises."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "dense"
    raise RuntimeError(f"no voxelization path for platform {platform!r}")


# gaussian_notrunc routing, measured on one H100 (PERF.md): the pruned kernel
# beat the separable contraction only in the float32 lane at protein scale
# (3,262 atoms at 128^3); the separable path won or tied in the bf16 lane and
# for the ligand batch at 64^3.
NOTRUNC_KERNEL_MIN_ATOMS = 1024
NOTRUNC_KERNEL_MIN_DIM = 128


def notrunc_use_pallas(num_atoms: int, dim: int, out_dtype: str = "float32") -> bool:
    """True when gaussian_notrunc should run on the pruned kernel (underflow-
    radius cutoff, pallas_deposit.notrunc_r2_thresh) rather than the
    separable contraction (ops/separable.py)."""
    return (
        out_dtype == "float32"
        and num_atoms >= NOTRUNC_KERNEL_MIN_ATOMS
        and dim >= NOTRUNC_KERNEL_MIN_DIM
    )


def voxelize(
    coords: jnp.ndarray,
    weights: jnp.ndarray,
    radii: jnp.ndarray,
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,
    channelwise_radii: bool = False,
    impl: str = "auto",
    d_offset=0,
    d_count: int | None = None,
) -> jnp.ndarray:
    """Voxelize one point cloud; see ops/dense.py for argument semantics.

    radii is (V,) normally, (C,) when ``channelwise_radii`` is True.
    d_offset/d_count select a depth slab (depth-sharded execution).
    """
    if impl == "auto":
        impl = default_impl()
    if density_type == "gaussian_notrunc" and not (
        impl == "pallas"
        and not channelwise_radii
        and notrunc_use_pallas(coords.shape[0], spec.dimension)
    ):
        # fully-separable: one well-shaped matmul (ops/separable.py);
        # protein-scale f32 inputs route to the pruned kernel instead
        from .separable import voxelize_separable

        return voxelize_separable(
            coords, weights, radii, spec=spec, sigma=sigma, mask=mask,
            d_offset=d_offset, d_count=d_count, channelwise_radii=channelwise_radii,
        )
    kw = dict(spec=spec, density_type=density_type, sigma=sigma, mask=mask, d_offset=d_offset, d_count=d_count)
    if impl == "pallas":
        # custom_vjp wrapper: pallas forward, dense-path backward, so the
        # deposit is differentiable on every implementation (ops/autodiff.py)
        from .autodiff import voxelize_pallas_ad

        return voxelize_pallas_ad(
            coords, weights, radii, mask, d_offset, spec, density_type, sigma, channelwise_radii, d_count
        )
    elif impl == "dense":
        if channelwise_radii:
            return voxelize_dense_channelwise(coords, weights, radii, **kw)
        return voxelize_dense(coords, weights, radii, **kw)
    raise ValueError(f"unknown impl {impl!r}; expected 'auto', 'dense' or 'pallas'")
