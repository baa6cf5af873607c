"""Differentiable voxelization.

The reference is a pure data-preprocessing library: its grids are
non-differentiable numpy/numba buffers, and its torch path runs under
``@torch.no_grad()``.  Here the voxel image is differentiable with respect to
atom coordinates, channel weights and radii, so the voxelizer can sit inside
an end-to-end learned pipeline (conformer refinement, docking scores,
generative models over density grids).

- The dense XLA path (ops/dense.py) and the separable path (ops/separable.py)
  are pure jnp and differentiate natively; the radius cutoff contributes the
  standard almost-everywhere gradient (the boundary delta is measure-zero and
  dropped, exactly what ``jnp.where`` autodiff gives).
- The Pallas deposit kernel gets a ``jax.custom_vjp``: kernel forward, and
  the VJP of the dense path as its backward.  The backward therefore costs a
  full dense evaluation of the same grid.
- binary density: gradient w.r.t. weights is exact; w.r.t. coordinates/radii
  it is zero almost everywhere (an indicator function), matching autodiff.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import GridSpec
from .dense import voxelize_dense, voxelize_dense_channelwise


def _dense_batch(coords, weights, radii, mask, d_offset, spec, density_type, sigma, channelwise,
                 d_count):
    """The dense path over a batch: (B, V, 3), (B, V, C) -> (B, C, Dl, H, W)."""
    dense = voxelize_dense_channelwise if channelwise else voxelize_dense
    single = functools.partial(
        dense, spec=spec, density_type=density_type, sigma=sigma, d_offset=d_offset,
        d_count=d_count,
    )
    mask_ax = None if mask is None else 0
    radii_ax = 0 if (not channelwise and radii.ndim == 2) else None
    return jax.vmap(
        lambda crd, w, r, m: single(crd, w, r, mask=m), in_axes=(0, 0, radii_ax, mask_ax)
    )(coords, weights, radii, mask)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8, 9, 10, 11))
def voxelize_pallas_batch_ad(
    coords: jnp.ndarray,  # (B, Vp, 3)
    weights: jnp.ndarray,  # (B, Vp, C)
    radii: jnp.ndarray,  # (Vp,), (C,) channelwise, or (B, Vp)
    mask: jnp.ndarray | None,
    d_offset,
    spec: GridSpec,
    density_type: str,
    sigma: float,
    channelwise: bool,
    d_count: int | None,
    out_dtype: str,
    presorted: bool,
) -> jnp.ndarray:
    """Batched kernel forward with the dense-path VJP as its backward."""
    from .pallas_deposit import voxelize_pallas_batch, voxelize_pallas_batch_channelwise

    fn = voxelize_pallas_batch_channelwise if channelwise else voxelize_pallas_batch
    return fn(
        coords, weights, radii, spec=spec, density_type=density_type, sigma=sigma, mask=mask,
        d_offset=d_offset, d_count=d_count, out_dtype=out_dtype, presorted=presorted,
    )


def _fwd_batch(coords, weights, radii, mask, d_offset, spec, density_type, sigma, channelwise,
               d_count, out_dtype, presorted):
    out = voxelize_pallas_batch_ad(
        coords, weights, radii, mask, d_offset, spec, density_type, sigma, channelwise,
        d_count, out_dtype, presorted,
    )
    return out, (coords, weights, radii, mask, d_offset)


def _bwd_batch(spec, density_type, sigma, channelwise, d_count, out_dtype, presorted,
               residuals, g):
    coords, weights, radii, mask, d_offset = residuals

    def f(c, w, r):
        return _dense_batch(c, w, r, mask, d_offset, spec, density_type, sigma, channelwise,
                            d_count)

    _, vjp = jax.vjp(f, coords, weights, radii)
    dc, dw, dr = vjp(g.astype(jnp.float32))
    return dc, dw, dr, None, None


voxelize_pallas_batch_ad.defvjp(_fwd_batch, _bwd_batch)


def voxelize_pallas_ad(coords, weights, radii, mask, d_offset, spec, density_type, sigma,
                       channelwise, d_count):
    """Single-molecule form of voxelize_pallas_batch_ad -> (C, Dl, H, W)."""
    out = voxelize_pallas_batch_ad(
        coords[None], weights[None], radii if (channelwise or radii.ndim == 1) else radii[None],
        None if mask is None else mask[None], d_offset, spec, density_type, sigma, channelwise,
        d_count, "float32", False,
    )
    return out[0]
