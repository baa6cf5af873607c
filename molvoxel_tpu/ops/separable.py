"""Fully-separable gaussian deposit (no radius cutoff): one matmul.

Without the radius cutoff the gaussian factorizes along the three axes:

    exp(coef * d^2) = exp(coef*dx^2) * exp(coef*dy^2) * exp(coef*dz^2)

so the whole voxelization collapses to ONE well-shaped matmul:

    U[(d, c), v] = w[v, c] * ex[v, d]          (tiny elementwise outer)
    out[(d, c), hw] = U @ eyz[v, hw]           (M = D*C, K = V, N = H*W)

M and N are both large, so XLA hands it to a library matmul directly; no
kernel is needed, and it is backend-portable.

Semantics note: this is exactly the reference *torch* backend's gaussian.
Its radius cutoff is dead code — ``masked_fill_`` tests already-exponentiated
values, so the mask never fires (/root/reference/molvoxel/voxelizer/torch/
voxelizer.py:564-567, SURVEY.md Q1).  Exposed as
``density_type="gaussian_notrunc"``; the default "gaussian" keeps the
numpy-reference cutoff semantics (ops/pallas_deposit.py, ops/dense.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import GridSpec
from .dense import _axis_positions

# HIGHEST is true f32 (no TF32): the float32 lane must hold the 1e-5 golden
# budget.  Reference semantics: torch/voxelizer.py:564-567 (f32 CUDA).
_PRECISION = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("spec", "sigma", "d_count", "materialize", "out_dtype"))
def voxelize_separable_batch(
    coords: jnp.ndarray,  # (B, V, 3)
    weights: jnp.ndarray,  # (B, V, C)
    radii: jnp.ndarray,  # (V,), (B, V)
    *,
    spec: GridSpec,
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,
    d_offset=0,
    d_count: int | None = None,
    materialize: bool = False,
    out_dtype: str = "float32",
) -> jnp.ndarray:
    """Batched no-cutoff gaussian deposit -> (B, C, Dl, H, W).

    ``materialize=True`` fences the contraction with an optimization barrier
    in its natural (B, C*Dl, HW) layout, forcing the grid bytes to land in
    HBM even when the downstream consumer is a foldable reduction.  XLA
    otherwise collapses e.g. ``sum(voxelize(...))`` algebraically without
    ever producing the grid — correct and fast for such consumers, but a
    benchmark measuring "grids materialized per second" must set this flag
    (bench.py, benchmarks/report.py do).

    ``out_dtype="bfloat16"`` casts the einsum result before the barrier: the
    grid bytes written to HBM halve, which is most of this write-bound path's
    cost (f32 accumulation inside the contraction is unchanged)."""
    b, v, c = weights.shape
    dim = spec.dimension
    dl = dim if d_count is None else d_count
    dtype = jnp.float32

    weights = weights.astype(dtype)
    radii = jnp.asarray(radii, dtype)
    if radii.ndim == 1:
        radii = jnp.broadcast_to(radii[None, :], (b, v))
    r2 = radii * radii
    if mask is not None:
        weights = jnp.where(mask[:, :, None], weights, 0.0)
        r2 = jnp.where(mask, r2, 1.0)
    coef = -(0.5 / (sigma * sigma)) / r2  # (B, V)

    ax = _axis_positions(spec, dtype)
    axd = _axis_positions(spec, dtype, d_offset, d_count) if d_count is not None else ax

    def axis_factor(pos, axis_pts):  # (B, V), (L,) -> (B, V, L)
        delta = pos[:, :, None] - axis_pts[None, None, :]
        return jnp.exp(delta * delta * coef[:, :, None])

    ex = axis_factor(coords[:, :, 0], axd)  # (B, V, Dl)
    ey = axis_factor(coords[:, :, 1], ax)  # (B, V, H)
    ez = axis_factor(coords[:, :, 2], ax)  # (B, V, W)

    eyz = (ey[:, :, :, None] * ez[:, :, None, :]).reshape(b, v, dim * dim)  # (B, V, HW)
    u = (weights[:, :, :, None] * ex[:, :, None, :]).reshape(b, v, c * dl)  # (B, V, C*Dl)
    if out_dtype == "float32":
        out = jnp.einsum("bvm,bvn->bmn", u, eyz, preferred_element_type=dtype, precision=_PRECISION)
    else:
        # reduced-precision output: its quantization floor is already 2^-8
        # relative, so the contraction takes bf16 inputs (tensor cores) and
        # still accumulates in f32.  bf16 comes straight out of the matmul;
        # narrower grids (fp8) get a cast epilogue.
        out = jnp.einsum(
            "bvm,bvn->bmn", u.astype(jnp.bfloat16), eyz.astype(jnp.bfloat16),
            preferred_element_type=jnp.bfloat16,
        )
        if out_dtype != "bfloat16":
            out = out.astype(jnp.dtype(out_dtype))
    if materialize:
        out = jax.lax.optimization_barrier(out)
    return out.reshape(b, c, dl, dim, dim)


@functools.partial(jax.jit, static_argnames=("spec", "sigma", "d_count", "materialize", "out_dtype"))
def voxelize_separable_batch_channelwise(
    coords: jnp.ndarray,  # (B, V, 3)
    weights: jnp.ndarray,  # (B, V, C)
    radii: jnp.ndarray,  # (C,)
    *,
    spec: GridSpec,
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,
    d_offset=0,
    d_count: int | None = None,
    materialize: bool = False,
    out_dtype: str = "float32",
) -> jnp.ndarray:
    """Channel-wise radii variant: per-channel axis factors, C small.

    ``materialize``/``out_dtype`` match voxelize_separable_batch: the barrier
    fences each per-channel contraction in its natural (B, Dl, HW) layout so
    benchmarks of this path cannot be folded away either."""
    b, v, c = weights.shape
    dim = spec.dimension
    dl = dim if d_count is None else d_count
    dtype = jnp.float32

    weights = weights.astype(dtype)
    if mask is not None:
        weights = jnp.where(mask[:, :, None], weights, 0.0)
    r2c = (jnp.asarray(radii, dtype) ** 2)  # (C,)
    coefc = -(0.5 / (sigma * sigma)) / r2c

    ax = _axis_positions(spec, dtype)
    axd = _axis_positions(spec, dtype, d_offset, d_count) if d_count is not None else ax

    outs = []
    for ci in range(c):
        def axis_factor(pos, axis_pts):
            delta = pos[:, :, None] - axis_pts[None, None, :]
            return jnp.exp(delta * delta * coefc[ci])

        ex = axis_factor(coords[:, :, 0], axd)  # (B, V, Dl)
        ey = axis_factor(coords[:, :, 1], ax)
        ez = axis_factor(coords[:, :, 2], ax)
        eyz = (ey[:, :, :, None] * ez[:, :, None, :]).reshape(b, v, dim * dim)
        u = weights[:, :, ci : ci + 1] * ex  # (B, V, Dl)
        oc = jnp.einsum("bvm,bvn->bmn", u, eyz, preferred_element_type=dtype, precision=_PRECISION)
        if out_dtype != "float32":
            oc = oc.astype(out_dtype)
        if materialize:
            oc = jax.lax.optimization_barrier(oc)
        outs.append(oc)
    return jnp.stack(outs, axis=1).reshape(b, c, dl, dim, dim)


def voxelize_separable(coords, weights, radii, *, spec, sigma=0.5, mask=None, d_offset=0, d_count=None,
                       channelwise_radii=False):
    """Single-molecule no-cutoff gaussian -> (C, Dl, H, W)."""
    radii = jnp.asarray(radii, jnp.float32)
    m = None if mask is None else mask[None]
    if channelwise_radii:
        out = voxelize_separable_batch_channelwise(
            coords[None], weights[None], radii, spec=spec, sigma=sigma, mask=m,
            d_offset=d_offset, d_count=d_count,
        )
    else:
        out = voxelize_separable_batch(
            coords[None], weights[None], radii if radii.ndim == 1 else radii[None],
            spec=spec, sigma=sigma, mask=m, d_offset=d_offset, d_count=d_count,
        )
    return out[0]
