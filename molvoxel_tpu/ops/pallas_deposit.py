"""Fused cutoff deposit: a Pallas kernel for the GPU, compiled through Triton.

    out[b, c, d, h, w] = sum_v weights[b, v, c] * f(|coords_bv - g_dhw|, r_bv, sigma)

where f is zero beyond the atom's cutoff radius.  The plain XLA version
(ops/dense.py) evaluates every (atom, voxel) pair; with r = 1 A at 0.5 A
spacing only about 33 voxels lie inside an atom's cutoff, so at 64^3 about
one evaluation in 7,800 does useful work.  This kernel evaluates only the
pairs whose atom chunk can reach the voxel brick.

Design:

- The program grid is (output brick, batch).  Each program owns one small
  3-D brick of voxels with all its channels and stores it once, in the output
  dtype.  Programs run in parallel and nothing carries between them: no
  atomics, no cross-program reduction.
- Atoms are sorted along a Morton curve (``morton_keys``) so that each chunk
  of ``chunk`` consecutive atoms is spatially compact.  XLA computes each
  chunk's bounding box (grown by the atoms' cutoff radii) and, for every
  brick, the list of chunks whose box meets the brick.  A program loads its
  own list and loops over those chunks only.
- Per chunk the kernel forms the (chunk, brick) squared distances, the cutoff
  select and the density in registers, and accumulates the channel sums in
  float32.  Every lane computes in float32 (no TF32, no tensor cores: the
  channel contraction is an elementwise multiply and a reduction over the
  chunk); bf16 and fp8 grids differ only in the final store.

``interpret`` mode is taken exactly when JAX's backend is the CPU, which is
how the tests reach the kernel.  On a GPU the kernel is always compiled.
"""

from __future__ import annotations

import functools
import math
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.config import GridSpec, round_up

# gaussian_notrunc pruning (see notrunc_r2_thresh): density contributions
# below this are dropped.  1e-9 keeps the worst-case additive error (V * eps)
# under 4e-6 even for 3.3k-atom proteins, inside the 1e-5 golden budget and
# far below the bf16 grid quantization floor.  eps=0.0 selects the exact f32
# underflow bound (exp rounds to +0.0 beyond it), i.e. bit-level notrunc.
NOTRUNC_EPS = 1e-9
_F32_ZERO_LOG = 103.972  # -ln(2^-150): exp(-x) rounds to f32 +0.0 for x above this


def notrunc_r2_thresh(r2, sigma: float, eps: float = NOTRUNC_EPS):
    """Squared radius beyond which a no-cutoff gaussian is negligible.

    exp(-0.5 * d2 / (sigma^2 r^2)) <= eps  <=>  d2 >= 2 sigma^2 ln(1/eps) r2.
    With the default eps the pruned kernel reproduces the no-cutoff gaussian
    well inside the golden tolerance; eps=0.0 is bit-exact in f32 (the
    density underflows to +0.0 outside the returned radius)."""
    log_inv = _F32_ZERO_LOG if eps <= 0.0 else min(math.log(1.0 / eps), _F32_ZERO_LOG)
    return r2 * (2.0 * sigma * sigma * log_inv)


# Launch shape: voxel brick (depth, height, width), atoms per chunk, warps.
# Powers of two (Triton block shapes).  Ten settings from 8x8x8/16/4 to
# 4x4x32/16/4 measured alike on an H100 (PERF.md), so the simplest stays.
BRICK = (8, 8, 8)
CHUNK = 16
NUM_WARPS = 4


def _interpret() -> bool:
    """Run the kernel in the Pallas interpreter only on the CPU backend."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(f"the Pallas deposit kernel has no lowering for platform {platform!r}")


def morton_keys(coords, spec, mask=None, bits: int = 5):
    """(B, Vp) int32 Morton (Z-order) cell keys for spatial atom sorting.

    Morton order makes atom chunks compact in all three axes.  Compactness is
    preserved by rigid transforms, which is what lets the sort run before the
    random rotation/translation: once per molecule, on the host or hoisted
    out of augmentation loops, instead of once per augmented sample.  Padded
    atoms key to +inf-ish so they sort last.
    """
    cells = (1 << bits) - 1
    lb = jnp.asarray(spec.lower_bound, jnp.float32)
    scale = cells / jnp.asarray(max(spec.width, 1e-6), jnp.float32)
    cell = jnp.clip(((coords - lb) * scale), 0, cells).astype(jnp.int32)  # (B, Vp, 3)
    key = jnp.zeros(coords.shape[:-1], jnp.int32)
    for i in range(bits):  # interleave: x bits most significant
        key = (
            key
            | (((cell[..., 0] >> i) & 1) << (3 * i + 2))
            | (((cell[..., 1] >> i) & 1) << (3 * i + 1))
            | (((cell[..., 2] >> i) & 1) << (3 * i))
        )
    if mask is not None:
        key = jnp.where(mask, key, jnp.int32(1 << 30))
    return key


def _sort_atoms_spatially(coords, weights, radii, mask, spec):
    """Reorder atoms along a Morton curve so atom chunks are spatially local.

    Deposition is permutation-invariant, but culling tests whole chunks: in
    arbitrary order a chunk of a protein spans the entire box and meets
    every brick.  The Morton sort makes chunks about cubical, so each brick
    visits only the few chunks around it."""
    key = morton_keys(coords, spec, mask)
    order = jnp.argsort(key, axis=1)  # (B, Vp)

    def take(arr):
        idx = order[..., None] if arr.ndim == 3 else order
        return jnp.take_along_axis(arr, idx, axis=1)

    coords = take(coords)
    weights = take(weights)
    if radii.ndim == 2:
        radii = take(radii)
    if mask is not None:
        mask = take(mask)
    return coords, weights, radii, mask


def _kernel(off_ref, cnt_ref, list_ref, atom_ref, w_ref, o_ref, *, gaussian: bool, c: int,
            chunk: int, brick, nb, dl: int, dim: int, res: float, half_width: float, out_dtype):
    """One program: one voxel brick of one molecule, every channel."""
    t = pl.program_id(0)
    bi = pl.program_id(1)
    bd, bh, bw = brick
    _, nbh, nbw = nb
    td = t // (nbh * nbw)
    th = (t // nbw) % nbh
    tw = t % nbw
    n = bd * bh * bw
    i = jax.lax.iota(jnp.int32, n)
    vd = td * bd + i // (bh * bw)
    vh = th * bh + (i // bw) % bh
    vw = tw * bw + i % bw
    # voxel centres exactly as ops/dense._axis_positions forms them
    px = (vd + off_ref[0]).astype(jnp.float32) * res - half_width
    py = vh.astype(jnp.float32) * res - half_width
    pz = vw.astype(jnp.float32) * res - half_width

    def body(j, acc):
        start = pl.multiple_of(list_ref[bi, t, j] * chunk, chunk)
        atoms = pl.ds(start, chunk)
        dx = px[None, :] - atom_ref[bi, 0, atoms][:, None]
        dy = py[None, :] - atom_ref[bi, 1, atoms][:, None]
        dz = pz[None, :] - atom_ref[bi, 2, atoms][:, None]
        d2 = dx * dx + dy * dy + dz * dz  # (chunk, n)
        inside = d2 <= atom_ref[bi, 3, atoms][:, None]
        if gaussian:
            dens = jnp.where(inside, jnp.exp(d2 * atom_ref[bi, 4, atoms][:, None]), 0.0)
        else:
            dens = jnp.where(inside, 1.0, 0.0)
        return tuple(
            acc[ci] + jnp.sum(dens * w_ref[bi, ci, atoms][:, None], axis=0) for ci in range(c)
        )

    zeros = tuple(jnp.zeros((n,), jnp.float32) for _ in range(c))
    acc = jax.lax.fori_loop(0, cnt_ref[bi, t], body, zeros)

    ragged = dl % bd or dim % bh or dim % bw
    keep = ((vd < dl) & (vh < dim) & (vw < dim)).reshape(bd, bh, bw) if ragged else None
    region = (pl.ds(td * bd, bd), pl.ds(th * bh, bh), pl.ds(tw * bw, bw))
    for ci in range(c):
        plgpu.store(o_ref.at[(bi, ci, *region)], acc[ci].reshape(bd, bh, bw).astype(out_dtype),
                    mask=keep)


def _chunk_lists(xyz, reach, spec, d_offset, dl, brick):
    """Per brick, the chunks whose cutoff-grown bounding box meets it.

    xyz: (B, NC, chunk, 3) atom positions; reach: (B, NC, chunk) cutoff
    radius, -inf for atoms that deposit nothing.  Returns counts (B, T) and
    chunk indices (B, T, NC), hits first."""
    bd, bh, bw = brick
    dim = spec.dimension
    live = reach > -jnp.inf
    grow = reach[..., None] * (1 + 1e-5) + 1e-5  # ulp slack: the box test must not cull a hit
    lo = jnp.min(jnp.where(live[..., None], xyz - grow, jnp.inf), axis=2)  # (B, NC, 3)
    hi = jnp.max(jnp.where(live[..., None], xyz + grow, -jnp.inf), axis=2)

    def axis_hits(axis, n_vox, b_len, offset=0):
        # voxel-centre extent of each brick along one axis, then interval overlap
        first = jnp.arange(0, n_vox, b_len)
        last = jnp.minimum(first + b_len, n_vox) - 1
        pos = lambda idx: (idx + offset).astype(jnp.float32) * spec.resolution - spec.width / 2.0
        return (lo[:, None, :, axis] <= pos(last)[None, :, None]) & (
            hi[:, None, :, axis] >= pos(first)[None, :, None]
        )  # (B, n_bricks_axis, NC)

    hd = axis_hits(0, dl, bd, d_offset)
    hh = axis_hits(1, dim, bh)
    hw = axis_hits(2, dim, bw)
    hit = hd[:, :, None, None, :] & hh[:, None, :, None, :] & hw[:, None, None, :, :]
    hit = hit.reshape(hit.shape[0], -1, hit.shape[-1])  # (B, T, NC), bricks depth-major
    counts = jnp.sum(hit, axis=-1, dtype=jnp.int32)
    order = jnp.argsort(~hit, axis=-1, stable=True).astype(jnp.int32)
    return counts, order


@functools.partial(
    jax.jit,
    static_argnames=("spec", "density_type", "sigma", "d_count", "out_dtype", "presorted"),
)
def voxelize_pallas_batch(
    coords: jnp.ndarray,  # (B, Vp, 3)
    weights: jnp.ndarray,  # (B, Vp, C)
    radii: jnp.ndarray,  # (Vp,) shared or (B, Vp)
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,  # (B, Vp)
    d_offset=0,
    d_count: int | None = None,
    out_dtype: str = "float32",
    presorted: bool = False,
) -> jnp.ndarray:
    """Batched fused deposit -> (B, C, Dl, H, W).  Per-atom radii.

    ``out_dtype``: "float32" (parity default), "bfloat16" or
    "float8_e4m3fn"; accumulation is float32 in every lane, only the store
    narrows.

    ``presorted``: atoms already arrive in Morton order (the data pipeline
    sorts once per molecule on the host, or voxelize_batch sorts before the
    random transform), so no in-graph sort is needed.

    ``density_type="gaussian_notrunc"`` runs the gaussian kernel with the
    cutoff at the underflow radius (notrunc_r2_thresh) while the gaussian
    coefficient keeps r: the no-cutoff density, pruned only where it is
    negligible."""
    gaussian = density_type in ("gaussian", "gaussian_notrunc")
    notrunc = density_type == "gaussian_notrunc"
    b, vp, c = weights.shape
    a = CHUNK
    radii = jnp.asarray(radii, jnp.float32)
    if radii.ndim == 1:
        radii = jnp.broadcast_to(radii[None, :], (b, vp))
    if mask is None:
        mask = jnp.ones((b, vp), bool)
    if vp > a and not presorted:
        coords, weights, radii, mask = _sort_atoms_spatially(coords, weights, radii, mask, spec)
    vpad = round_up(vp, a) - vp
    if vpad:
        coords = jnp.pad(coords, ((0, 0), (0, vpad), (0, 0)))
        weights = jnp.pad(weights, ((0, 0), (0, vpad), (0, 0)))
        radii = jnp.pad(radii, ((0, 0), (0, vpad)), constant_values=1.0)
        mask = jnp.pad(mask, ((0, 0), (0, vpad)))
        vp += vpad
    coords = coords.astype(jnp.float32)

    r2 = jnp.where(mask, radii * radii, 1.0)
    r2_th = notrunc_r2_thresh(r2, sigma) if notrunc else r2
    coef = -(0.5 / (sigma * sigma)) / r2 if gaussian else jnp.zeros_like(r2)
    atom_rows = jnp.stack(
        [coords[..., 0], coords[..., 1], coords[..., 2], r2_th, coef], axis=1
    )  # (B, 5, Vp)
    wt = jnp.where(mask[:, None, :], jnp.swapaxes(weights, 1, 2).astype(jnp.float32), 0.0)

    dim = spec.dimension
    dl = dim if d_count is None else d_count
    bd, bh, bw = BRICK
    nb = (-(-dl // bd), -(-dim // bh), -(-dim // bw))
    nbricks = nb[0] * nb[1] * nb[2]
    nc = vp // a
    reach = jnp.where(mask, jnp.sqrt(r2_th), -jnp.inf).reshape(b, nc, a)
    d_off = jnp.asarray(d_offset, jnp.int32).reshape(1)
    counts, lists = _chunk_lists(coords.reshape(b, nc, a, 3), reach, spec, d_off[0], dl, BRICK)

    odt = jnp.dtype(out_dtype)
    kernel = functools.partial(
        _kernel, gaussian=gaussian, c=c, chunk=a, brick=BRICK, nb=nb, dl=dl, dim=dim,
        res=float(spec.resolution), half_width=float(spec.width / 2.0), out_dtype=odt,
    )
    return pl.pallas_call(
        kernel,
        grid=(nbricks, b),
        out_shape=jax.ShapeDtypeStruct((b, c, dl, dim, dim), odt),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=_interpret(),
        name="voxel_deposit",
    )(d_off, counts, lists, atom_rows, wt)


@functools.partial(
    jax.jit, static_argnames=("spec", "density_type", "sigma", "d_count", "out_dtype", "presorted")
)
def voxelize_pallas_batch_channelwise(
    coords: jnp.ndarray,
    weights: jnp.ndarray,
    radii: jnp.ndarray,  # (C,)
    *,
    spec: GridSpec,
    density_type: str = "gaussian",
    sigma: float = 0.5,
    mask: jnp.ndarray | None = None,
    d_offset=0,
    d_count: int | None = None,
    out_dtype: str = "float32",
    presorted: bool = False,
) -> jnp.ndarray:
    """Batched fused deposit with channel-wise radii ((C,) shared).

    Channel expansion: atom ``v`` depositing into channel ``c`` with radius
    ``r_c`` is a *virtual atom*: same position, radius ``r_c``, weight only
    in channel ``c``.  Expanding (B, Vp) atoms to (B, C*Vp) virtual atoms
    with block-diagonal weights turns channel-wise radii into the per-atom
    problem, so the request runs on the atom-wise kernel.  The Morton sort
    runs on the real atoms before the expansion, so every virtual chunk is
    single-channel and spatially local."""
    b, vp, c = weights.shape
    radii = jnp.asarray(radii, jnp.float32)
    if mask is None:
        mask = jnp.ones((b, vp), bool)
    if not presorted:
        coords, weights, _, mask = _sort_atoms_spatially(
            coords, weights, jnp.ones((b, vp), jnp.float32), mask, spec
        )
    vpad = round_up(vp, CHUNK) - vp
    if vpad:
        coords = jnp.pad(coords, ((0, 0), (0, vpad), (0, 0)))
        weights = jnp.pad(weights, ((0, 0), (0, vpad), (0, 0)))
        mask = jnp.pad(mask, ((0, 0), (0, vpad)))
        vp += vpad
    coords_x = jnp.tile(coords, (1, c, 1))  # (B, C*Vp, 3)
    radii_x = jnp.repeat(radii, vp)  # (C*Vp,): virtual block ci has radius r_ci
    wx = jnp.zeros((b, c * vp, c), weights.dtype)
    for ci in range(c):
        wx = wx.at[:, ci * vp : (ci + 1) * vp, ci].set(weights[:, :, ci])
    return voxelize_pallas_batch(
        coords_x, wx, radii_x,
        spec=spec, density_type=density_type, sigma=sigma, mask=jnp.tile(mask, (1, c)),
        d_offset=d_offset, d_count=d_count, out_dtype=out_dtype, presorted=True,
    )


def voxelize_pallas(coords, weights, radii, *, spec, density_type="gaussian", sigma=0.5, mask=None,
                    d_offset=0, d_count=None):
    """Single-molecule fused deposit -> (C, Dl, H, W); see voxelize_pallas_batch."""
    radii = jnp.asarray(radii, jnp.float32)
    out = voxelize_pallas_batch(
        coords[None], weights[None], radii if radii.ndim == 1 else radii[None],
        spec=spec, density_type=density_type, sigma=sigma,
        mask=None if mask is None else mask[None], d_offset=d_offset, d_count=d_count,
    )
    return out[0]


def voxelize_pallas_channelwise(coords, weights, radii, *, spec, density_type="gaussian", sigma=0.5,
                                mask=None, d_offset=0, d_count=None):
    """Single-molecule channel-wise fused deposit -> (C, Dl, H, W)."""
    out = voxelize_pallas_batch_channelwise(
        coords[None], weights[None], jnp.asarray(radii, jnp.float32),
        spec=spec, density_type=density_type, sigma=sigma,
        mask=None if mask is None else mask[None], d_offset=d_offset, d_count=d_count,
    )
    return out[0]
