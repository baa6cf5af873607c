"""Public voxelizer API mirroring the reference surface.

``Voxelizer`` exposes the same methods, argument orders and defaults as the
reference ``BaseVoxelizer`` family
(/root/reference/molvoxel/voxelizer/base/voxelizer.py:9-176 and
numpy/voxelizer.py:18-587), while the compute underneath is one jit-compiled
JAX path shared by every mode:

- ``forward(coords, center, channels, radii, ...)`` dispatches to
  single / types / features on ``channels`` being None / 1-D / 2-D, exactly
  like the reference (base/voxelizer.py:101-130).
- ``forward_types`` renders integer types through one-hot weights — a matmul
  instead of the reference torch backend's ``scatter_add_``
  (torch/voxelizer.py:378): identical sums without scatter conflicts.
- ``out_grid`` keeps the reference in-place contract for host arrays: when a
  numpy ``out_grid`` is passed the result is copied into it and the same
  object is returned (asserted by /root/reference/test/test_run_numpy.py:46-47).
- RNG: the reference consumes the global numpy RNG
  (numpy/transform.py:26, _quaternion.py:14); here each ``Voxelizer`` owns an
  explicit ``jax.random`` key chain (constructor ``seed=``), and every forward
  accepts an optional ``key=`` for fully reproducible augmentation.

Deviations (all deliberate, SURVEY.md sections 2.6/7.3):
- All compute is float32 by default (the reference forces float64 through
  scipy ``cdist``); ``precision=64`` is honored when jax x64 is enabled.
- Types arrays are int32 (reference: int16) — int32 is JAX's default int.
- Mutating ``radii_type``/``density_type`` properties rebuilds the frozen
  config; each distinct config compiles (and caches) its own XLA program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import GridSpec, VoxelizerConfig, small_atom_bucket
from ..core.transform import RandomTransform, do_random_transform
from ..ops.voxelize import default_impl, voxelize


@functools.partial(
    jax.jit,
    static_argnames=("spec", "density_type", "sigma", "random_rotation", "channelwise", "impl"),
)
def _pipeline(
    coords,
    weights,
    radii,
    mask,
    center,
    key,
    random_translation,
    *,
    spec,
    density_type,
    sigma,
    random_rotation,
    channelwise,
    impl,
):
    """center-shift -> random rigid transform -> deposit.

    Stage order matches the reference forward pipeline
    (/root/reference/molvoxel/voxelizer/numpy/voxelizer.py:120-167).
    """
    coords = coords - center[None, :].astype(coords.dtype)
    coords = do_random_transform(key, coords, None, random_translation, random_rotation)
    return voxelize(
        coords,
        weights,
        radii,
        spec=spec,
        density_type=density_type,
        sigma=sigma,
        mask=mask,
        channelwise_radii=channelwise,
        impl=impl,
    )


class Voxelizer:
    """Drop-in style voxelizer with a single JAX compute path."""

    LIB = "JAX"
    RADII_TYPE_LIST = ["scalar", "channel-wise", "atom-wise"]
    DENSITY_TYPE_LIST = ["gaussian", "binary", "gaussian_notrunc"]
    transform_class = RandomTransform

    def __init__(
        self,
        resolution: float = 0.5,
        dimension: int = 64,
        radii_type: str = "scalar",
        density_type: str = "gaussian",
        precision: int = 32,
        blockdim: int | None = None,  # accepted for reference compat; tiling is automatic
        device: str | None = None,  # accepted for reference compat (torch/voxelizer.py:73-88)
        seed: int | None = None,
        impl: str = "auto",
        **kwargs,
    ):
        assert radii_type in self.RADII_TYPE_LIST
        assert density_type in self.DENSITY_TYPE_LIST
        assert precision in (32, 64)
        sigma = kwargs.get("sigma", 0.5)
        self._config = VoxelizerConfig(
            grid=GridSpec(resolution=resolution, dimension=dimension),
            radii_type=radii_type,
            density_type=density_type,
            sigma=sigma,
            precision=precision,
        )
        self._impl = impl
        self._device = device
        if precision == 64 and not jax.config.read("jax_enable_x64"):
            # The reference numpy backend computes in f64 throughout
            # (numpy/voxelizer.py:41-43).  JAX truncates f64 to f32 unless x64
            # is on, which would silently change parity-suite semantics — make
            # the degradation loud and tell the user the escape hatch.
            import warnings

            warnings.warn(
                "precision=64 requested but jax x64 is disabled; computing in "
                "float32. Set JAX_ENABLE_X64=1 (or jax.config.update("
                "'jax_enable_x64', True) before first use) for true f64 — "
                "recommended only on CPU (the parity-suite escape hatch).",
                UserWarning,
                stacklevel=2,
            )
            self.fp = np.float32
        else:
            self.fp = np.float32 if precision == 32 else np.float64
        if seed is None:
            # Loose compat with the reference's use of the global numpy RNG:
            # seeding numpy makes this voxelizer's augmentation reproducible too.
            seed = int(np.random.randint(0, 2**31 - 1))
        self._key = jax.random.PRNGKey(seed)

    # --------------------------------------------------- device shims (compat)
    # The reference torch backend exposes .to/.cuda/.cpu device management
    # (/root/reference/molvoxel/voxelizer/torch/voxelizer.py:73-88).  Here
    # device placement is XLA's job — these record the request and return
    # self so reference-shaped code (`voxelizer.cuda()`) runs unmodified.

    def to(self, device) -> "Voxelizer":
        """Accept a device request (no-op; XLA owns placement). Returns self."""
        self._device = str(device)
        return self

    def cuda(self) -> "Voxelizer":
        """Reference-compat shim; the accelerator here is whatever JAX runs on."""
        return self.to("cuda")

    def cpu(self) -> "Voxelizer":
        """Reference-compat shim (torch/voxelizer.py:85-88)."""
        return self.to("cpu")

    @property
    def device(self) -> str | None:
        return self._device

    # ------------------------------------------------------------------ config

    @property
    def config(self) -> VoxelizerConfig:
        return self._config

    @property
    def spec(self) -> GridSpec:
        return self._config.grid

    @property
    def resolution(self) -> float:
        return self._config.grid.resolution

    @property
    def dimension(self) -> int:
        return self._config.grid.dimension

    @property
    def width(self) -> float:
        return self._config.grid.width

    @property
    def upper_bound(self) -> float:
        return self._config.grid.upper_bound

    @property
    def lower_bound(self) -> float:
        return self._config.grid.lower_bound

    @property
    def spatial_dimension(self) -> tuple[int, int, int]:
        return self._config.grid.spatial_dimension

    def grid_dimension(self, num_channels: int) -> tuple[int, int, int, int]:
        return self._config.grid.grid_dimension(num_channels)

    @property
    def radii_type(self) -> str:
        return self._config.radii_type

    @radii_type.setter
    def radii_type(self, radii_type: str):
        assert radii_type in self.RADII_TYPE_LIST
        import dataclasses

        self._config = dataclasses.replace(self._config, radii_type=radii_type)

    @property
    def density_type(self) -> str:
        return self._config.density_type

    @density_type.setter
    def density_type(self, density_type: str):
        assert density_type in self.DENSITY_TYPE_LIST
        import dataclasses

        self._config = dataclasses.replace(self._config, density_type=density_type)

    @property
    def sigma(self) -> float:
        return self._config.sigma

    @sigma.setter
    def sigma(self, sigma: float):
        import dataclasses

        self._config = dataclasses.replace(self._config, sigma=float(sigma))

    @property
    def is_radii_type_scalar(self):
        return self._config.is_radii_type_scalar

    @property
    def is_radii_type_channel_wise(self):
        return self._config.is_radii_type_channel_wise

    @property
    def is_radii_type_atom_wise(self):
        return self._config.is_radii_type_atom_wise

    @property
    def is_density_type_gaussian(self):
        return self._config.is_density_type_gaussian

    @property
    def is_density_type_binary(self):
        return self._config.is_density_type_binary

    # ------------------------------------------------------------------- utils

    def get_empty_grid(self, num_channels: int, batch_size: int | None = None, init_zero: bool = False) -> np.ndarray:
        shape = self.grid_dimension(num_channels)
        if batch_size is not None:
            shape = (batch_size,) + shape
        return np.zeros(shape, dtype=self.fp) if init_zero else np.empty(shape, dtype=self.fp)

    def asarray(self, array, obj: str) -> np.ndarray:
        """Coerce to the dtype policy (reference: numpy/voxelizer.py:576-583)."""
        if obj in ("coords", "center", "features", "radii"):
            return np.asarray(array, dtype=self.fp)
        elif obj == "types":
            return np.asarray(array, dtype=np.int32)
        raise ValueError("obj should be ['coords', 'center', 'radii', 'types', 'features']")

    def next_key(self) -> jax.Array:
        """Advance and return the internal PRNG key chain."""
        self._key, sub = jax.random.split(self._key)
        return sub

    @staticmethod
    def do_random_transform(coords, center, random_translation, random_rotation, key=None):
        if key is None:
            key = jax.random.PRNGKey(int(np.random.randint(0, 2**31 - 1)))
        return do_random_transform(key, jnp.asarray(coords), center, random_translation, random_rotation)

    # ----------------------------------------------------------------- forward

    def forward(
        self,
        coords,
        center,
        channels,
        radii,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
    ):
        if channels is None:
            return self.forward_single(coords, center, radii, random_translation, random_rotation, out_grid, key)
        channels = np.asarray(channels)
        if channels.ndim == 1:
            return self.forward_types(
                coords, center, channels, radii, random_translation, random_rotation, out_grid, key
            )
        return self.forward_features(
            coords, center, channels, radii, random_translation, random_rotation, out_grid, key
        )

    __call__ = forward

    def forward_features(
        self,
        coords,
        center,
        features,
        radii,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
    ):
        coords = np.asarray(coords, dtype=self.fp)
        features = np.asarray(features, dtype=self.fp)
        self._check_args_features(coords, features, radii, out_grid)
        v, c = features.shape

        vp = small_atom_bucket(v)
        coords_p, mask = _pad_coords(coords, vp, self.fp)
        weights_p = _pad_rows(features, vp)

        channelwise = self.is_radii_type_channel_wise
        if channelwise:
            radii_arr = np.asarray(radii, dtype=self.fp)
        elif self.is_radii_type_atom_wise:
            radii_arr = _pad_vec(np.asarray(radii, dtype=self.fp), vp, fill=1.0)
        else:
            radii_arr = np.full((vp,), float(radii), dtype=self.fp)

        result = self._run(coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation,
                           channelwise=channelwise)
        return _finalize(result, out_grid)

    def forward_types(
        self,
        coords,
        center,
        types,
        radii,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
    ):
        coords = np.asarray(coords, dtype=self.fp)
        types = np.asarray(types)
        self._check_args_types(coords, types, radii, out_grid)
        v = coords.shape[0]

        # Channel count: explicit out_grid wins; else channel-wise radii define
        # it; else the data-dependent reference rule C = max(types) + 1
        # (numpy/voxelizer.py:275-279), resolved host-side so shapes stay static.
        if out_grid is not None:
            c = int(np.shape(out_grid)[0])
        elif self.is_radii_type_channel_wise:
            c = int(np.asarray(radii).shape[0])
        else:
            c = int(types.max()) + 1 if v > 0 else 1

        vp = small_atom_bucket(v)
        coords_p, mask = _pad_coords(coords, vp, self.fp)
        onehot = np.zeros((vp, c), dtype=self.fp)
        onehot[np.arange(v), types.astype(np.int64)] = 1.0
        weights_p = onehot

        if self.is_radii_type_channel_wise:
            # Gather per-atom radii r[type_v] (reference: numpy/voxelizer.py:284-286)
            radii_arr = _pad_vec(np.asarray(radii, dtype=self.fp)[types.astype(np.int64)], vp, fill=1.0)
        elif self.is_radii_type_atom_wise:
            radii_arr = _pad_vec(np.asarray(radii, dtype=self.fp), vp, fill=1.0)
        else:
            radii_arr = np.full((vp,), float(radii), dtype=self.fp)

        result = self._run(coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation,
                           channelwise=False)
        return _finalize(result, out_grid)

    def forward_single(
        self,
        coords,
        center,
        radii,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        out_grid=None,
        key=None,
    ):
        coords = np.asarray(coords, dtype=self.fp)
        self._check_args_single(coords, radii, out_grid)
        v = coords.shape[0]

        vp = small_atom_bucket(v)
        coords_p, mask = _pad_coords(coords, vp, self.fp)
        weights_p = np.zeros((vp, 1), dtype=self.fp)
        weights_p[:v, 0] = 1.0

        if self.is_radii_type_atom_wise:
            radii_arr = _pad_vec(np.asarray(radii, dtype=self.fp), vp, fill=1.0)
        else:
            radii_arr = np.full((vp,), float(radii), dtype=self.fp)

        result = self._run(coords_p, weights_p, radii_arr, mask, center, key, random_translation, random_rotation,
                           channelwise=False)
        return _finalize(result, out_grid)

    # ------------------------------------------------------------------- batch

    def forward_batch(
        self,
        clouds,
        radii=1.0,
        centers=None,
        random_translation: float = 0.0,
        random_rotation: bool = False,
        key=None,
        num_channels: int | None = None,
        out_dtype: str = "float32",
    ):
        """Voxelize many molecules in one device launch.

        ``clouds``: list of (coords (V_i, 3), channels) pairs, where channels
        is a (V_i, C) feature matrix or a (V_i,) int type vector (all items
        must agree).  Ragged sizes are padded into one bucket.  Returns a
        numpy (B, C, D, H, W) array.  This is the throughput API the
        reference lacks (its batching is a Python loop,
        /root/reference/test/test_time_numpy.py:11-15).

        ``num_channels``: explicit channel count for the types path.  Without
        it the count is inferred per batch (``max(types)+1``, the reference's
        rule, numpy/voxelizer.py:275-279) — a data-dependent output shape that
        recompiles the jitted kernel whenever a stream's type sets vary.  Pass
        the library-wide count to pin one compilation.

        ``out_dtype``: "float32" (default) or "bfloat16" — bf16 grids halve
        the bytes written and feed CNN training natively; accumulation stays
        f32.
        """
        from ..data.pipeline import pad_point_clouds, types_to_onehot
        from ..ops.batch import voxelize_batch

        assert len(clouds) > 0
        first_channels = np.asarray(clouds[0][1])
        if first_channels.ndim == 1:  # types -> one-hot
            num_c = num_channels if num_channels is not None else max(
                int(np.asarray(ch).max()) + 1 for _, ch in clouds
            )
            clouds = [
                (np.asarray(crd, self.fp), types_to_onehot(np.asarray(ch), num_c)) for crd, ch in clouds
            ]
        else:
            clouds = [(np.asarray(crd, self.fp), np.asarray(ch, self.fp)) for crd, ch in clouds]

        batch = pad_point_clouds(clouds, centers=centers)
        b, vp = batch.batch_size, batch.padded_atoms

        channelwise = self.is_radii_type_channel_wise
        if channelwise:
            radii_arr = jnp.asarray(np.asarray(radii, self.fp))
            radii_batched = False
        elif np.isscalar(radii):
            radii_arr = jnp.full((vp,), float(radii), jnp.float32)
            radii_batched = False
        else:
            per = np.ones((b, vp), np.float32)
            for i, r in enumerate(radii):
                r = np.asarray(r, np.float32)
                per[i, : r.shape[0]] = r
            radii_arr = jnp.asarray(per)
            radii_batched = True

        if key is None:
            key = self.next_key() if (random_rotation or random_translation > 0) else jax.random.PRNGKey(0)
        keys = jax.random.split(key, b)
        cfg = self._config
        out = voxelize_batch(
            jnp.asarray(batch.coords),
            jnp.asarray(batch.weights),
            radii_arr,
            jnp.asarray(batch.mask),
            None if batch.centers is None else jnp.asarray(batch.centers),
            keys,
            np.asarray(random_translation, np.float32),
            spec=cfg.grid,
            density_type=cfg.density_type,
            sigma=cfg.sigma,
            random_rotation=bool(random_rotation),
            channelwise=channelwise,
            impl=self._impl,
            radii_batched=radii_batched,
            out_dtype=out_dtype,
        )
        # bf16 comes back as an ml_dtypes.bfloat16 numpy array (half the host
        # transfer); callers wanting f32 on host can .astype(np.float32).
        return np.asarray(out)

    # ------------------------------------------------------------------ engine

    def _run(
        self,
        coords_p,
        weights_p,
        radii_arr,
        mask,
        center,
        key,
        random_translation,
        random_rotation,
        *,
        channelwise: bool,
    ):
        if center is None:
            center_arr = np.zeros((3,), dtype=self.fp)
        else:
            center_arr = np.asarray(center, dtype=self.fp).reshape(3)
        if key is None:
            if random_rotation or (random_translation and random_translation > 0.0):
                key = self.next_key()
            else:
                key = jax.random.PRNGKey(0)
        cfg = self._config
        return _pipeline(
            coords_p,
            weights_p,
            radii_arr,
            mask,
            center_arr,
            key,
            np.asarray(random_translation, dtype=self.fp),
            spec=cfg.grid,
            density_type=cfg.density_type,
            sigma=cfg.sigma,
            random_rotation=bool(random_rotation),
            channelwise=channelwise,
            impl=self._impl,
        )

    # ------------------------------------------------------------------ checks
    # Same argument *contracts* as the reference
    # (/root/reference/molvoxel/voxelizer/numpy/voxelizer.py:171-192,317-343,438-455)
    # — which arguments must be scalar/array of what shape — validated via one
    # shared radii checker with our own diagnostics.

    def _check_radii(self, radii, *, num_atoms: int, num_channels: int | None):
        if self.is_radii_type_scalar:
            assert np.isscalar(radii), (
                f"radii_type='scalar' expects a python scalar, got shape {np.shape(radii)}"
            )
            return
        if self.is_radii_type_channel_wise:
            want = num_channels
            kind = "channel"
        else:
            want = num_atoms
            kind = "atom"
        assert not np.isscalar(radii), (
            f"radii_type='{self.radii_type}' expects one radius per {kind} ({want},), got a scalar"
        )
        got = np.shape(radii)
        if self.is_radii_type_channel_wise and num_channels is not None and len(got) == 1:
            # types path: radii must cover every type index that can occur
            assert got[0] >= want, f"channel-wise radii {got} cover fewer channels than required ({want})"
        else:
            assert got == (want,), f"radii shape {got} != one per {kind} ({want},)"

    def _check_out_grid(self, out_grid, num_channels: int | None, exact: bool):
        if out_grid is None:
            return
        d = self.dimension
        got = np.shape(out_grid)
        assert got[1:] == (d, d, d), f"out_grid spatial shape {got[1:]} != {(d, d, d)}"
        if num_channels is not None:
            if exact:
                assert got[0] == num_channels, f"out_grid has {got[0]} channels, expected {num_channels}"
            else:
                assert got[0] >= num_channels, f"out_grid has {got[0]} channels, needs at least {num_channels}"

    def _check_args_features(self, coords, features, radii, out_grid=None):
        v = coords.shape[0]
        assert features.ndim == 2 and features.shape[0] == v, (
            f"features must be (num_atoms={v}, C), got {features.shape}"
        )
        self._check_radii(radii, num_atoms=v, num_channels=features.shape[1])
        self._check_out_grid(out_grid, features.shape[1], exact=True)

    def _check_args_types(self, coords, types, radii, out_grid=None):
        v = coords.shape[0]
        assert types.shape == (v,), f"types must be (num_atoms={v},), got {types.shape}"
        c = int(types.max()) + 1 if v > 0 else 1
        self._check_radii(radii, num_atoms=v, num_channels=c)
        self._check_out_grid(out_grid, c, exact=False)

    def _check_args_single(self, coords, radii, out_grid=None):
        assert not self.is_radii_type_channel_wise, (
            "forward_single has no channel axis; channel-wise radii cannot apply"
        )
        self._check_radii(radii, num_atoms=coords.shape[0], num_channels=None)
        self._check_out_grid(out_grid, 1, exact=True)


# ------------------------------------------------------------------- helpers


def _pad_coords(coords: np.ndarray, vp: int, fp) -> tuple[np.ndarray, np.ndarray]:
    v = coords.shape[0]
    out = np.zeros((vp, 3), dtype=fp)
    out[:v] = coords
    mask = np.zeros((vp,), dtype=bool)
    mask[:v] = True
    return out, mask


def _pad_rows(arr: np.ndarray, vp: int) -> np.ndarray:
    v = arr.shape[0]
    out = np.zeros((vp,) + arr.shape[1:], dtype=arr.dtype)
    out[:v] = arr
    return out


def _pad_vec(vec: np.ndarray, vp: int, fill: float = 0.0) -> np.ndarray:
    v = vec.shape[0]
    out = np.full((vp,), fill, dtype=vec.dtype)
    out[:v] = vec
    return out


def _finalize(result: jax.Array, out_grid):
    """Honor the reference in-place out_grid contract for host arrays."""
    if out_grid is None:
        return np.asarray(result)
    host = np.asarray(result)
    if isinstance(out_grid, np.ndarray):
        if host.shape[0] < out_grid.shape[0]:
            # types path may produce fewer channels than out_grid provides
            out_grid[: host.shape[0]] = host
            out_grid[host.shape[0] :] = 0.0
        else:
            np.copyto(out_grid, host)
        return out_grid
    return host


# ------------------------------------------------------------------ factories


def create_voxelizer(
    resolution: float = 0.5,
    dimension: int = 64,
    radii_type: str = "scalar",
    density_type: str = "gaussian",
    library: str = "jax",
    **kwargs,
) -> Voxelizer:
    """Factory mirroring /root/reference/molvoxel/__init__.py:25-40.

    ``library`` is accepted for source compatibility; all values map to the
    single JAX compute path ("jax", "numpy", "numba", "torch" are allowed).
    """
    assert library in ("jax", "numpy", "numba", "torch")
    return Voxelizer(resolution, dimension, radii_type, density_type, **kwargs)


def create_random_transform(
    random_translation: float = 0.0,
    random_rotation: bool = False,
    library: str = "jax",
    **kwargs,
) -> RandomTransform:
    """Factory mirroring /root/reference/molvoxel/__init__.py:9-22."""
    assert library in ("jax", "numpy", "numba", "torch")
    return RandomTransform(random_translation, random_rotation)


def default_backend_impl() -> str:
    return default_impl()
