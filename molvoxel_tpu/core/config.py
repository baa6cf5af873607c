"""Frozen, hashable configuration objects for the voxelizer.

The reference keeps geometry state mutable on a class instance
(/root/reference/molvoxel/voxelizer/base/voxelizer.py:15-38 — resolution,
dimension, width = resolution*(dimension-1), bounds = +-width/2).  Under JAX
everything that shapes a compiled program must be static and hashable, so the
equivalent state lives in frozen dataclasses that are safe to close over in
``jax.jit`` and to use as cache keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Valid enum values mirror the reference lists
# (/root/reference/molvoxel/voxelizer/base/voxelizer.py:12-13).
RADII_TYPE_LIST = ("scalar", "channel-wise", "atom-wise")
DENSITY_TYPE_LIST = ("gaussian", "binary", "gaussian_notrunc")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Geometry of the cubic voxel grid.

    Voxel centers along each axis are ``i * resolution - width / 2`` for
    ``i in range(dimension)`` with ``width = resolution * (dimension - 1)``,
    i.e. the grid is centered on the origin.  Matches the reference axis
    construction (/root/reference/molvoxel/voxelizer/numpy/voxelizer.py:41).
    """

    resolution: float = 0.5
    dimension: int = 64

    def __post_init__(self):
        if self.dimension <= 0:
            raise ValueError(f"dimension must be positive, got {self.dimension}")
        if self.resolution <= 0:
            raise ValueError(f"resolution must be positive, got {self.resolution}")

    @property
    def width(self) -> float:
        return self.resolution * (self.dimension - 1)

    @property
    def upper_bound(self) -> float:
        return self.width / 2.0

    @property
    def lower_bound(self) -> float:
        return -self.width / 2.0

    @property
    def spatial_dimension(self) -> tuple[int, int, int]:
        return (self.dimension, self.dimension, self.dimension)

    @property
    def num_voxels(self) -> int:
        return self.dimension**3

    def grid_dimension(self, num_channels: int) -> tuple[int, int, int, int]:
        d = self.dimension
        return (num_channels, d, d, d)

    def axis(self, dtype=np.float32) -> np.ndarray:
        """Host-side voxel-center positions along one axis, shape (dimension,)."""
        return (np.arange(self.dimension, dtype=np.float64) * self.resolution - self.width / 2.0).astype(dtype)


@dataclasses.dataclass(frozen=True)
class VoxelizerConfig:
    """Full static configuration of a voxelizer.

    Field names and defaults follow the reference factory
    (/root/reference/molvoxel/__init__.py:25-40): resolution 0.5, dimension 64,
    radii_type "scalar", density_type "gaussian", sigma 0.5.
    """

    grid: GridSpec = GridSpec()
    radii_type: str = "scalar"
    density_type: str = "gaussian"
    sigma: float = 0.5
    precision: int = 32

    def __post_init__(self):
        if self.radii_type not in RADII_TYPE_LIST:
            raise ValueError(f"radii_type must be one of {RADII_TYPE_LIST}, got {self.radii_type!r}")
        if self.density_type not in DENSITY_TYPE_LIST:
            raise ValueError(f"density_type must be one of {DENSITY_TYPE_LIST}, got {self.density_type!r}")
        if self.precision not in (32, 64):
            raise ValueError(f"precision must be 32 or 64, got {self.precision}")

    @property
    def is_radii_type_scalar(self) -> bool:
        return self.radii_type == "scalar"

    @property
    def is_radii_type_channel_wise(self) -> bool:
        return self.radii_type == "channel-wise"

    @property
    def is_radii_type_atom_wise(self) -> bool:
        return self.radii_type == "atom-wise"

    @property
    def is_density_type_gaussian(self) -> bool:
        return self.density_type == "gaussian"

    @property
    def is_density_type_binary(self) -> bool:
        return self.density_type == "binary"

    def to_dict(self) -> dict:
        """JSON-serializable form (reproducibility manifests, CLI configs)."""
        return {
            "resolution": self.grid.resolution,
            "dimension": self.grid.dimension,
            "radii_type": self.radii_type,
            "density_type": self.density_type,
            "sigma": self.sigma,
            "precision": self.precision,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VoxelizerConfig":
        return cls(
            grid=GridSpec(resolution=d.get("resolution", 0.5), dimension=d.get("dimension", 64)),
            radii_type=d.get("radii_type", "scalar"),
            density_type=d.get("density_type", "gaussian"),
            sigma=d.get("sigma", 0.5),
            precision=d.get("precision", 32),
        )


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def atom_bucket(num_atoms: int, minimum: int = 128) -> int:
    """Padded atom-count bucket for a given V.

    Buckets limit jit recompiles: V is padded to the next bucket in
    {128, 256, 384, 512, 768, 1024, ...} — powers of two plus 3/4 points,
    all multiples of 128.
    """
    n = max(int(num_atoms), 1)
    if n <= minimum:
        return minimum
    k = 1 << (n - 1).bit_length()  # next power of two
    threequarter = (k // 4) * 3
    if threequarter % 128 == 0 and n <= threequarter:
        return threequarter
    return k


def small_atom_bucket(num_atoms: int) -> int:
    """Bucket that allows sub-lane molecule packing: 32/64 for small molecules
    (ops.batch packs 128//bucket molecules per 128-lane atom chunk), else the
    regular 128-multiple buckets."""
    n = max(int(num_atoms), 1)
    if n <= 32:
        return 32
    if n <= 64:
        return 64
    return atom_bucket(n)


def grid_flat_padding(spec: GridSpec, lane: int = 128) -> tuple[int, int]:
    """(HW, HW_padded): the flattened trailing plane size and its lane-aligned pad."""
    hw = spec.dimension * spec.dimension
    return hw, round_up(hw, lane)


