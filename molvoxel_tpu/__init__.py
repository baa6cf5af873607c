"""molvoxel_tpu — molecular voxelization in JAX, with a fused GPU deposit kernel.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
SeonghwanSeo/molvoxel: point clouds (atom coordinates, radii, channel data)
are rendered into 4-D density grids (C, D, H, W) with gaussian or binary
kernels, with explicit-PRNG random rigid-body augmentation, RDKit-optional
chemistry adapters, and multi-device scaling via jax.sharding meshes.

The public factory mirrors the reference API
(/root/reference/molvoxel/__init__.py:25-40) so reference users can switch
with minimal changes; the ``library`` argument is accepted for compatibility
and validated but there is a single JAX compute path (SURVEY.md section 7.1).
"""

from .api.voxelizer import Voxelizer, create_random_transform, create_voxelizer
from .core import GridSpec, RandomTransform, Transform, VoxelizerConfig

__version__ = "0.1.0"

__all__ = [
    "Voxelizer",
    "create_voxelizer",
    "create_random_transform",
    "GridSpec",
    "VoxelizerConfig",
    "RandomTransform",
    "Transform",
    "__version__",
]
