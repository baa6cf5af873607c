"""Geometric transforms: quaternion rotations and random rigid transforms.

The reference samples rotations with the Marsaglia/Shoemake uniform-quaternion
formula using the *global* numpy RNG and applies them via explicit quaternion
products q*p*q^-1 (/root/reference/molvoxel/voxelizer/numpy/_quaternion.py:13-50,
numpy/transform.py:43-80).  This design differs in two deliberate ways:

- RNG is explicit: every random transform takes a ``jax.random.PRNGKey``,
  making transforms pure functions that compose with jit/vmap/shard_map.
- The rotation is applied as a 3x3 matrix product built from
  the unit quaternion; for unit quaternions this is mathematically identical
  to the reference's q*p*q^-1 Hamilton-product chain.

Sampling formula matches the reference exactly given the same uniforms
(u1,u2,u3):  q = (sqrt(1-u1) sin(2pi u2), sqrt(1-u1) cos(2pi u2),
sqrt(u1) sin(2pi u3), sqrt(u1) cos(2pi u3)).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

_PI2 = 2.0 * math.pi


def random_quaternion(key: jax.Array, dtype=jnp.float32) -> jnp.ndarray:
    """Uniform random unit quaternion (w, x, y, z), shape (4,).

    Same construction as /root/reference/molvoxel/voxelizer/numpy/_quaternion.py:13-21.
    """
    u = jax.random.uniform(key, (3,), dtype=dtype)
    u1, u2, u3 = u[0], u[1], u[2]
    sq1 = jnp.sqrt(1.0 - u1)
    sqr = jnp.sqrt(u1)
    return jnp.stack(
        [
            sq1 * jnp.sin(_PI2 * u2),
            sq1 * jnp.cos(_PI2 * u2),
            sqr * jnp.sin(_PI2 * u3),
            sqr * jnp.cos(_PI2 * u3),
        ]
    )


def quaternion_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix R (3,3) from a unit quaternion (w, x, y, z).

    ``coords @ R.T`` equals the reference's apply_quaternion(coords, q)
    (q*p*q^-1, /root/reference/molvoxel/voxelizer/numpy/_quaternion.py:45-50).
    """
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return jnp.stack(
        [
            jnp.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)]),
            jnp.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)]),
            jnp.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)]),
        ]
    )


def apply_quaternion(coords: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Rotate coords (..., 3) by unit quaternion q (4,)."""
    rot = quaternion_to_matrix(q).astype(coords.dtype)
    return coords @ rot.T


def random_translation_vector(key: jax.Array, magnitude, dtype=jnp.float32) -> jnp.ndarray:
    """Translation ~ U(-magnitude, magnitude)^3, shape (3,).

    Mirrors /root/reference/molvoxel/voxelizer/numpy/transform.py:26.
    """
    magnitude = jnp.asarray(magnitude, dtype)
    return jax.random.uniform(key, (3,), dtype=dtype, minval=-1.0, maxval=1.0) * magnitude


@dataclasses.dataclass(frozen=True)
class Transform:
    """A concrete rigid transform: optional rotation then optional translation.

    Functional analog of the reference ``T`` (numpy/transform.py:11-33).
    ``quaternion`` / ``translation`` may be None for identity components.
    """

    translation: jnp.ndarray | None = None
    quaternion: jnp.ndarray | None = None

    def __call__(self, coords: jnp.ndarray, center: jnp.ndarray | None = None) -> jnp.ndarray:
        return do_transform(coords, center, self.translation, self.quaternion)

    @classmethod
    def create(cls, key: jax.Array, random_translation: float = 0.0, random_rotation: bool = False) -> "Transform":
        tkey, rkey = jax.random.split(key)
        translation = random_translation_vector(tkey, random_translation) if random_translation > 0.0 else None
        quaternion = random_quaternion(rkey) if random_rotation else None
        return cls(translation, quaternion)


def do_transform(
    coords: jnp.ndarray,
    center: jnp.ndarray | None = None,
    translation: jnp.ndarray | None = None,
    quaternion: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Rotate about ``center`` (origin if None), then translate.

    Same composition order as the reference do_transform
    (/root/reference/molvoxel/voxelizer/numpy/transform.py:43-60).
    """
    if quaternion is not None:
        if center is not None:
            center = jnp.reshape(center, (1, 3)).astype(coords.dtype)
            coords = apply_quaternion(coords - center, quaternion) + center
        else:
            coords = apply_quaternion(coords, quaternion)
    if translation is not None:
        coords = coords + jnp.reshape(translation, (1, 3)).astype(coords.dtype)
    return coords


def do_random_transform(
    key: jax.Array,
    coords: jnp.ndarray,
    center: jnp.ndarray | None = None,
    random_translation: float = 0.0,
    random_rotation: bool = False,
) -> jnp.ndarray:
    """Sample and apply a random rigid transform (pure function of ``key``).

    ``random_rotation`` must be a static Python bool (it changes the traced
    program); ``random_translation`` may be a traced scalar — magnitude 0
    yields the identity translation.
    """
    tkey, rkey = jax.random.split(key)
    quaternion = random_quaternion(rkey) if random_rotation else None
    translation = random_translation_vector(tkey, random_translation)
    return do_transform(coords, center, translation, quaternion)


@dataclasses.dataclass(frozen=True)
class RandomTransform:
    """Factory for random transforms, mirroring the reference RandomTransform
    facade (numpy/transform.py:36-40) with an explicit key argument."""

    random_translation: float = 0.0
    random_rotation: bool = False

    def forward(self, key: jax.Array, coords: jnp.ndarray, center: jnp.ndarray | None = None) -> jnp.ndarray:
        return do_random_transform(key, coords, center, self.random_translation, self.random_rotation)

    __call__ = forward

    def get_transform(self, key: jax.Array) -> Transform:
        return Transform.create(key, self.random_translation, self.random_rotation)
