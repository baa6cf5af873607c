"""utils.timing tests (CPU)."""

import jax
import jax.numpy as jnp

from molvoxel_tpu.utils.timing import measure_device_fn, trace


def test_measure_device_fn_returns_positive_seconds():
    x = jnp.ones((256, 256))

    def step(key):
        noise = jax.random.normal(key, x.shape) * 1e-6
        return (x + noise) @ x

    per = measure_device_fn(step, iters=5)
    assert per >= 0.0
    assert per < 5.0


def test_trace_context(tmp_path):
    with trace(str(tmp_path / "trace")) as path:
        jnp.ones((8, 8)).sum().block_until_ready()
    assert (tmp_path / "trace").exists()
