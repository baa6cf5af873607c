"""Device timing, profiler traces and the persistent compile cache.

JAX dispatches asynchronously: a call returns before the device has run it.
``measure_device_fn`` therefore ends every timed call with
``block_until_ready`` and times only warm (already compiled) calls.
"""

from __future__ import annotations

import os
import statistics
import time
from collections.abc import Callable
from pathlib import Path

_CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Persist XLA compilations across processes; returns the cache directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins whenever it is set; otherwise the
    cache lives in ``.jax_cache`` at the root of the checkout, resolved from
    this package's location, so every entry point shares one cache whatever
    the working directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(_CHECKOUT_CACHE)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return path


def measure_device_fn(step: Callable, *, iters: int = 10, key=None) -> float:
    """Median seconds per warm call of ``step(key) -> array``.

    ``step`` is jitted and called once to compile, then ``iters`` times, each
    on a fresh ``fold_in`` key and ended by ``block_until_ready``."""
    import jax

    if key is None:
        key = jax.random.PRNGKey(0)
    fn = jax.jit(step)
    jax.block_until_ready(fn(jax.random.fold_in(key, iters)))
    times = []
    for i in range(iters):
        k = jax.random.fold_in(key, i)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(k))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def trace(path: str):
    """Context manager: capture a jax.profiler trace viewable in Perfetto/XProf."""
    import jax

    class _Trace:
        def __enter__(self):
            jax.profiler.start_trace(path)
            return path

        def __exit__(self, *exc):
            jax.profiler.stop_trace()
            return False

    return _Trace()
