"""Differentiable voxelization: gradients vs finite differences + path parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from molvoxel_tpu.core import GridSpec
from molvoxel_tpu.ops.dense import voxelize_dense
from molvoxel_tpu.ops.separable import voxelize_separable
from molvoxel_tpu.ops.voxelize import voxelize

SPEC = GridSpec(resolution=0.5, dimension=12)


def small_cloud(rng, v=6, c=2):
    coords = jnp.asarray(rng.uniform(-1.5, 1.5, (v, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.2, 1.0, (v, c)).astype(np.float32))
    radii = jnp.asarray(rng.uniform(0.9, 1.4, (v,)).astype(np.float32))
    target = jnp.asarray(rng.normal(size=(c, 12, 12, 12)).astype(np.float32))
    return coords, weights, radii, target


def loss_fn(density):
    def loss(coords, weights, radii, target):
        out = voxelize_dense(coords, weights, radii, spec=SPEC, density_type=density, sigma=0.5)
        return jnp.sum(out * target)

    return loss


@pytest.mark.parametrize("density", ["gaussian", "gaussian_notrunc"])
def test_grad_coords_matches_finite_differences(rng, density):
    coords, weights, radii, target = small_cloud(rng)
    loss = loss_fn(density)
    grad = np.asarray(jax.grad(loss, argnums=0)(coords, weights, radii, target))

    eps = 1e-3
    coords_np = np.asarray(coords)
    for v, ax in [(0, 0), (2, 1), (4, 2)]:
        cp = coords_np.copy()
        cp[v, ax] += eps
        cm = coords_np.copy()
        cm[v, ax] -= eps
        fd = (float(loss(jnp.asarray(cp), weights, radii, target))
              - float(loss(jnp.asarray(cm), weights, radii, target))) / (2 * eps)
        assert grad[v, ax] == pytest.approx(fd, rel=2e-2, abs=2e-2)


def test_grad_weights_matches_finite_differences(rng):
    coords, weights, radii, target = small_cloud(rng)
    loss = loss_fn("gaussian")
    grad = np.asarray(jax.grad(loss, argnums=1)(coords, weights, radii, target))
    eps = 1e-3
    w_np = np.asarray(weights)
    wp = w_np.copy()
    wp[1, 0] += eps
    wm = w_np.copy()
    wm[1, 0] -= eps
    fd = (float(loss(coords, jnp.asarray(wp), radii, target))
          - float(loss(coords, jnp.asarray(wm), radii, target))) / (2 * eps)
    assert grad[1, 0] == pytest.approx(fd, rel=1e-3, abs=1e-4)


def test_grad_radii_nonzero_gaussian(rng):
    coords, weights, radii, target = small_cloud(rng)
    grad = np.asarray(jax.grad(loss_fn("gaussian"), argnums=2)(coords, weights, radii, target))
    assert np.abs(grad).max() > 0


def test_binary_weight_grad_only(rng):
    coords, weights, radii, target = small_cloud(rng)
    loss = loss_fn("binary")
    gw = np.asarray(jax.grad(loss, argnums=1)(coords, weights, radii, target))
    assert np.abs(gw).max() > 0
    gc = np.asarray(jax.grad(loss, argnums=0)(coords, weights, radii, target))
    np.testing.assert_allclose(gc, 0.0)  # indicator: zero a.e.


def test_pallas_custom_vjp_matches_dense_grad(rng):
    coords, weights, radii, target = small_cloud(rng, v=10)
    vp = 128
    cp = jnp.zeros((vp, 3)).at[:10].set(coords)
    wp = jnp.zeros((vp, 2)).at[:10].set(weights)
    rp = jnp.ones((vp,)).at[:10].set(radii)
    mask = jnp.arange(vp) < 10

    def loss_impl(impl):
        def loss(c, w, r):
            out = voxelize(c, w, r, spec=SPEC, density_type="gaussian", sigma=0.5, mask=mask, impl=impl)
            return jnp.sum(out * target)

        return loss

    for argnum in (0, 1, 2):
        g_pallas = np.asarray(jax.grad(loss_impl("pallas"), argnums=argnum)(cp, wp, rp))
        g_dense = np.asarray(jax.grad(loss_impl("dense"), argnums=argnum)(cp, wp, rp))
        np.testing.assert_allclose(g_pallas, g_dense, atol=1e-4)


def test_separable_grad(rng):
    coords, weights, radii, target = small_cloud(rng)

    def loss(c):
        out = voxelize_separable(c, weights, radii, spec=SPEC, sigma=0.5)
        return jnp.sum(out * target)

    g = np.asarray(jax.grad(loss)(coords))
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0

    # matches the dense notrunc gradient
    def loss_dense(c):
        out = voxelize_dense(c, weights, radii, spec=SPEC, density_type="gaussian_notrunc", sigma=0.5)
        return jnp.sum(out * target)

    g2 = np.asarray(jax.grad(loss_dense)(coords))
    np.testing.assert_allclose(g, g2, atol=1e-3)


def test_grad_through_transform(rng):
    # gradient flows through the rigid transform into the original coordinates
    from molvoxel_tpu.core.transform import do_random_transform

    coords, weights, radii, target = small_cloud(rng)
    key = jax.random.PRNGKey(0)

    def loss(c):
        crd = do_random_transform(key, c, None, 0.5, True)
        out = voxelize_dense(crd, weights, radii, spec=SPEC, density_type="gaussian", sigma=0.5)
        return jnp.sum(out * target)

    g = np.asarray(jax.grad(loss)(coords))
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0


def test_pose_recovery_by_gradient_descent(rng):
    """Rigid pose is recoverable from a density grid alone (examples/pose_optimize.py).

    The end-to-end differentiability claim as a convergence test: gradient
    descent on (quaternion, shift) through the voxelizer shrinks coordinate
    RMSD to the hidden pose by >5x in a few dozen steps."""
    optax = pytest.importorskip("optax")
    from molvoxel_tpu.core.transform import apply_quaternion

    spec = GridSpec(0.5, 16)
    coords0 = jnp.asarray(rng.uniform(-2.0, 2.0, (12, 3)).astype(np.float32))
    coords0 = coords0 - coords0.mean(0)
    weights = jnp.ones((12, 1), jnp.float32)
    radii = jnp.ones((12,), jnp.float32)

    q_true = jnp.array([0.95, 0.2, -0.15, 0.1])
    q_true = q_true / jnp.linalg.norm(q_true)
    t_true = jnp.array([0.4, -0.3, 0.25])
    target_coords = apply_quaternion(coords0, q_true) + t_true
    target = voxelize_dense(target_coords, weights, radii, spec=spec, sigma=1.0)

    def pose(params):
        q = params["q"] / jnp.linalg.norm(params["q"])
        return apply_quaternion(coords0, q) + params["t"]

    def loss_fn(params):
        grid = voxelize_dense(pose(params), weights, radii, spec=spec, sigma=1.0)
        return jnp.mean((grid - target) ** 2) * 1e4

    params = {"q": jnp.array([1.0, 0.0, 0.0, 0.0]), "t": jnp.zeros(3)}
    opt = optax.adam(5e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    def rmsd(a, b):
        return float(jnp.sqrt(jnp.mean(jnp.sum((a - b) ** 2, -1))))

    r0 = rmsd(pose(params), target_coords)
    for _ in range(80):
        params, state, _ = step(params, state)
    r1 = rmsd(pose(params), target_coords)
    assert r1 < r0 / 5, f"pose RMSD {r0:.3f} -> {r1:.3f}: did not converge"


SPEC16 = GridSpec(resolution=0.5, dimension=16)


@pytest.mark.parametrize("density", ["gaussian", "binary", "gaussian_notrunc"])
def test_pallas_backward_kernel_matches_dense(rng, density):
    """grad through the kernel's custom_vjp matches the dense-path VJP for
    all three inputs and every density."""
    coords, weights, radii, _ = small_cloud(rng, v=10)
    target = jnp.asarray(rng.normal(size=(2, 16, 16, 16)).astype(np.float32))
    vp = 128
    cp = jnp.zeros((vp, 3)).at[:10].set(coords)
    wp = jnp.zeros((vp, 2)).at[:10].set(weights)
    rp = jnp.ones((vp,)).at[:10].set(radii)
    mask = jnp.arange(vp) < 10

    def loss_impl(impl):
        def loss(c, w, r):
            out = voxelize(c, w, r, spec=SPEC16, density_type=density, sigma=0.5,
                           mask=mask, impl=impl)
            return jnp.sum(out * target)

        return loss

    for argnum in (0, 1, 2):
        g_pallas = np.asarray(jax.grad(loss_impl("pallas"), argnums=argnum)(cp, wp, rp))
        if density == "gaussian_notrunc":
            # small-V notrunc routes the dense impl through separable; compare
            # against the dense op directly
            def loss_dense(c, w, r):
                out = voxelize_dense(c, w, r, spec=SPEC16, density_type=density,
                                     sigma=0.5, mask=mask)
                return jnp.sum(out * target)

            g_dense = np.asarray(jax.grad(loss_dense, argnums=argnum)(cp, wp, rp))
        else:
            g_dense = np.asarray(jax.grad(loss_impl("dense"), argnums=argnum)(cp, wp, rp))
        np.testing.assert_allclose(g_pallas, g_dense, atol=2e-4, err_msg=f"argnum={argnum}")


def test_pallas_backward_protein_scale(rng):
    """Multi-chunk (V=512) backward at 16^3: the forward sorts and culls
    atom chunks; grads must match dense."""
    v, vp, c = 400, 512, 3
    coords = jnp.asarray(rng.uniform(-3.5, 3.5, (vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.1, 1.0, (vp, c)).astype(np.float32))
    radii = jnp.asarray(rng.uniform(0.8, 1.6, (vp,)).astype(np.float32))
    mask = jnp.arange(vp) < v
    target = jnp.asarray(rng.normal(size=(c, 16, 16, 16)).astype(np.float32))

    def loss_impl(impl):
        def loss(crd, w, r):
            out = voxelize(crd, w, r, spec=SPEC16, density_type="gaussian", sigma=0.5,
                           mask=mask, impl=impl)
            return jnp.sum(out * target)

        return loss

    for argnum in (0, 1, 2):
        g_pallas = np.asarray(jax.grad(loss_impl("pallas"), argnums=argnum)(coords, weights, radii))
        g_dense = np.asarray(jax.grad(loss_impl("dense"), argnums=argnum)(coords, weights, radii))
        np.testing.assert_allclose(g_pallas, g_dense, atol=5e-4, err_msg=f"argnum={argnum}")


def test_batched_pallas_grad(rng):
    """jax.grad through the BATCHED pallas path (the training-step shape)
    matches the dense-path batched VJP."""
    import molvoxel_tpu.ops.batch as ob

    b, vp, v, c = 2, 128, 20, 3
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-2.5, 2.5, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    target = jnp.asarray(rng.normal(size=(b, c, 16, 16, 16)).astype(np.float32))

    def loss(impl):
        def f(crd, w, r):
            out = ob.voxelize_batch(
                crd, w, r, jnp.asarray(mask), None, keys, 0.0,
                spec=SPEC16, density_type="gaussian", sigma=0.5, impl=impl,
            )
            return jnp.sum(out * target)

        return f

    args = (jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32))
    for argnum in (0, 1, 2):
        gp = np.asarray(jax.grad(loss("pallas"), argnums=argnum)(*args))
        gd = np.asarray(jax.grad(loss("dense"), argnums=argnum)(*args))
        np.testing.assert_allclose(gp, gd, atol=3e-4, err_msg=f"argnum={argnum}")


def test_batched_pallas_grad_protein_scale(rng):
    """Multi-chunk batched grad (V=512, pre-sorted path through batch.py)."""
    import molvoxel_tpu.ops.batch as ob

    b, vp, v, c = 1, 512, 400, 2
    coords = jnp.asarray(rng.uniform(-3.5, 3.5, (b, vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.1, 1.0, (b, vp, c)).astype(np.float32))
    mask = jnp.asarray(np.arange(vp)[None] < v)
    keys = jax.random.split(jax.random.PRNGKey(1), b)
    target = jnp.asarray(rng.normal(size=(b, c, 16, 16, 16)).astype(np.float32))

    def loss(impl):
        def f(crd, w, r):
            out = ob.voxelize_batch(
                crd, w, r, mask, None, keys, 0.0,
                spec=SPEC16, density_type="gaussian", sigma=0.5, impl=impl,
            )
            return jnp.sum(out * target)

        return f

    args = (coords, weights, jnp.ones((vp,), jnp.float32))
    for argnum in (0, 1, 2):
        gp = np.asarray(jax.grad(loss("pallas"), argnums=argnum)(*args))
        gd = np.asarray(jax.grad(loss("dense"), argnums=argnum)(*args))
        np.testing.assert_allclose(gp, gd, atol=6e-4, err_msg=f"argnum={argnum}")

def test_channelwise_grad_through_voxelize(rng):
    """jax.grad of a channel-wise pallas voxelization (virtual-atom
    expansion forward) matches the dense path end to end."""
    v, vp, c = 200, 256, 2
    coords = jnp.asarray(rng.uniform(-2.5, 2.5, (vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.1, 1.0, (vp, c)).astype(np.float32))
    radii = jnp.asarray(np.array([1.0, 1.4], np.float32))
    mask = jnp.asarray(np.arange(vp) < v)
    target = jnp.asarray(rng.normal(size=(c, 16, 16, 16)).astype(np.float32))

    def loss_impl(impl):
        def loss(crd, w, r):
            out = voxelize(crd, w, r, spec=SPEC16, density_type="gaussian", sigma=0.5,
                           mask=mask, impl=impl, channelwise_radii=True)
            return jnp.sum(out * target)

        return loss

    for argnum in (0, 1, 2):
        gp = np.asarray(jax.grad(loss_impl("pallas"), argnums=argnum)(coords, weights, radii))
        gd = np.asarray(jax.grad(loss_impl("dense"), argnums=argnum)(coords, weights, radii))
        np.testing.assert_allclose(gp, gd, atol=5e-4, err_msg=f"argnum={argnum}")


def test_batched_grad_bf16_out_uses_lowp(rng):
    """jax.grad through the batched pallas path with a bf16 grid output runs
    (the dense VJP of a bf16 cotangent) and stays within bf16 tolerance of
    the f32 dense VJP."""
    import molvoxel_tpu.ops.batch as ob

    b, vp, v, c = 2, 128, 20, 3
    coords = np.zeros((b, vp, 3), np.float32)
    coords[:, :v] = rng.uniform(-2.5, 2.5, (b, v, 3))
    weights = np.zeros((b, vp, c), np.float32)
    weights[:, :v] = rng.uniform(size=(b, v, c))
    mask = np.zeros((b, vp), bool)
    mask[:, :v] = True
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    target = jnp.asarray(rng.normal(size=(b, c, 16, 16, 16)).astype(np.float32))

    def loss(impl, out_dtype):
        def f(crd, w, r):
            out = ob.voxelize_batch(
                crd, w, r, jnp.asarray(mask), None, keys, 0.0,
                spec=SPEC16, density_type="gaussian", sigma=0.5, impl=impl,
                out_dtype=out_dtype,
            )
            return jnp.sum(out.astype(jnp.float32) * target)

        return f

    args = (jnp.asarray(coords), jnp.asarray(weights), jnp.ones((vp,), jnp.float32))
    for argnum in (0, 1, 2):
        gp = np.asarray(jax.grad(loss("pallas", "bfloat16"), argnums=argnum)(*args))
        gd = np.asarray(jax.grad(loss("dense", "float32"), argnums=argnum)(*args))
        scale = max(np.abs(gd).max(), 1e-6)
        np.testing.assert_allclose(gp, gd, atol=3e-2 * scale, err_msg=f"argnum={argnum}")


def test_pallas_grad_depth_slab(rng):
    """Gradient through a depth slab (d_offset/d_count), the depth-sharded
    training configuration."""
    v, vp, c = 20, 32, 2
    coords = jnp.asarray(np.pad(rng.uniform(-2.5, 2.5, (v, 3)), ((0, vp - v), (0, 0))).astype(np.float32))
    weights = jnp.asarray(np.pad(rng.uniform(size=(v, c)), ((0, vp - v), (0, 0))).astype(np.float32))
    radii = jnp.ones((vp,), jnp.float32)
    mask = jnp.arange(vp) < v
    target = jnp.asarray(rng.normal(size=(c, 8, 16, 16)).astype(np.float32))

    def loss_impl(impl):
        def loss(crd, w):
            out = voxelize(crd, w, radii, spec=SPEC16, mask=mask, impl=impl, d_offset=4, d_count=8)
            return jnp.sum(out * target)

        return loss

    for argnum in (0, 1):
        gp = np.asarray(jax.grad(loss_impl("pallas"), argnums=argnum)(coords, weights))
        gd = np.asarray(jax.grad(loss_impl("dense"), argnums=argnum)(coords, weights))
        np.testing.assert_allclose(gp, gd, atol=2e-4, err_msg=f"argnum={argnum}")


def test_channelwise_batched_grad_matches_dense(rng):
    """Channel-wise radii through voxelize_batch: kernel forward, dense VJP."""
    import molvoxel_tpu.ops.batch as ob

    b, vp, v, c = 2, 64, 40, 3
    coords = jnp.asarray(rng.uniform(-3, 3, (b, vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.1, 1.0, (b, vp, c)).astype(np.float32))
    radii = jnp.asarray([0.9, 1.2, 1.5], jnp.float32)
    mask = jnp.asarray(np.broadcast_to(np.arange(vp) < v, (b, vp)))
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    target = jnp.asarray(rng.normal(size=(b, c, 16, 16, 16)).astype(np.float32))

    def loss(impl):
        def f(crd, w, r):
            out = ob.voxelize_batch(crd, w, r, mask, None, keys, 0.5, spec=SPEC16, impl=impl,
                                    channelwise=True, random_rotation=True)
            return jnp.sum(out * target)

        return f

    for argnum in (0, 1, 2):
        gp = np.asarray(jax.grad(loss("pallas"), argnums=argnum)(coords, weights, radii))
        gd = np.asarray(jax.grad(loss("dense"), argnums=argnum)(coords, weights, radii))
        np.testing.assert_allclose(gp, gd, atol=5e-4, err_msg=f"argnum={argnum}")


@pytest.mark.parametrize("density", ["gaussian", "binary"])
def test_kernel_vjp_is_dense_vjp(rng, density):
    """The gradient rule: the kernel's backward is the VJP of the dense path,
    applied to the same cotangent."""
    from molvoxel_tpu.ops.autodiff import _dense_batch, voxelize_pallas_batch_ad

    b, vp, c = 2, 32, 2
    coords = jnp.asarray(rng.uniform(-2.5, 2.5, (b, vp, 3)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.1, 1.0, (b, vp, c)).astype(np.float32))
    radii = jnp.asarray(rng.uniform(0.8, 1.4, (b, vp)).astype(np.float32))
    mask = jnp.asarray(rng.uniform(size=(b, vp)) < 0.8)
    ct = jnp.asarray(rng.normal(size=(b, c, 16, 16, 16)).astype(np.float32))
    static = (SPEC16, density, 0.5, False, None)

    _, vjp_k = jax.vjp(lambda *a: voxelize_pallas_batch_ad(*a, mask, 0, *static, "float32", False),
                       coords, weights, radii)
    _, vjp_d = jax.vjp(lambda *a: _dense_batch(*a, mask, 0, *static), coords, weights, radii)
    for gk, gd in zip(vjp_k(ct), vjp_d(ct)):
        np.testing.assert_allclose(np.asarray(gk), np.asarray(gd), rtol=1e-6, atol=1e-6)
