"""Randomized linear tests.

Strategy follows the reference (modules/linear_test.py:46-104): forward must
match the exact linear to ~1e-6; weight gradients averaged over many
resampled sketches must converge to the exact gradient (unbiasedness);
input/bias gradients are exact.  Unlike the reference, the Monte-Carlo check
runs for *all four* sketch types (the reference only exercised gaussian, and
its dct/dft scaling is biased — see functional/linear.py docstring).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as F

RNG = np.random.RandomState(17)
X = jnp.asarray(RNG.randn(128, 64), jnp.float32)
W = jnp.asarray(RNG.randn(32, 64) * 0.1, jnp.float32)
B = jnp.asarray(RNG.randn(32) * 0.1, jnp.float32)


def exact_grads(with_bias=True):
    def loss(w, b):
        return F.linear(X, w, b if with_bias else None).sum()
    return jax.grad(loss, argnums=(0, 1))(W, B)


def mc_weight_grad(repeats=4096, with_bias=True, **kwargs):
    """Average sketched weight grads over `repeats` fresh keys via lax.scan."""
    kwargs.setdefault("proj_dim", 16)

    def loss(w, b, key):
        y = F.linear_grp(X, w, b if with_bias else None, key, **kwargs)
        return y.sum()

    grad_fn = jax.grad(loss, argnums=(0, 1))

    def body(acc, key):
        gw, gb = grad_fn(W, B, key)
        return (acc[0] + gw, acc[1] + gb), None

    keys = jax.random.split(jax.random.key(0), repeats)
    (gw_sum, gb_sum), _ = jax.lax.scan(
        body, (jnp.zeros_like(W), jnp.zeros_like(B)), keys)
    return gw_sum / repeats, gb_sum / repeats


class TestLinearGRP:

    def test_forward_exact(self):
        key = jax.random.key(1)
        for bias in (None, B):
            y = F.linear_grp(X, W, bias, key, proj_dim_ratio=0.25)
            z = F.linear(X, W, bias)
            np.testing.assert_allclose(np.asarray(y), np.asarray(z),
                                       atol=1e-6)

    @pytest.mark.parametrize(
        "matmul",
        ["gaussian", "rademacher", "dct", "dft", "countsketch", "srht"])
    def test_weight_grad_unbiased(self, matmul):
        gw_exact, gb_exact = exact_grads()
        gw_mc, gb_mc = mc_weight_grad(matmul=matmul)
        rel = (np.linalg.norm(np.asarray(gw_mc) - np.asarray(gw_exact))
               / np.linalg.norm(np.asarray(gw_exact)))
        assert rel < 0.12, f"{matmul}: rel err {rel:.3f}"
        np.testing.assert_allclose(np.asarray(gb_mc), np.asarray(gb_exact),
                                   rtol=1e-4, atol=1e-4)

    def test_input_grad_exact(self):
        key = jax.random.key(3)

        def loss(x):
            return (F.linear_grp(x, W, B, key, proj_dim=8) ** 2).sum()

        def loss_exact(x):
            return (F.linear(x, W, B) ** 2).sum()

        gx = jax.grad(loss)(X)
        gx_exact = jax.grad(loss_exact)(X)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(gx_exact),
                                   atol=1e-4)

    def test_residual_holds_sketch_not_input(self):
        key = jax.random.key(4)
        big = jnp.zeros((4096, 64), jnp.float32)
        _, vjp = jax.vjp(
            lambda x, w: F.linear_grp(x, w, None, key, proj_dim=32), big, W)
        leaves = jax.tree_util.tree_leaves(vjp)
        sizes = sorted(l.size for l in leaves)
        # Largest residual should be the (32, 64) sketch or the weight, never
        # the (4096, 64) input.
        assert max(sizes) <= W.size

    def test_srht_non_power_of_two_batch(self):
        # 100 rows pad to 128 inside the transform; forward stays exact and
        # gradients stay finite with the right shapes.
        key = jax.random.key(11)
        x = jnp.asarray(RNG.randn(100, 64), jnp.float32)
        y = F.linear_grp(x, W, B, key, proj_dim=16, matmul="srht")
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(F.linear(x, W, B)), atol=1e-5)
        gw = jax.grad(lambda w: F.linear_grp(
            x, w, B, key, proj_dim=16, matmul="srht").sum())(W)
        assert gw.shape == W.shape
        assert np.isfinite(np.asarray(gw)).all()

    def test_batched_input_shapes(self):
        key = jax.random.key(5)
        x3 = jnp.asarray(RNG.randn(4, 16, 64), jnp.float32)
        y = F.linear_grp(x3, W, B, key, proj_dim_ratio=0.5)
        assert y.shape == (4, 16, 32)
        g = jax.grad(lambda x: F.linear_grp(
            x, W, B, key, proj_dim_ratio=0.5).sum())(x3)
        assert g.shape == x3.shape

    def test_param_validation(self):
        key = jax.random.key(0)
        with pytest.raises(ValueError):
            F.linear_grp(X, W, B, key)  # neither ratio nor dim
        with pytest.raises(ValueError):
            F.linear_grp(X, W, B, key, proj_dim=4, proj_dim_min=0)
        with pytest.raises(ValueError):
            F.linear_grp(X, W, B, key, proj_dim=4, proj_dim_min=8,
                         proj_dim_max=2)
        with pytest.raises(ValueError):
            F.linear_grp(X, W, B, key, proj_dim=4, matmul="hadamard")

    def test_calc_proj_dim(self):
        assert F.calc_proj_dim(100, proj_dim_ratio=0.1) == 10
        assert F.calc_proj_dim(100, proj_dim=7) == 7
        assert F.calc_proj_dim(100, proj_dim_ratio=0.1, proj_dim_min=32) == 32
        assert F.calc_proj_dim(100, proj_dim_ratio=0.9, proj_dim_max=16) == 16
        assert F.calc_proj_dim(100) == 100


class TestLinearCRS:

    def test_forward_exact(self):
        key = jax.random.key(1)
        y = F.linear_crs(X, W, B, key, nopairs=8)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(F.linear(X, W, B)), atol=1e-6)

    def test_weight_grad_unbiased(self):
        gw_exact, _ = exact_grads()

        def grad_one(key):
            return jax.grad(
                lambda w: F.linear_crs(X, w, B, key, nopairs=16).sum())(W)

        keys = jax.random.split(jax.random.key(2), 4096)
        def body(acc, key):
            return acc + grad_one(key), None
        gw_sum, _ = jax.lax.scan(body, jnp.zeros_like(W), keys)
        gw_mc = gw_sum / 4096
        rel = (np.linalg.norm(np.asarray(gw_mc) - np.asarray(gw_exact))
               / np.linalg.norm(np.asarray(gw_exact)))
        assert rel < 0.12, f"crs rel err {rel:.3f}"

    def test_rejects_bad_nopairs(self):
        with pytest.raises(ValueError):
            F.linear_crs(X, W, B, jax.random.key(0), nopairs=0)


class TestVariance:

    def test_sgd_variance_definition(self):
        # For k-row subsampling, Var of the subsampled grad estimator equals
        # the analytic formula; check against brute force on a tiny case.
        rng = np.random.RandomState(0)
        x = jnp.asarray(rng.randn(16, 4), jnp.float32)
        g = jnp.asarray(rng.randn(16, 3), jnp.float32)
        v = float(F.estimate_variance_sgd(x, g))
        # Brute force: variance of single-row estimators times bs.
        xs = np.asarray(x); gs = np.asarray(g)
        outers = np.einsum("ni,nj->nij", gs, xs) * 16
        mean = outers.mean(0)
        # estimate_variance_sgd = E||G_i - G||^2 / (bs - 1) for the
        # single-row estimator G_i = bs * g_i x_i^T.
        brute = ((outers - mean) ** 2).sum(axis=(1, 2)).mean() / 15
        np.testing.assert_allclose(v, brute, rtol=0.05)

    def test_rmm_variance_positive(self):
        rng = np.random.RandomState(1)
        x = jnp.asarray(rng.randn(64, 8), jnp.float32)
        g = jnp.asarray(rng.randn(64, 8), jnp.float32)
        assert float(F.estimate_variance_rmm(x, g, 16)) > 0

    def test_correlation_bounds(self):
        rng = np.random.RandomState(2)
        x = jnp.asarray(rng.randn(32, 8), jnp.float32)
        c = float(F.estimate_correlation(x, x))
        assert 0.0 < c <= 1.0 + 1e-6

    def test_catch_gradients(self):
        storage = F.GradientStorage()
        x = jnp.ones((4, 3))

        def loss(x):
            return (F.catch_gradients(x, storage) * 2.0).sum()

        g = jax.grad(loss)(x)
        jax.effects_barrier()
        np.testing.assert_allclose(np.asarray(g), 2.0)
        assert storage.input is not None
        np.testing.assert_allclose(np.asarray(storage.grad_output), 2.0)


class TestCountsketchLinear:
    """RandomizedDense's countsketch VJP on the plain path: exact forward
    and input gradient, and a weight gradient that is the product of the
    two stride-partition sketches built with the same signs."""

    N, KDIM, M = 2048, 256, 384
    K = 400  # -> k_eff = 512 (rounded up, never less accurate)

    def _data(self, m=None):
        rng = np.random.RandomState(5)
        m = m or self.M
        x = jnp.asarray(rng.randn(self.N, self.KDIM), jnp.float32)
        kernel = jnp.asarray(rng.randn(self.KDIM, m) * 0.05, jnp.float32)
        b = jnp.asarray(rng.randn(m) * 0.05, jnp.float32)
        g = jnp.asarray(rng.randn(self.N, m), jnp.float32)
        return x, kernel, b, g

    def test_partition_rounds_up_to_an_exact_divisor(self):
        from fewbit_tpu.functional.linear import _countsketch_partition

        assert _countsketch_partition(self.N, self.K) == (4, 512)
        assert _countsketch_partition(1024, 2048) == (1, 1024)
        # No exact divisor within 2x the request: fold the tail instead.
        assert _countsketch_partition(1031, 100) is None

    @pytest.mark.parametrize("m", [384, 1536], ids=["narrow", "ffn_width"])
    def test_vjp_matches_reference(self, m):
        from fewbit_tpu.functional.linear import _cs_signs

        x, kernel, b, g = self._data(m)
        key = jax.random.key(7)
        y, vjp = jax.vjp(lambda xx, ww, bb: F.linear_grp_native(
            xx, ww, bb, key, proj_dim=self.K, matmul="countsketch"),
            x, kernel, b)
        dx, dw, db = vjp(g)
        k_eff = 512
        sigma = np.asarray(_cs_signs(key, self.N, jnp.float32))
        xs = np.asarray(x, np.float64) * sigma[:, None]
        gs = np.asarray(g, np.float64) * sigma[:, None]
        sk_x = xs.reshape(-1, k_eff, self.KDIM).sum(0)
        sk_g = gs.reshape(-1, k_eff, m).sum(0)
        np.testing.assert_allclose(y, x @ kernel + b, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(dx, g @ kernel.T, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(db, g.sum(0), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(dw, sk_x.T @ sk_g, rtol=1e-4, atol=1e-2)

    def test_weight_grad_unbiased(self):
        """Averaging dW over many keys converges to the exact gradient."""
        n, kdim, m = 1024, 128, 128
        rng = np.random.RandomState(11)
        x = jnp.asarray(rng.randn(n, kdim), jnp.float32)
        kernel = jnp.asarray(rng.randn(kdim, m) * 0.1, jnp.float32)

        def loss(w, key):
            # 512 buckets: half the batch.
            return F.linear_grp_native(x, w, None, key, proj_dim=512,
                                       matmul="countsketch").sum()

        grad_fn = jax.jit(jax.grad(loss))
        exact = jax.grad(lambda w: (x @ w).sum())(kernel)
        acc = jnp.zeros_like(kernel)
        repeats = 64
        for i in range(repeats):
            acc = acc + grad_fn(kernel, jax.random.key(i))
        approx = acc / repeats
        corr = jnp.sum(approx * exact) / (
            jnp.linalg.norm(approx) * jnp.linalg.norm(exact))
        assert float(corr) > 0.99


class TestSketchDtypePolicy:
    """bf16 models store bf16 sketch residuals; f32 models keep f32.
    Pinned here so a refactor cannot silently revert the bf16 memory saving
    the policy buys."""

    def test_policy_function(self):
        from fewbit_tpu.functional.linear import sketch_dtype

        assert sketch_dtype(jnp.float32) == jnp.float32.dtype
        assert sketch_dtype(jnp.bfloat16) == jnp.bfloat16.dtype
        assert sketch_dtype(jnp.dtype("bfloat16")) == jnp.bfloat16.dtype

    def test_countsketch_signed_storage_and_accumulation(self):
        from fewbit_tpu.functional.linear import _countsketch_signed

        rng = np.random.RandomState(3)
        m32 = jnp.asarray(rng.randn(64, 16), jnp.float32)
        sig = jnp.asarray(rng.choice([-1.0, 1.0], 64), jnp.float32)
        out32 = _countsketch_signed(m32, sig, 16)
        assert out32.dtype == jnp.float32
        outbf = _countsketch_signed(m32.astype(jnp.bfloat16), sig, 16)
        assert outbf.dtype == jnp.bfloat16
        # f32 accumulation: the bf16 result tracks the f32 one closely.
        np.testing.assert_allclose(outbf.astype(jnp.float32), out32,
                                   rtol=2e-2, atol=2e-2)
        # explicit override (used by the ffn fallback path)
        forced = _countsketch_signed(m32, sig, 16, out_dtype=jnp.bfloat16)
        assert forced.dtype == jnp.bfloat16

    def test_grp_residual_dtype_follows_model_dtype(self):
        from fewbit_tpu.functional.linear import linear_grp_native

        rng = np.random.RandomState(4)
        key = jax.random.key(0)
        for dt, want in ((jnp.float32, jnp.float32),
                         (jnp.bfloat16, jnp.bfloat16)):
            x = jnp.asarray(rng.randn(256, 32), dt)
            kern = jnp.asarray(rng.randn(32, 48) * 0.1, dt)
            _, vjp = jax.vjp(
                lambda kk: linear_grp_native(x, kk, None, key,
                                             proj_dim_ratio=0.25,
                                             matmul="countsketch"), kern)
            sketches = [l for l in jax.tree_util.tree_leaves(vjp)
                        if l.ndim == 2 and l.shape[0] < 256]
            assert sketches, "no sketch residual found in the vjp closure"
            assert all(s.dtype == want for s in sketches)
            # gradient comes back in the kernel dtype either way
            (gk,) = vjp(jnp.ones((256, 48), dt))[:1]
            assert gk.dtype == dt
