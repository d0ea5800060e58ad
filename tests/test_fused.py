"""Fused dense + activation op: forward exactness, gradient semantics,
the codec kernel (interpret mode) inside the op, residual accounting."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as F
import fewbit_tpu.modules as M
from fewbit_tpu.lut import store

RNG = np.random.RandomState(3)
X = jnp.asarray(RNG.randn(64, 128), jnp.float32)
W = jnp.asarray(RNG.randn(128, 256) * 0.05, jnp.float32)
B = jnp.asarray(RNG.randn(256) * 0.05, jnp.float32)


def exact(x, w, b):
    return jax.nn.gelu(x @ w + b, approximate=False)


class TestFunctional:

    def test_forward_exact(self):
        y = F.fewbit_dense_act(X, W, B, bits=3)
        np.testing.assert_allclose(np.asarray(y), np.asarray(exact(X, W, B)),
                                   atol=1e-5)

    def test_grad_matches_manual_lut(self):
        borders, levels = store.get_interior("gelu", 3)
        y, vjp = jax.vjp(lambda x, w, b: F.fewbit_dense_act(x, w, b, bits=3),
                         X, W, B)
        g = jnp.ones_like(y)
        dx, dw, db = vjp(g)

        z = np.asarray(X @ W + B)
        mult = levels[np.sum(z[..., None] > borders, axis=-1)]
        dz = mult  # g == 1
        np.testing.assert_allclose(np.asarray(dx), dz @ np.asarray(W).T,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(dw), np.asarray(X).T @ dz,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(db), dz.sum(0), rtol=1e-4,
                                   atol=1e-4)

    def test_residuals_exclude_preactivation(self):
        n = 4096
        x = jnp.zeros((n, 128), jnp.float32)
        _, vjp = jax.vjp(
            lambda x, w: F.fewbit_dense_act(x, w, None, bits=3), x, W)
        leaves = jax.tree_util.tree_leaves(vjp)
        biggest = max(l.size * l.dtype.itemsize for l in leaves)
        # Biggest residual is the input x (saved exactly here), never the
        # fp32 pre-activation z (n x 256 x 4 B).
        assert biggest <= n * 128 * 4

    def test_sketched_residuals(self):
        n = 4096
        x = jnp.zeros((n, 128), jnp.float32)
        _, vjp = jax.vjp(
            lambda x, w: F.fewbit_dense_act(
                x, w, None, jax.random.key(0), bits=3, proj_dim_ratio=0.1),
            x, W)
        leaves = jax.tree_util.tree_leaves(vjp)
        biggest = max(l.size * l.dtype.itemsize for l in leaves)
        # Sketch is (409, 128); codes are 3/8 B per z element.
        assert biggest <= max(409 * 128 * 4, 3 * n * 256 // 8) + 4096

    @pytest.mark.parametrize("matmul", ["countsketch", "gaussian"])
    def test_sketched_grad_unbiased(self, matmul):
        def grad_w(key):
            return jax.grad(lambda w: F.fewbit_dense_act(
                X, w, B, key, bits=3, proj_dim=16,
                matmul=matmul).sum())(W)

        keys = jax.random.split(jax.random.key(1), 2048)
        acc, _ = jax.lax.scan(lambda a, k: (a + grad_w(k), None),
                              jnp.zeros_like(W), keys)
        gw_mc = np.asarray(acc / 2048)
        gw_exact = np.asarray(jax.grad(
            lambda w: F.fewbit_dense_act(X, w, B, bits=3).sum())(W))
        rel = np.linalg.norm(gw_mc - gw_exact) / np.linalg.norm(gw_exact)
        assert rel < 0.12, rel

    def test_binary_activation(self):
        y = F.fewbit_dense_act(X, W, B, activation="relu")
        np.testing.assert_allclose(np.asarray(y),
                                   np.maximum(np.asarray(X @ W + B), 0),
                                   atol=1e-5)
        dx = jax.grad(lambda x: F.fewbit_dense_act(
            x, W, B, activation="relu").sum())(X)
        z = np.asarray(X @ W + B)
        expected = (z > 0).astype(np.float32) @ np.asarray(W).T
        np.testing.assert_allclose(np.asarray(dx), expected, rtol=1e-4,
                                   atol=1e-4)


class TestCodecInsideTheOp:

    def test_kernel_codec_matches_plain(self, kernel_codec):
        def run():
            y, vjp = jax.vjp(
                lambda x, w, b: F.fewbit_dense_act(x, w, b, bits=3), X, W, B)
            return (y, *vjp(jnp.ones_like(y)))

        kernel = run()
        kernel_codec.forward = kernel_codec.plain_forward
        plain = run()
        for name, a, b in zip(["y", "dx", "dw", "db"], kernel, plain):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)


class TestModule:

    def test_module_matches_dense_plus_gelu(self):
        import flax.linen as nn

        mod = M.FusedDenseActivation(features=256, bits=3)
        params = mod.init(jax.random.key(0), X)
        y = mod.apply(params, X)
        ref = nn.Dense(256).apply(params, X)
        np.testing.assert_allclose(
            np.asarray(y),
            np.asarray(jax.nn.gelu(ref, approximate=False)), atol=1e-5)

    def test_module_sketched(self):
        mod = M.FusedDenseActivation(features=256, bits=3,
                                     proj_dim_ratio=0.2)
        params = mod.init({"params": jax.random.key(0),
                           "sketch": jax.random.key(1)}, X)
        g = jax.grad(lambda p: mod.apply(
            p, X, rngs={"sketch": jax.random.key(2)}).sum())(params)
        assert float(jnp.linalg.norm(g["params"]["kernel"])) > 0
