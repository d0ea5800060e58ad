"""Whole FFN block op: forward exactness, LUT gradient semantics, the codec
kernel inside the op, the stored countsketches against a numpy reference,
Monte-Carlo unbiasedness of both weight-gradient estimators, residual
accounting."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as F
from fewbit_tpu.lut import store

RNG = np.random.RandomState(7)
N, K, M, H = 64, 128, 256, 128
X = jnp.asarray(RNG.randn(N, K), jnp.float32)
WU = jnp.asarray(RNG.randn(K, M) * 0.05, jnp.float32)
BU = jnp.asarray(RNG.randn(M) * 0.05, jnp.float32)
WD = jnp.asarray(RNG.randn(M, H) * 0.05, jnp.float32)
BD = jnp.asarray(RNG.randn(H) * 0.05, jnp.float32)
KEY = jax.random.key(11)


def ffn(x, wu, bu, wd, bd, key=KEY, **kw):
    kw.setdefault("bits", 3)
    kw.setdefault("proj_dim_ratio", 0.25)
    return F.fewbit_ffn(x, wu, bu, wd, bd, key, **kw)


def exact(x, wu, bu, wd, bd):
    return jax.nn.gelu(x @ wu + bu, approximate=False) @ wd + bd


class TestForward:

    def test_forward_exact(self):
        y = ffn(X, WU, BU, WD, BD)
        np.testing.assert_allclose(np.asarray(y),
                                   np.asarray(exact(X, WU, BU, WD, BD)),
                                   atol=1e-4, rtol=1e-5)

    def test_forward_leading_dims(self):
        x3 = X.reshape(4, 16, K)
        y = ffn(x3, WU, BU, WD, BD)
        assert y.shape == (4, 16, H)
        np.testing.assert_allclose(np.asarray(y.reshape(N, H)),
                                   np.asarray(ffn(X, WU, BU, WD, BD)),
                                   atol=1e-5)


class TestGradients:

    def test_lut_gradient_semantics(self):
        """dx must flow through levels[codes] * (g @ wd^T), exactly."""
        borders, levels = store.get_interior("gelu", 3)
        y, vjp = jax.vjp(lambda x: ffn(x, WU, BU, WD, BD), X)
        (dx,) = vjp(jnp.ones_like(y))

        z = np.asarray(X @ WU + BU)
        mult = levels[np.sum(z[..., None] > borders, axis=-1)]
        dz = mult * (np.ones((N, H)) @ np.asarray(WD).T)
        np.testing.assert_allclose(np.asarray(dx), dz @ np.asarray(WU).T,
                                   rtol=1e-4, atol=1e-4)

    def test_bias_grads_exact(self):
        borders, levels = store.get_interior("gelu", 3)
        grads = jax.grad(lambda bu, bd: ffn(X, WU, bu, WD, bd).sum(),
                         argnums=(0, 1))(BU, BD)
        z = np.asarray(X @ WU + BU)
        mult = levels[np.sum(z[..., None] > borders, axis=-1)]
        dz = mult * (np.ones((N, H)) @ np.asarray(WD).T)
        np.testing.assert_allclose(np.asarray(grads[0]), dz.sum(0),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(grads[1]),
                                   np.full((H,), float(N)), rtol=1e-5)

    @pytest.mark.parametrize("which", ["up", "down"])
    def test_sketched_weight_grads_unbiased(self, which):
        def grad_w(key):
            if which == "up":
                f = lambda w, k: ffn(X, w, BU, WD, BD, key=k).sum()  # noqa
                wa = WU
            else:
                f = lambda w, k: ffn(X, WU, BU, w, BD, key=k).sum()  # noqa
                wa = WD
            return jax.grad(f)(wa, key)

        keys = jax.random.split(jax.random.key(5), 4096)
        acc, _ = jax.lax.scan(lambda a, k: (a + grad_w(k), None),
                              jnp.zeros(WU.shape if which == "up"
                                        else WD.shape), keys)
        gw_mc = np.asarray(acc / 4096)

        # Exact counterpart with the same LUT backward (dz via codes).
        borders, levels = store.get_interior("gelu", 3)
        z = np.asarray(X @ WU + BU)
        y = np.asarray(jax.nn.gelu(jnp.asarray(z), approximate=False))
        mult = levels[np.sum(z[..., None] > borders, axis=-1)]
        dz = mult * (np.ones((N, H)) @ np.asarray(WD).T)
        gw_exact = (np.asarray(X).T @ dz if which == "up"
                    else y.T @ np.ones((N, H)))
        rel = (np.linalg.norm(gw_mc - gw_exact)
               / np.linalg.norm(gw_exact))
        assert rel < 0.15, rel


class TestResiduals:

    def test_no_full_tensor_saved(self):
        n = 4096
        x = jnp.zeros((n, K), jnp.float32)
        _, vjp = jax.vjp(
            lambda x, wu, wd: F.fewbit_ffn(x, wu, None, wd, None, KEY,
                                           bits=3, proj_dim_ratio=0.1),
            x, WU, WD)
        leaves = jax.tree_util.tree_leaves(vjp)
        biggest = max(l.size * l.dtype.itemsize for l in leaves)
        # Largest residual: the packed codes (3/8 B per pre-activation
        # element) or a (k, M) sketch — never an (n, M) or (n, K) tensor.
        k = 512  # the stride partition may round buckets up
        cap = max(3 * n * M // 8, k * M * 4) + 4096
        assert biggest <= cap, biggest


def _residuals(*args):
    """(packed codes, sketch of x, sketch of y) from the op's VJP closure,
    found by dtype and shape."""
    from fewbit_tpu.functional.ffn import _keff

    _, vjp = jax.vjp(ffn, *args)
    leaves = jax.tree.leaves(vjp)
    k_eff = _keff(N, int(0.25 * N))
    [packed] = [l for l in leaves if l.dtype == jnp.uint32]
    [sk_x] = [l for l in leaves if l.shape == (k_eff, K)]
    [sk_y] = [l for l in leaves if l.shape == (k_eff, M)]
    return packed, sk_x, sk_y, vjp


def _countsketch_numpy(mat, sigma, k_eff):
    """Row r of ``mat`` times sign r, summed into bucket r % k_eff."""
    mat = np.asarray(mat, np.float64) * np.asarray(sigma, np.float64)[:, None]
    out = np.zeros((k_eff, mat.shape[1]))
    np.add.at(out, np.arange(mat.shape[0]) % k_eff, mat)
    return out


class TestCodecInsideTheOp:

    def test_kernel_codec_matches_plain(self, kernel_codec):
        """The op through the Triton codec (interpret mode) gives the plain
        path's outputs and gradients bit for bit."""
        g = jnp.asarray(np.random.RandomState(1).randn(N, H), jnp.float32)

        def run():
            y, vjp = jax.vjp(ffn, X, WU, BU, WD, BD)
            return (y, *vjp(g))

        kernel = run()
        kernel_codec.forward = kernel_codec.plain_forward
        plain = run()
        for name, a, b in zip(["y", "dx", "dwu", "dbu", "dwd", "dbd"],
                              kernel, plain):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)

    def test_stored_sketches_match_numpy(self):
        """The residual sketches are the signed stride-partition bucket sums
        of x and of y = gelu(x W_up + b_up), with the op's own signs."""
        from fewbit_tpu.functional.ffn import _signs

        packed, sk_x, sk_y, _ = _residuals(X, WU, BU, WD, BD)
        k_eff = sk_x.shape[0]
        sig_up = _signs(jax.random.fold_in(KEY, 0), N)
        sig_down = _signs(jax.random.fold_in(KEY, 1), N)
        y = jax.nn.gelu(X @ WU + BU, approximate=False)
        np.testing.assert_allclose(np.asarray(sk_x),
                                   _countsketch_numpy(X, sig_up, k_eff),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(sk_y),
                                   _countsketch_numpy(y, sig_down, k_eff),
                                   rtol=1e-4, atol=1e-4)
        assert packed.shape == (3, N * M // 32)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_sketch_storage_follows_model_dtype(self, dtype):
        """bf16 models store bf16 sketches, f32 models f32; the packed
        codes are uint32 either way."""
        args = [a.astype(dtype) for a in (X, WU, BU, WD, BD)]
        packed, sk_x, sk_y, vjp = _residuals(*args)
        assert sk_x.dtype == dtype and sk_y.dtype == dtype
        grads = vjp(jnp.ones((N, H), dtype))
        assert all(g.dtype == dtype for g in grads)


class TestModule:

    def test_module(self):
        from fewbit_tpu.modules import FewBitFFN

        mod = FewBitFFN(inner_features=M, out_features=H, bits=3,
                        proj_dim_ratio=0.2)
        params = mod.init({"params": jax.random.key(0),
                           "sketch": jax.random.key(1)}, X)
        y = mod.apply(params, X, rngs={"sketch": jax.random.key(2)})
        assert y.shape == (N, H)
        g = jax.grad(lambda p: mod.apply(
            p, X, rngs={"sketch": jax.random.key(2)}).sum())(params)
        for leaf in jax.tree_util.tree_leaves(g):
            assert bool(jnp.all(jnp.isfinite(leaf)))
