"""The codec's dispatch: which implementation each lowering gets, the
kernel inside the elementwise op, and the generic stepwise op through the
kernel."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as F
from fewbit_tpu.functional.activations import resolve_activation
from fewbit_tpu.ops import codec

SPEC, BORDERS, LEVELS = resolve_activation("gelu", bits=3)
X = 3.0 * jax.random.normal(jax.random.key(0), (64, 128))


def _lowered(fn, platform):
    # A fresh function each time: jit caches traces by function identity.
    return jax.jit(lambda x: fn(x)).trace(X).lower(
        lowering_platforms=(platform,)).as_text()


def _forward(x):
    return codec.forward(SPEC, x, BORDERS)


def _backward(x):
    _, packed = codec.plain_forward(SPEC, x, BORDERS)
    return codec.backward(SPEC, packed, LEVELS, x)


def test_cpu_lowering_runs_the_plain_path():
    assert "triton" not in _lowered(_forward, "cpu")
    y, packed = jax.jit(_forward)(X)
    y0, packed0 = jax.jit(lambda x: codec.plain_forward(SPEC, x, BORDERS))(X)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(packed0))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y0))


def test_cuda_lowering_runs_the_forward_kernel():
    assert "triton" in _lowered(_forward, "cuda")


def test_backward_is_the_plain_path_everywhere():
    for platform in ("cpu", "cuda"):
        assert "triton" not in _lowered(_backward, platform)


def test_the_switch_turns_the_kernel_off(monkeypatch):
    monkeypatch.setattr(codec, "_GPU_KERNEL", False)
    assert "triton" not in _lowered(_forward, "cuda")


def test_elementwise_op_through_the_kernel(kernel_codec):
    """F.gelu's value and gradient with the kernel's residual equal the
    plain path's, bit for bit."""
    def run():
        def f(x):
            y, vjp = jax.vjp(lambda t: F.gelu(t, bits=3), x)
            return y, vjp(X)[0]

        return jax.jit(f)(X)

    y_k, g_k = run()
    kernel_codec.forward = kernel_codec.plain_forward
    y_p, g_p = run()
    np.testing.assert_array_equal(np.asarray(y_k), np.asarray(y_p))
    np.testing.assert_array_equal(np.asarray(g_k), np.asarray(g_p))


@pytest.mark.parametrize("parity", [None, False, True],
                         ids=["plain", "even", "odd"])
def test_generic_stepwise_through_the_kernel(kernel_codec, parity):
    """The user stepwise op (shifted, half-domain LUTs included) packs the
    same words through the kernel as through the plain path."""
    borders = jnp.asarray([0.25, 0.5, 1.0, 2.0], jnp.float32)
    levels = jnp.asarray([0.1, 0.4, 0.7, 1.0, 1.3], jnp.float32)

    def grad():
        return jax.jit(jax.grad(lambda x: (F.stepwise(
            x, borders, levels, parity=parity, shift=(0.5, 0.0)) * X).sum()))(
                X)

    g_k = grad()
    kernel_codec.forward = kernel_codec.plain_forward
    np.testing.assert_array_equal(np.asarray(g_k), np.asarray(grad()))


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_on_a_gpu():
    """The kernel as compiled for the card (no interpret mode)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the CPU suite runs the kernel interpreted")
    y_k, packed_k = jax.jit(lambda x: codec.triton_forward(
        SPEC, x, BORDERS))(X)
    y_p, packed_p = jax.jit(lambda x: codec.plain_forward(
        SPEC, x, BORDERS))(X)
    np.testing.assert_array_equal(np.asarray(packed_k), np.asarray(packed_p))
    assert np.max(np.abs(np.asarray(y_k) - np.asarray(y_p))) <= 1e-6
