"""Shared cases for the codec tests: every activation of the library, each
at its bit widths, on an aligned and a ragged shape.

Forward: the Triton kernel in interpret mode against the plain path — the
packed words bit for bit, ``y`` to the last bit on the CPU.  Backward: the
plain path against a numpy reference built from the packed layout itself
(element ``i * m + j`` is bit ``i`` of word ``j``).
"""

import zlib

import numpy as np

import jax
import jax.numpy as jnp

from fewbit_tpu.functional.activations import CONTINUOUS, resolve_activation
from fewbit_tpu.ops import codec

PIECEWISE = ("hardshrink", "hardsigmoid", "hardtanh", "leaky_relu", "relu",
             "relu6", "softshrink", "threshold")
SHAPES = {"aligned": (64, 128), "ragged": (7, 33)}


def cases():
    out = [(name, bits) for name in CONTINUOUS for bits in (1, 2, 3, 4)]
    return out + [(name, None) for name in PIECEWISE]


def case_id(case):
    name, bits = case
    return name if bits is None else f"{name}{bits}"


def unpack_numpy(packed, bits: int, n: int) -> np.ndarray:
    packed = np.asarray(packed, np.uint32)
    m = packed.shape[1]
    shift = np.arange(32, dtype=np.uint32)[:, None]
    codes = np.zeros((32, m), np.uint32)
    for b in range(bits):
        codes |= ((packed[b][None, :] >> shift) & 1) << np.uint32(b)
    return codes.reshape(-1)[:n]


def check(name, bits, dtype, shape):
    spec, borders, levels = resolve_activation(name, bits=bits)
    kx, kg = jax.random.split(jax.random.key(zlib.crc32(f"{name}{shape}".encode())))
    x = (3.0 * jax.random.normal(kx, shape)).astype(dtype)
    g = jax.random.normal(kg, shape).astype(dtype)

    y_k, packed_k = jax.jit(lambda t: codec.triton_forward(
        spec, t, borders, interpret=True))(x)
    y_p, packed_p = jax.jit(lambda t: codec.plain_forward(
        spec, t, borders))(x)
    np.testing.assert_array_equal(np.asarray(packed_k), np.asarray(packed_p))
    if dtype == jnp.float32:
        np.testing.assert_array_equal(np.asarray(y_k), np.asarray(y_p))
    else:
        # XLA rounds after each op of a bfloat16 chain, the kernel once (see
        # codec.kernel_fwd): its y is the nearest bfloat16 to the float32
        # value, never farther from it than the plain path's.
        want = jax.jit(lambda t: codec.kernel_fwd(spec, t).astype(t.dtype))(x)
        np.testing.assert_array_equal(np.asarray(y_k, np.float32),
                                      np.asarray(want, np.float32))
        exact = np.asarray(jax.jit(lambda t: codec.kernel_fwd(spec, t))(x),
                           np.float32)
        err_k = np.abs(np.asarray(y_k, np.float32) - exact)
        err_p = np.abs(np.asarray(y_p, np.float32) - exact)
        assert (err_k <= err_p).all()

    # The codes the layout holds are the codes of x.
    n = x.size
    codes = unpack_numpy(packed_p, spec.bits, n)
    want = np.asarray(spec.codes(x, borders, spec.args)).reshape(-1)
    np.testing.assert_array_equal(codes, want)

    # Backward: levels[code] * g, in float32, rounded to g's dtype.
    dx = jax.jit(lambda p, t: codec.plain_backward(spec, p, levels, t))(
        packed_p, g)
    ref = (np.asarray(levels, np.float32)[codes].reshape(shape)
           * np.asarray(g, np.float32))
    np.testing.assert_array_equal(np.asarray(dx, np.float32),
                                  np.asarray(jnp.asarray(ref).astype(dtype),
                                             np.float32))
