"""Functional few-bit activation API.

Every function computes the exact activation forward and a few-bit
backward-pass (see :mod:`fewbit_tpu.ops.activations`).  Capability parity
with the reference surface (``/root/reference/fewbit/functional/activations.py``),
with three deliberate upgrades:

* the generic user-LUT ``stepwise`` is actually implemented (the reference
  declares the op but raises ``NotImplementedError``,
  ``functional/activations.py:132-142``);
* relu6's forward is correct for ``x >= 6`` (reference CUDA bug,
  ``cuda/codec.cu:437``);
* non-power-of-two custom LUTs are packed at ``ceil(log2(len(levels)))``
  bits instead of being rejected.

Continuous functions accept ``bits=`` (default 3) or explicit
``borders=``/``values=`` keyword arguments, mirroring the reference's
``dispatch()`` injection (``functional/activations.py:145-218``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fewbit_tpu.lut import store
from fewbit_tpu.ops.activations import (ActivationSpec, compare_codes,
                                        fewbit_activation)

STEPWISE = ("hardshrink", "hardsigmoid", "hardtanh", "leaky_relu", "relu",
            "relu6", "softshrink", "stepwise", "threshold")

CONTINUOUS = ("celu", "elu", "gelu", "hardswish", "logsigmoid", "mish", "selu",
              "sigmoid", "silu", "softplus", "softsign", "tanh", "tanhshrink")

__all__ = STEPWISE + CONTINUOUS + ("store",)

_EMPTY = None  # lazily-created empty borders array


def _empty_borders() -> jax.Array:
    return jnp.zeros((0,), dtype=jnp.float32)


# ---------------------------------------------------------------------------
# 1-bit piecewise family.  Each entry: exact forward + predicate bit +
# two-valued derivative.  Backward multipliers follow the reference kernels
# (cuda/codec.cu:271-487): pass-through/zero for most, 1/6 for hardsigmoid,
# negative_slope for leaky_relu.
# ---------------------------------------------------------------------------


def _binary_call(name, fwd, pred, x, args, level_lo, level_hi):
    spec = ActivationSpec(name=name, bits=1, fwd=fwd, codes=pred, args=args,
                          n_borders=0)
    levels = jnp.array([level_lo, level_hi], dtype=jnp.float32)
    return fewbit_activation(spec, x, _empty_borders(), levels)


def _hardshrink_fwd(x, args):
    (lambd,) = args
    return jnp.where(jnp.abs(x) > lambd, x, jnp.zeros_like(x))


def _hardshrink_pred(x, borders, args):
    (lambd,) = args
    return (jnp.abs(x) > lambd).astype(jnp.uint32)


def hardshrink(x: jax.Array, lambd: float = 0.5) -> jax.Array:
    """Hard shrinkage; saves 1 bit/element for backward."""
    return _binary_call("hardshrink", _hardshrink_fwd, _hardshrink_pred, x,
                        (float(lambd),), 0.0, 1.0)


def _hardsigmoid_fwd(x, args):
    return jnp.clip(x / 6.0 + 0.5, 0.0, 1.0).astype(x.dtype)


def _hardsigmoid_pred(x, borders, args):
    return ((x > -3.0) & (x < 3.0)).astype(jnp.uint32)


def hardsigmoid(x: jax.Array) -> jax.Array:
    return _binary_call("hardsigmoid", _hardsigmoid_fwd, _hardsigmoid_pred, x,
                        (), 0.0, 1.0 / 6.0)


def _hardtanh_fwd(x, args):
    lo, hi = args
    return jnp.clip(x, lo, hi)


def _hardtanh_pred(x, borders, args):
    lo, hi = args
    return ((x > lo) & (x < hi)).astype(jnp.uint32)


def hardtanh(x: jax.Array, min_val: float = -1.0,
             max_val: float = 1.0) -> jax.Array:
    return _binary_call("hardtanh", _hardtanh_fwd, _hardtanh_pred, x,
                        (float(min_val), float(max_val)), 0.0, 1.0)


def _leaky_relu_fwd(x, args):
    (slope,) = args
    return jnp.where(x >= 0, x, x * slope)


def _positive_pred(x, borders, args):
    return (x > 0).astype(jnp.uint32)


def leaky_relu(x: jax.Array, negative_slope: float = 0.01) -> jax.Array:
    return _binary_call("leaky_relu", _leaky_relu_fwd, _positive_pred, x,
                        (float(negative_slope),), float(negative_slope), 1.0)


def _relu_fwd(x, args):
    return jnp.maximum(x, 0)


def relu(x: jax.Array) -> jax.Array:
    return _binary_call("relu", _relu_fwd, _positive_pred, x, (), 0.0, 1.0)


def _relu6_fwd(x, args):
    # Correct clamp at 6 (the reference CUDA kernel emits 1.0 there).
    return jnp.clip(x, 0.0, 6.0)


def _relu6_pred(x, borders, args):
    return ((x > 0.0) & (x < 6.0)).astype(jnp.uint32)


def relu6(x: jax.Array) -> jax.Array:
    return _binary_call("relu6", _relu6_fwd, _relu6_pred, x, (), 0.0, 1.0)


def _softshrink_fwd(x, args):
    (lambd,) = args
    return jnp.where(x > lambd, x - lambd,
                     jnp.where(x < -lambd, x + lambd, jnp.zeros_like(x)))


def softshrink(x: jax.Array, lambd: float = 0.5) -> jax.Array:
    return _binary_call("softshrink", _softshrink_fwd, _hardshrink_pred, x,
                        (float(lambd),), 0.0, 1.0)


def _threshold_fwd(x, args):
    thresh, value = args
    return jnp.where(x > thresh, x, jnp.full_like(x, value))


def _threshold_pred(x, borders, args):
    thresh, _ = args
    return (x > thresh).astype(jnp.uint32)


def threshold(x: jax.Array, threshold: float, value: float) -> jax.Array:
    return _binary_call("threshold", _threshold_fwd, _threshold_pred, x,
                        (float(threshold), float(value)), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Generic user-defined stepwise activation.
# ---------------------------------------------------------------------------


def _stepwise_fwd_identity(x, args):
    # The generic stepwise op only alters the backward pass; forward is
    # identity (the user composes it with whatever forward they like).
    return x


def stepwise(x: jax.Array,
             borders: jax.Array,
             levels: jax.Array,
             parity: Optional[bool] = None,
             shift: Optional[Tuple[float, float]] = None) -> jax.Array:
    """Identity forward with a user-defined stepwise derivative.

    ``borders`` may include the outer domain edges (they are stripped).  With
    ``parity`` set, the LUT describes the right half-domain of a symmetric
    derivative: ``parity=False`` (even derivative, odd function) quantises
    ``|x - s|``; ``parity=True`` (odd derivative) additionally flips the sign
    of the level for ``x < s``.  ``shift=(s, t)`` recentres the derivative at
    ``s`` and adds the constant ``t``.
    """
    borders = jnp.asarray(borders, dtype=jnp.float32)
    levels = jnp.asarray(levels, dtype=jnp.float32)
    if borders.ndim != 1 or levels.ndim != 1:
        raise ValueError("borders and levels must be 1-D")
    if borders.shape[0] == levels.shape[0] + 1:
        borders = borders[1:-1]
    if borders.shape[0] != levels.shape[0] - 1:
        raise ValueError(
            f"expected len(borders) == len(levels) - 1, got "
            f"{borders.shape[0]} vs {levels.shape[0]}")
    if levels.shape[0] > 256:
        raise ValueError("at most 256 levels are supported")
    bits = max(1, math.ceil(math.log2(levels.shape[0])))

    s, t = shift if shift is not None else (0.0, 0.0)

    if parity is None:
        def codes(x, b, args):
            return compare_codes(x - s if s else x, b, args)

        def fwd(x, args):
            return x

        spec = ActivationSpec("stepwise", bits, fwd, codes,
                              args=(float(s), float(t), -1),
                              n_borders=int(borders.shape[0]))
        if t:
            levels = levels + t
        return fewbit_activation(spec, x, borders, levels)

    # Half-domain LUT: quantise |x - s|; odd derivatives flip sign below s.
    # The sign bit becomes one extra code bit so backward stays LUT-only.
    sign_bits = bits + 1 if parity else bits

    def codes(x, b, args):
        xs = x - s if s else x
        base = compare_codes(jnp.abs(xs), b, args)
        if parity:
            # The negative half-table starts at the *padded* half size
            # (1 << bits), not at len(levels) — they differ whenever the user
            # LUT is not a power of two.
            base = base + jnp.where(xs < 0, jnp.uint32(1 << bits),
                                    jnp.uint32(0))
        return base

    def fwd(x, args):
        return x

    full_levels = levels
    if parity:
        pad = (1 << bits) - levels.shape[0]
        pos = jnp.pad(levels, (0, pad)) if pad else levels
        neg = -pos
        full_levels = jnp.concatenate([pos, neg])
        # Table is 2**(bits+1) long only if needed; pad to pow2.
        pad2 = (1 << sign_bits) - full_levels.shape[0]
        if pad2:
            full_levels = jnp.pad(full_levels, (0, pad2))
    if t:
        full_levels = full_levels + t

    spec = ActivationSpec("stepwise", sign_bits, fwd, codes,
                          args=(float(s), float(t), int(bool(parity))),
                          n_borders=int(borders.shape[0]))
    return fewbit_activation(spec, x, borders, full_levels)


# ---------------------------------------------------------------------------
# Continuous family: exact forward, LUT-quantised derivative.
#
# The Triton route has no lowering for ``lax.erfc``, so the codec kernel
# computes GELU from ``_erfc_f32``: the same float32 rational approximation,
# coefficients and op order that XLA expands ``erfc`` into, so the kernel's
# ``y`` agrees with ``jax.nn.gelu`` to the last bit or two.  Every other
# forward lowers as written.
# ---------------------------------------------------------------------------


# Bind the exact implementations at import time so the engine stays
# self-consistent when fewbit_tpu.patch later monkey-patches jax.nn.
_JAX_GELU = jax.nn.gelu
_JAX_SILU = jax.nn.silu
_JAX_SIGMOID = jax.nn.sigmoid

_f32 = np.float32
_ERF_T = tuple(_f32(c) for c in (
    7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129,
    0.112835854, -0.37612626, 1.12837911))
_ERFC_P = tuple(_f32(c) for c in (
    0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469,
    -0.494451523, 0.340488, -0.274112701, 0.563825965))
_ERFC_R = tuple(_f32(c) for c in (
    -10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523, 0.42184633,
    -0.282076746, 0.564189494))


def _horner(t, coeffs):
    acc = t * coeffs[0] + coeffs[1]
    for c in coeffs[2:]:
        acc = acc * t + c
    return acc


def _erfc_f32(x: jax.Array) -> jax.Array:
    """float32 ``erfc`` as XLA expands it: ``1 - x T(x^2)`` for |x| < 1,
    else ``exp(-x^2) / |x| * P|R(1 / x^2)`` reflected for x < 0."""
    one, two = _f32(1), _f32(2)
    ax = jnp.abs(x)
    small = one - x * _horner(x * x, _ERF_T)
    z = -(x * x)
    q = one / (x * x)
    tail = jnp.exp(z) * (one / ax) * jnp.where(
        ax < two, _horner(q, _ERFC_P), _horner(q, _ERFC_R))
    tail = jnp.where(z < _f32(-88.7228394), _f32(0), tail)
    large = jnp.where(x < 0, two - tail, tail)
    return jnp.where(ax < one, small, large)


def _gelu_kfwd(x, args):
    """``jax.nn.gelu(x, approximate=False)`` in its own op order and dtypes:
    a bfloat16 input rounds after each op, and ``erfc`` runs in float32."""
    sqrt_half = np.sqrt(0.5).astype(x.dtype)
    e = _erfc_f32(((-x) * sqrt_half).astype(jnp.float32)).astype(x.dtype)
    return np.asarray(0.5, x.dtype) * x * e


def _resolve_lut(name: str, bits: Optional[int], borders, values):
    use_builtin = bits is not None
    use_custom = borders is not None and values is not None
    if use_builtin and use_custom:
        raise ValueError(
            "specify either `bits` or `borders`+`values`, not both")
    if use_custom:
        borders = jnp.asarray(borders, dtype=jnp.float32)
        values = jnp.asarray(values, dtype=jnp.float32)
        if borders.shape[0] == values.shape[0] + 1:
            borders = borders[1:-1]
        if borders.shape[0] != values.shape[0] - 1:
            raise ValueError(
                f"expected len(borders) == len(values) - 1, got "
                f"{borders.shape[0]} vs {values.shape[0]}")
        nbits = max(1, math.ceil(math.log2(values.shape[0])))
        pad = (1 << nbits) - values.shape[0]
        if pad:
            values = jnp.pad(values, (0, pad))
        return borders, values, nbits
    nbits = bits if bits is not None else 3
    b, v = store.get_interior(name, nbits)
    return jnp.asarray(b), jnp.asarray(v), nbits


def _continuous_call(name, fwd, x, args, bits, borders, values):
    spec, b, v = resolve_activation(name, bits=bits, borders=borders,
                                    values=values, args=args, fwd=fwd)
    return fewbit_activation(spec, x, b, v)


def resolve_activation(name: str, bits: Optional[int] = None, borders=None,
                       values=None, args: tuple = (), fwd=None):
    """Build the (spec, borders, levels) triple for an activation by name —
    shared by the elementwise engine and the fused dense+activation op."""
    if name in CONTINUOUS:
        if fwd is None:
            fwd = globals()[f"_{name}_fwd"]
            if name in ("celu", "elu") and not args:
                args = (1.0,)
            if name == "softplus" and not args:
                args = (1.0, 20.0)
        b, v, nbits = _resolve_lut(name, bits, borders, values)
        spec = ActivationSpec(name=name, bits=nbits, fwd=fwd,
                              codes=compare_codes, args=args,
                              n_borders=int(b.shape[0]),
                              fwd_kernel=_gelu_kfwd if name == "gelu"
                              else None)
        return spec, b, v
    # (fwd, predicate, default args, level below, level above)
    builders = {
        "relu": (_relu_fwd, _positive_pred, (), 0.0, 1.0),
        "relu6": (_relu6_fwd, _relu6_pred, (), 0.0, 1.0),
        "hardtanh": (_hardtanh_fwd, _hardtanh_pred, (-1.0, 1.0), 0.0, 1.0),
        "leaky_relu": (_leaky_relu_fwd, _positive_pred, (0.01,), None, 1.0),
        "hardsigmoid": (_hardsigmoid_fwd, _hardsigmoid_pred, (), 0.0,
                        1.0 / 6.0),
        "hardshrink": (_hardshrink_fwd, _hardshrink_pred, (0.5,), 0.0, 1.0),
        "softshrink": (_softshrink_fwd, _hardshrink_pred, (0.5,), 0.0, 1.0),
        "threshold": (_threshold_fwd, _threshold_pred, (0.0, 0.0), 0.0, 1.0),
    }
    if name not in builders:
        raise ValueError(f"unknown activation {name!r}")
    fwd_fn, pred, default_args, lo, hi = builders[name]
    args = args or default_args
    if lo is None:  # leaky_relu: the low level is the negative slope
        lo = args[0]
    spec = ActivationSpec(name=name, bits=1, fwd=fwd_fn, codes=pred,
                          args=args, n_borders=0)
    levels = jnp.array([lo, hi], dtype=jnp.float32)
    return spec, _empty_borders(), levels


def _celu_fwd(x, args):
    (alpha,) = args
    return jax.nn.celu(x, alpha)


def celu(x: jax.Array, alpha: float = 1.0, *, bits: Optional[int] = None,
         borders=None, values=None) -> jax.Array:
    return _continuous_call("celu", _celu_fwd, x, (float(alpha),), bits,
                            borders, values)


def _elu_fwd(x, args):
    (alpha,) = args
    return jax.nn.elu(x, alpha)


def elu(x: jax.Array, alpha: float = 1.0, *, bits: Optional[int] = None,
        borders=None, values=None) -> jax.Array:
    return _continuous_call("elu", _elu_fwd, x, (float(alpha),), bits,
                            borders, values)


def _gelu_fwd(x, args):
    # Exact (erf-based) GELU, matching the reference kernel x * normcdf(x)
    # (cuda/codec.cu:541).
    return _JAX_GELU(x, approximate=False)


def gelu(x: jax.Array, *, bits: Optional[int] = None, borders=None,
         values=None) -> jax.Array:
    return _continuous_call("gelu", _gelu_fwd, x, (), bits, borders, values)


def _hardswish_fwd(x, args):
    return jax.nn.hard_swish(x)


def hardswish(x: jax.Array, *, bits: Optional[int] = None, borders=None,
              values=None) -> jax.Array:
    return _continuous_call("hardswish", _hardswish_fwd, x, (), bits, borders,
                            values)


def _logsigmoid_fwd(x, args):
    return jax.nn.log_sigmoid(x)


def logsigmoid(x: jax.Array, *, bits: Optional[int] = None, borders=None,
               values=None) -> jax.Array:
    return _continuous_call("logsigmoid", _logsigmoid_fwd, x, (), bits,
                            borders, values)


def _mish_fwd(x, args):
    return x * jnp.tanh(jax.nn.softplus(x))


def mish(x: jax.Array, *, bits: Optional[int] = None, borders=None,
         values=None) -> jax.Array:
    return _continuous_call("mish", _mish_fwd, x, (), bits, borders, values)


def _selu_fwd(x, args):
    return jax.nn.selu(x)


def selu(x: jax.Array, *, bits: Optional[int] = None, borders=None,
         values=None) -> jax.Array:
    return _continuous_call("selu", _selu_fwd, x, (), bits, borders, values)


def _sigmoid_fwd(x, args):
    return _JAX_SIGMOID(x)


def sigmoid(x: jax.Array, *, bits: Optional[int] = None, borders=None,
            values=None) -> jax.Array:
    return _continuous_call("sigmoid", _sigmoid_fwd, x, (), bits, borders,
                            values)


def _silu_fwd(x, args):
    return _JAX_SILU(x)


def silu(x: jax.Array, *, bits: Optional[int] = None, borders=None,
         values=None) -> jax.Array:
    return _continuous_call("silu", _silu_fwd, x, (), bits, borders, values)


def _softplus_fwd(x, args):
    beta, thresh = args
    scaled = x * beta
    return jnp.where(scaled > thresh, x, jax.nn.softplus(scaled) / beta)


def softplus(x: jax.Array, beta: float = 1.0, threshold: float = 20.0, *,
             bits: Optional[int] = None, borders=None,
             values=None) -> jax.Array:
    return _continuous_call("softplus", _softplus_fwd, x,
                            (float(beta), float(threshold)), bits, borders,
                            values)


def _softsign_fwd(x, args):
    return jax.nn.soft_sign(x)


def softsign(x: jax.Array, *, bits: Optional[int] = None, borders=None,
             values=None) -> jax.Array:
    return _continuous_call("softsign", _softsign_fwd, x, (), bits, borders,
                            values)


def _tanh_fwd(x, args):
    return jnp.tanh(x)


def tanh(x: jax.Array, *, bits: Optional[int] = None, borders=None,
         values=None) -> jax.Array:
    return _continuous_call("tanh", _tanh_fwd, x, (), bits, borders, values)


def _tanhshrink_fwd(x, args):
    return x - jnp.tanh(x)


def tanhshrink(x: jax.Array, *, bits: Optional[int] = None, borders=None,
               values=None) -> jax.Array:
    return _continuous_call("tanhshrink", _tanhshrink_fwd, x, (), bits,
                            borders, values)
