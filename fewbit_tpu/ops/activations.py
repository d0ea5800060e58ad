"""Few-bit activation engine: one generic ``custom_vjp`` for every function.

Semantics (matching the reference's Python fallback, which is the semantic
spec of the whole engine — ``/root/reference/fewbit/functional/activations.py:89-129``):

* forward returns the *exact* activation value ``f(x)``;
* instead of saving ``x`` for the backward pass, the forward quantises each
  element to a ``bits``-wide interval code and saves only the bitpacked code
  tensor (see :mod:`fewbit_tpu.ops.bitpack`);
* backward multiplies the incoming cotangent by the stepwise-approximated
  derivative ``levels[code]``.

Where the reference needed ~800 lines of hand-written CUDA for 21 separate
ops (``cuda/codec.cu:229-670``, ``cuda/activation.cc``), a single spec-driven
``custom_vjp`` covers the whole surface here; the forward (activation +
quantise + pack) and backward (unpack + LUT + multiply) are the two entries
of :mod:`fewbit_tpu.ops.codec`.

The two families:

* **1-bit piecewise functions** (relu, relu6, hardtanh, hardsigmoid,
  leaky_relu, hardshrink, softshrink, threshold): the derivative is exactly
  two-valued, the code is a single predicate bit.  The reference's relu6
  forward bug (outputs 1.0 instead of 6.0 for x >= 6,
  ``cuda/codec.cu:437``) is *not* reproduced.
* **multi-bit continuous functions** (gelu, silu, tanh, ...): codes come from
  comparing against the interior borders of an offline-optimised stepwise
  approximation of f' (:mod:`fewbit_tpu.approx`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from fewbit_tpu.ops import codec
from fewbit_tpu.ops.codec import apply_lut

__all__ = (
    "ActivationSpec",
    "fewbit_activation",
    "apply_lut",
    "quantize_codes",
)


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    """Static description of one few-bit activation.

    ``args`` are the function's scalar hyper-parameters (e.g. leaky_relu's
    negative slope) — plain Python floats so the spec stays hashable for
    ``custom_vjp``'s nondiff argument.

    ``fwd(x, args)`` computes the exact activation.  ``codes(x, borders,
    args)`` returns the per-element interval code as uint32; for the 1-bit
    family ``borders`` is an empty placeholder and the predicate lives in the
    spec, for the continuous family codes count exceeded borders.
    ``n_borders`` is the static length of the ``borders`` argument (0 for the
    predicate family; ``len(levels) - 1`` otherwise).
    """

    name: str
    bits: int
    fwd: Callable[[jax.Array, tuple], jax.Array]
    codes: Callable[[jax.Array, jax.Array, tuple], jax.Array]
    args: tuple = ()
    n_borders: int = 0
    # Optional forward for the Triton codec kernel, for functions whose
    # plain form uses a primitive that route does not lower (lax.erfc).
    fwd_kernel: Callable[[jax.Array, tuple], jax.Array] | None = None

    @property
    def num_levels(self) -> int:
        return 1 << self.bits


def compare_codes(x: jax.Array, borders: jax.Array, args: tuple) -> jax.Array:
    """Interval code = number of interior borders strictly below x.

    Equivalent to ``searchsorted(borders, x, side='left')`` but expressed as
    an unrolled compare-accumulate, so it stays one fused elementwise pass
    with no data-dependent branch (the reference does a per-thread
    ``BinarySearch``, ``cuda/codec.cu:118-140``).
    """
    xf = x.astype(jnp.float32)
    acc = jnp.zeros(x.shape, dtype=jnp.uint32)
    for k in range(borders.shape[0]):
        acc = acc + (xf > borders[k]).astype(jnp.uint32)
    return acc


def quantize_codes(x: jax.Array, borders: jax.Array) -> jax.Array:
    """Public helper: interval codes of ``x`` w.r.t. interior ``borders``."""
    return compare_codes(x, borders, ())


# ---------------------------------------------------------------------------
# The generic custom-VJP core.
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def fewbit_activation(spec: ActivationSpec, x: jax.Array,
                      borders: jax.Array, levels: jax.Array) -> jax.Array:
    """Exact forward of ``spec`` with a few-bit backward pass.

    ``borders``: float32 interior borders, shape ``(spec.n_borders,)`` (empty
    for the 1-bit predicate family).  ``levels``: float32 stepwise derivative
    values (``levels[k]`` multiplies cotangents whose input fell in interval
    ``k``).
    """
    return spec.fwd(x, spec.args)


def _fewbit_fwd(spec, x, borders, levels):
    y, packed = codec.forward(spec, x, borders)
    return y, (packed, levels)


def _fewbit_bwd(spec, residual, g):
    packed, levels = residual
    dx = codec.backward(spec, packed, levels, g)
    return (dx, jnp.zeros((spec.n_borders,), dtype=jnp.float32),
            jnp.zeros_like(levels))


fewbit_activation.defvjp(_fewbit_fwd, _fewbit_bwd)
