"""Shared sketch-RNG plumbing for the sketched modules.

The sketched weight-gradient estimators are unbiased only over fresh random
signs; a constant key makes every training step reuse the SAME sketch, so
the gradient noise never averages out.  The reference hides the equivalent
hazard inside an optional ``generator`` argument
(``/root/reference/fewbit/modules/linear.py:58-76``); here the fallback is
kept (inference without RNGs must still work — the sketch only affects
gradients) but it warns loudly.
"""

from __future__ import annotations

import jax

from fewbit_tpu.functional.linear import fallback_sketch_key

__all__ = ("sketch_key",)


def sketch_key(module) -> jax.Array:
    """Resolve the sketch PRNG key for a linen module: the ``'sketch'``
    collection when provided, the ``'params'`` key under ``init`` (gradients
    are never taken during init), else the constant-key fallback of
    :func:`fewbit_tpu.functional.linear.fallback_sketch_key`."""
    if module.has_rng("sketch"):
        return module.make_rng("sketch")
    if module.has_rng("params"):
        return module.make_rng("params")
    return fallback_sketch_key(type(module).__name__, stacklevel=4)
