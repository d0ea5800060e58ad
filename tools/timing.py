"""The shared on-device timing protocol for micro-benchmarks.

The fori_loop trip count is passed as a TRACED scalar: with a static bound
XLA unrolls the loop and fuses elementwise bodies across iterations (20
chained gelus collapse into one read-once kernel), faking a 20x bandwidth
win.  Each round ends with ``block_until_ready`` on the loop's result:
JAX returns before the device finishes, so a timing without it measures
the enqueue.

Reference: none — the reference times ops with
``torch.utils.benchmark.Timer``
(``notebooks/few-bit-backward/benchmark-quantisation.py:59-71``).
"""

import time

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ("timed_loop", "touch")


def timed_loop(body, carry, iters=50, rounds=3):
    """Best per-iteration time of ``iters`` fori_loop steps of ``body``
    (a ``(i, carry) -> carry`` function), one dispatch per round."""

    @jax.jit
    def run(c, n):
        return lax.fori_loop(0, n, body, c)

    n = jnp.int32(iters)
    out = jax.block_until_ready(run(carry, n))  # compile + warm
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(out, n))
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def touch(carry, val):
    """One-element update of the carry from ``val`` — a data dependence
    that defeats XLA's loop-invariant code motion at no measurable
    traffic."""
    patch = (val[:1, :1] * 1e-6).astype(carry.dtype)
    return lax.dynamic_update_slice(carry, patch, (0, 0))
