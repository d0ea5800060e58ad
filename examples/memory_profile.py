"""Operator-level memory/latency profile (reference parity:
notebooks/few-bit-backward/memory-usage-operation-only.py).

Reports, per activation function and bit width: residual bytes per element
(exact, from the VJP closure) and, with ``--time``, forward timings on the
current backend.

    python examples/memory_profile.py [--time]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--time", action="store_true",
                        help="also time fwd/bwd on the current backend")
    parser.add_argument("--elems", type=int, default=1 << 24)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import fewbit_tpu.functional as F
    from fewbit_tpu.util import estimate_memory_usage

    n = args.elems
    shape = (n // 1024, 1024)
    x = jnp.zeros(shape, jnp.float32)

    print(f"{'function':<12} {'bits':>4} {'residual B/elem':>16} "
          f"{'exact B/elem':>13}")
    for name in ("relu", "hardtanh"):
        fn = getattr(F, name)
        saved = estimate_memory_usage(fn, x)
        exact = estimate_memory_usage(
            {"relu": jax.nn.relu,
             "hardtanh": lambda t: jnp.clip(t, -1, 1)}[name], x)
        print(f"{name:<12} {1:>4} {saved/n:>16.4f} {exact/n:>13.4f}")
    for name in ("gelu", "silu", "tanh"):
        fn = getattr(F, name)
        exact = estimate_memory_usage(
            {"gelu": lambda t: jax.nn.gelu(t, approximate=False),
             "silu": jax.nn.silu, "tanh": jnp.tanh}[name], x)
        for bits in (1, 2, 3, 4):
            saved = estimate_memory_usage(lambda t: fn(t, bits=bits), x)
            print(f"{name:<12} {bits:>4} {saved/n:>16.4f} {exact/n:>13.4f}")

    if args.time:
        x = jax.random.normal(jax.random.key(0), shape)

        def bench(f, iters=20):
            y = f(x)
            jax.block_until_ready(y)
            t0 = time.perf_counter()
            loop = jax.jit(lambda t: jax.lax.fori_loop(
                0, iters, lambda i, v: f(v), t))
            jax.block_until_ready(loop(x))
            t0 = time.perf_counter()
            jax.block_until_ready(loop(x))
            return (time.perf_counter() - t0) / iters * 1e3

        print("\ntimings (ms, fori-amortised):")
        print("vanilla gelu fwd:", f"{bench(jax.jit(lambda t: jax.nn.gelu(t, approximate=False))):.3f}")
        print("fewbit3 gelu fwd:", f"{bench(jax.jit(lambda t: F.gelu(t, bits=3))):.3f}")


if __name__ == "__main__":
    main()
