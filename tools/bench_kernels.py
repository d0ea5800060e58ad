"""Codec micro-benchmark on the GPU: the Triton forward kernel against the
plain path XLA compiles, and the plain backward, at the RoBERTa-base FFN
activation (bs=64, seq=128).

    python tools/bench_kernels.py            # gelu 1-4 bits, f32 and bf16
    python tools/bench_kernels.py --sweep    # + kernel block geometry

Each row times one direction with ``block_until_ready`` (best of 3 rounds
of 20 calls) and reports the bytes the pass must move over the time.  The
plain exact GELU forward is timed too: the reference library's few-bit
forward costs 2.18x it.  Prints one JSON object per line; the first line
names the card and its power limit.
"""

import argparse
import functools
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import (CODEC_SHAPE as SHAPE, card_name_and_power,  # noqa: E402
                        codec_bytes, time_calls)
from fewbit_tpu.functional.activations import resolve_activation  # noqa: E402
from fewbit_tpu.ops import codec  # noqa: E402


def best_ms(fn, *args):
    return time_calls(fn, *args) * 1e3


def rows(dtype, bits_list, geometry=None):
    n = SHAPE[0] * SHAPE[1]
    x = (2.0 * jax.random.normal(jax.random.key(0), SHAPE)).astype(dtype)
    g = jax.random.normal(jax.random.key(1), SHAPE).astype(dtype)
    if geometry:
        codec.BLOCK_WORDS, codec.NUM_WARPS = geometry
    gelu = jax.jit(lambda t: jax.nn.gelu(t, approximate=False))
    base = best_ms(gelu, x)
    for bits in bits_list:
        spec, borders, levels = resolve_activation("gelu", bits=bits)
        kf = jax.jit(functools.partial(codec.triton_forward, spec))
        pf = jax.jit(functools.partial(codec.plain_forward, spec))
        pb = jax.jit(functools.partial(codec.plain_backward, spec))
        _, packed = pf(x, borders)
        moved = codec_bytes(n, jnp.dtype(dtype).itemsize, bits)
        row = {"dtype": jnp.dtype(dtype).name, "bits": bits,
               "geometry": [codec.BLOCK_WORDS, codec.NUM_WARPS],
               "plain_gelu_fwd_ms": base}
        for tag, fn, args in (("fwd_kernel", kf, (x, borders)),
                              ("fwd_plain", pf, (x, borders)),
                              ("bwd_plain", pb, (packed, levels, g))):
            ms = best_ms(fn, *args)
            row[tag + "_ms"] = ms
            row[tag + "_GBps"] = moved / ms / 1e6
        row["fwd_kernel_vs_plain_gelu"] = row["fwd_kernel_ms"] / base
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep (BLOCK_WORDS, NUM_WARPS) at 3 bits")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("no GPU")
    print(json.dumps({"card": card_name_and_power(),
                      "device_kind": dev.device_kind}), flush=True)
    for dtype in (jnp.float32, jnp.bfloat16):
        rows(dtype, (1, 2, 3, 4))
    if args.sweep:
        for geometry in ((128, 4), (256, 4), (512, 4), (512, 8), (1024, 4),
                         (1024, 8), (2048, 8)):
            for dtype in (jnp.float32, jnp.bfloat16):
                rows(dtype, (3,), geometry)


if __name__ == "__main__":
    main()
