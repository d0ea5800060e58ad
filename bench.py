"""Headline benchmark: RoBERTa-base training-step memory and time, vanilla
against few-bit (3-bit GELU + RandomizedLinear at a 20% countsketch).

The reference's README headline is this setting at bs=128 on MRPC, which it
reports as a 32.7% peak-memory saving (11.30 -> 7.60 GiB,
``/root/reference/README.md:16-27``).

Memory: XLA's compiled ``memory_analysis().temp_size_in_bytes`` — the
device scratch of one step, i.e. activations/residuals between forward and
backward plus temporaries, the same "training memory minus params" delta the
reference measures via ``max_memory_allocated - memory_allocated``
(``benchmark/benchmark.py:165-188``).

Step time: interleaved A/B.  Each variant's compiled step runs in blocks of
``LOOP_ITERS`` steps, each block ended by ``block_until_ready``; vanilla and
few-bit blocks alternate within one process, so drift of the card's clock
cancels out of the per-pair ratios.  Reported: median per-step time of each
side, and the median and min..max of the per-pair overhead.

Prints exactly ONE JSON line on stdout, naming the card, its power limit
and the matmul precision:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
vs_baseline = our_saving_pct / 32.7 (reference headline; >1 beats it).
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

SEQ = 128
REF_SAVING_PCT = 32.7
LOOP_ITERS = 20
AB_PAIRS = 4
CELLS = (("f32", 64), ("bf16", 64), ("bf16", 128))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build(gelu_bits, proj_dim_ratio, batch_size, dtype):
    from fewbit_tpu.models import (RobertaConfig,
                                   RobertaForSequenceClassification)
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_train_step, synthetic_glue)

    cfg = RobertaConfig(gelu_bits=gelu_bits, proj_dim_ratio=proj_dim_ratio,
                        sketch="countsketch", dtype=dtype)
    model = RobertaForSequenceClassification(cfg)
    batch = {k: jnp.asarray(v) for k, v in next(synthetic_glue(
        batch_size, seq_len=SEQ, vocab_size=cfg.vocab_size)).items()}
    state = create_train_state(
        model, TrainConfig(total_steps=100, learning_rate=1e-5), batch)
    compiled = jax.jit(make_train_step(model), donate_argnums=(0,)).lower(
        state, batch, jax.random.key(0)).compile()
    return state, batch, compiled


def run_block(step, state, batch, key):
    """``LOOP_ITERS`` steps; seconds per step, ended by block_until_ready."""
    t0 = time.perf_counter()
    for i in range(LOOP_ITERS):
        state, _ = step(state, batch, jax.random.fold_in(key, i))
    jax.block_until_ready(state)
    return state, (time.perf_counter() - t0) / LOOP_ITERS


def measure_interleaved(step_v, step_f, sv, sf, bv, bf, pairs=AB_PAIRS):
    """Alternate vanilla/few-bit blocks A/B/A/B in one process."""
    key = jax.random.key(1)
    sv, _ = run_block(step_v, sv, bv, key)  # warm-up
    sf, _ = run_block(step_f, sf, bf, key)
    t_v, t_f = [], []
    for _ in range(pairs):
        sv, t = run_block(step_v, sv, bv, key)
        t_v.append(t)
        sf, t = run_block(step_f, sf, bf, key)
        t_f.append(t)
    return t_v, t_f


def ab_stats(t_v, t_f):
    """Median per-step times and the per-pair overhead distribution."""
    deltas = [100.0 * (f / v - 1.0) for v, f in zip(t_v, t_f)]
    return {
        "vanilla_step_ms": float(np.median(t_v)) * 1e3,
        "fewbit_step_ms": float(np.median(t_f)) * 1e3,
        "overhead_pct_median": float(np.median(deltas)),
        "overhead_pct_min": min(deltas),
        "overhead_pct_max": max(deltas),
        "pairs": len(deltas),
    }


def timed_pair(dtype_name, batch):
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    log(f"[{dtype_name} bs={batch}] compiling vanilla and few-bit steps")
    sv, bv, step_v = build(None, None, batch, dtype)
    sf, bf, step_f = build(3, 0.2, batch, dtype)
    mem_v = int(step_v.memory_analysis().temp_size_in_bytes)
    mem_f = int(step_f.memory_analysis().temp_size_in_bytes)
    saving = 100.0 * (1.0 - mem_f / mem_v)
    result = {"batch": batch, "seq": SEQ, "dtype": dtype_name,
              "vanilla_temp_bytes": mem_v, "fewbit_temp_bytes": mem_f,
              "mem_saving_pct": saving,
              **ab_stats(*measure_interleaved(step_v, step_f, sv, sf, bv,
                                              bf))}
    log(f"[{dtype_name} bs={batch}]", json.dumps(result))
    return result


def main():
    from fewbit_tpu.util import setup_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    setup_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    rows = [timed_pair(dt, bs) for dt, bs in CELLS]
    saving_pct = rows[0]["mem_saving_pct"]
    print(json.dumps({
        "metric": "roberta_base_train_step_mem_saving",
        "value": saving_pct,
        "unit": "percent",
        "vs_baseline": saving_pct / REF_SAVING_PCT,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "matmul_precision": (jax.config.jax_default_matmul_precision
                             or "default (TF32 for f32)"),
        "detail": rows,
    }))


if __name__ == "__main__":
    main()
