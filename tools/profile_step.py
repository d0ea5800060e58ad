"""Where the RoBERTa training step spends device time, by named scope.

Traces a few compiled training steps with ``jax.profiler``, reads the
device plane of the trace (``jax.profiler.ProfileData``), and attributes
each kernel's device time to the model's named scopes (``embeddings``,
``qkv_proj``, ``attention``, ``out_proj``, ``ffn``, ``head``; the rest —
optimizer, loss, layer norms and residual adds — is ``other``).  A kernel's
scope comes from the ``op_name`` metadata of its HLO instruction in the
compiled module.

    python tools/profile_step.py --variant fewbit --dtype f32

Prints one JSON object: device busy time per step, the idle share of the
traced window, and per-scope device time and share of the busy time.  The
card's name and power limit and the matmul precision are in the output.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SCOPES = ("embeddings", "qkv_proj", "attention", "out_proj", "ffn", "head")
VARIANTS = {
    "vanilla": {},
    "fewbit": dict(gelu_bits=3, proj_dim_ratio=0.2, sketch="countsketch"),
}


def build(variant, dtype, batch_size, seq):
    from fewbit_tpu.models import (RobertaConfig,
                                   RobertaForSequenceClassification)
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_train_step, synthetic_glue)

    cfg = RobertaConfig(dtype=dtype, **VARIANTS[variant])
    model = RobertaForSequenceClassification(cfg)
    batch = {k: jnp.asarray(v) for k, v in next(synthetic_glue(
        batch_size, seq_len=seq, vocab_size=cfg.vocab_size)).items()}
    state = create_train_state(
        model, TrainConfig(total_steps=100, learning_rate=1e-5), batch)
    compiled = jax.jit(make_train_step(model), donate_argnums=(0,)).lower(
        state, batch, jax.random.key(0)).compile()
    return state, batch, compiled


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> named scope, from ``op_name`` metadata."""
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                     r"op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = scope_of(m.group(2))
    return out


def scope_of(op_name: str) -> str:
    parts = re.split(r"[/()]", op_name)
    for scope in SCOPES:
        if scope in parts:
            return scope
    return "other"


def _stats(event) -> dict:
    try:
        return {k: v for k, v in event.stats}
    except Exception:  # noqa: BLE001 — stats layout differs by version
        return {}


def reduce_trace(path: str, scopes: dict, n_steps: int) -> dict:
    """Device time per scope from the xplane file at ``path``."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    per_scope = defaultdict(float)
    per_kernel = defaultdict(float)
    other = defaultdict(float)
    intervals = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # Kernel launches live on the stream lines; the "XLA Ops" and
            # module lines repeat them at a coarser grain.
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                st = _stats(e)
                # Inside a command buffer (CUDA graph) the event's hlo_op is
                # the buffer; its name is still the kernel's instruction.
                op = str(st.get("hlo_op", ""))
                if op in ("", "command_buffer"):
                    op = e.name
                scope = scopes.get(op) or scope_of(str(st.get("tf_op", "")))
                per_scope[scope] += e.duration_ns
                per_kernel[op] += e.duration_ns
                if scope == "other":
                    other[op] += e.duration_ns
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    intervals.sort()
    busy, end = 0.0, None
    for s, t in intervals:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    def top(d, n=15):
        return {k: v / 1e3 / n_steps
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]}

    return {
        "busy_us_per_step": busy / 1e3 / n_steps,
        "idle_share": 1.0 - busy / window if window else None,
        "scope_us_per_step": {k: v / 1e3 / n_steps
                              for k, v in sorted(per_scope.items())},
        "scope_share": {k: v / sum(per_scope.values())
                        for k, v in sorted(per_scope.items())},
        "top_kernels_us_per_step": top(per_kernel),
        "top_other_kernels_us_per_step": top(other),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="fewbit", choices=sorted(VARIANTS))
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args()

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[args.dtype]
    state, batch, compiled = build(args.variant, dtype, args.batch,
                                   args.seq)
    scopes = op_scopes(compiled.as_text())
    for i in range(2):  # warm up
        state, _ = compiled(state, batch, jax.random.key(i))
    jax.block_until_ready(state)
    trace_dir = tempfile.mkdtemp(prefix="trace_")
    with jax.profiler.trace(trace_dir):
        for i in range(args.steps):
            state, _ = compiled(state, batch, jax.random.key(i))
        jax.block_until_ready(state)
    paths = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir)
             for f in fs if f.endswith(".xplane.pb")]
    out = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "variant": args.variant, "dtype": args.dtype,
           "batch": args.batch, "seq": args.seq,
           "matmul_precision": str(jax.config.jax_default_matmul_precision
                                   or "default (TF32 for f32 on an H100)"),
           **reduce_trace(paths[0], scopes, args.steps)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
