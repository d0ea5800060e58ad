#!/usr/bin/env python3
"""GPU smoke check: the few-bit RoBERTa-base training step on the card.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the dp x tp path only

Phases on one card, each in a child process of its own, one after another
(a JAX process reserves most of the card, and each variant's
``peak_bytes_in_use`` is its own):

1. device — JAX's platform must be ``gpu``; versions, card name and power
   limit;
2. codec — the few-bit codec (:mod:`fewbit_tpu.ops.codec`) at the
   RoBERTa-base FFN activation, (8192, 3072), f32 and bf16: the Triton
   forward kernel compiled for the card against the plain path on the same
   card, bit for bit, the backward against a numpy reference, both timed;
3. model — RoBERTa-base at full width, vanilla and few-bit, f32 and bf16:
   compiled memory, peak memory, five optimizer steps with finite losses,
   step time, and for few-bit the train step with and without the forward
   kernel, timed in interleaved rounds;
4. reference — few-bit logits against vanilla logits on the same
   parameters, and few-bit gradients on the card against the CPU.

Any failure exits non-zero before the result line.  The last line of
standard output is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": N}}``.  Without a GPU the script exits non-zero and prints no
result line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# RoBERTa-base fine-tuning on MRPC-shaped batches.
BATCH, SEQ = 64, 128
CODEC_SHAPE = (BATCH * SEQ, 3072)  # the FFN activation of that batch
FEWBIT = dict(gelu_bits=3, proj_dim_ratio=0.2, sketch="countsketch")
VARIANTS = ("vanilla-f32", "fewbit-f32", "vanilla-bf16", "fewbit-bf16")
STEPS = 5
AB_ROUNDS, AB_STEPS = 5, 10

# Tolerances, each with its reason.
TOL = {
    "y_ulp_f32": (2, "Triton's exp/division may round differently from "
                     "XLA's in the last bits of the float32 erfc"),
    "y_ulp_bf16": (1, "one bfloat16 rounding of a float32 value that may "
                      "differ in its last bits"),
    "logits_f32": (1e-5, "the few-bit forward is exact; only the order of "
                         "sums in the matrix products differs"),
    "logits_bf16": (2e-2, "the few-bit FFN keeps its pre-activation and "
                          "output in float32 where vanilla rounds them to "
                          "bfloat16; the bound is this or twice vanilla "
                          "bfloat16's own distance from float32, whichever "
                          "is larger"),
    "grad_rel_l2": (1e-3, "sums run in another order on the card, and a "
                          "pre-activation within rounding of a border can "
                          "flip its code"),
    "four_rtol": (1e-4, "dp x tp sums the same products in another order; "
                        "parameters compare as one vector, since a key bias "
                        "has zero true gradient and its Adam update is "
                        "rounding noise"),
}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Comparison helpers (pure numpy).
# ---------------------------------------------------------------------------


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between two float
    arrays of one dtype (float32 or bfloat16)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        raise ValueError(f"{a.dtype}{a.shape} vs {b.dtype}{b.shape}")
    bits = {4: np.int32, 2: np.int16}[a.dtype.itemsize]
    ia = a.view(bits).astype(np.int64)
    ib = b.view(bits).astype(np.int64)
    # Map sign-magnitude to a monotone integer line.
    top = np.int64(1) << (8 * a.dtype.itemsize - 1)
    ia = np.where(ia < 0, -(ia + top), ia)
    ib = np.where(ib < 0, -(ib + top), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def rel_l2(a, b) -> float:
    """``||a - b|| / ||b||`` in float64 (0 when both are zero)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    num = np.linalg.norm(a - b)
    return float(num / den) if den else float(num)


def codec_bytes(n: int, itemsize: int, bits: int) -> int:
    """Bytes one codec pass moves: read the input, write the output, write
    (forward) or read (backward) the packed words."""
    return 2 * n * itemsize + bits * 4 * (-(-n // 32))


def time_calls(fn, *args, iters: int = 20, rounds: int = 3) -> float:
    """Seconds per call of a jitted ``fn``: the best of ``rounds`` rounds of
    ``iters`` calls, each round ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


# ---------------------------------------------------------------------------
# Phase 1: device.
# ---------------------------------------------------------------------------


def phase_device(verbose: bool = True) -> dict:
    import jax
    import jaxlib

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    if not verbose:
        return {}
    try:
        from importlib.metadata import version

        plugin = version("jax-cuda12-plugin")
    except Exception:  # noqa: BLE001 — name differs between builds
        plugin = "unknown"
    log(f"device: {dev.device_kind} x{len(jax.devices())}; jax "
        f"{jax.__version__}, jaxlib {jaxlib.__version__}, cuda plugin "
        f"{plugin}; matmul precision "
        f"{jax.config.jax_default_matmul_precision or 'default'} (f32 "
        f"products run in TF32 at the default) except where a phase says "
        f"'highest'")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_name_and_power() -> str:
    """``nvidia-smi`` in a child that does not use JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# Phase 2: codec.
# ---------------------------------------------------------------------------


def check_codec(name: str, bits, x, g, interpret: bool = False) -> dict:
    """The forward kernel against the plain path on one input (packed words
    bit for bit, ``y`` within the ulp tolerance), and the backward against
    numpy: ``levels[code] * g`` with the codes of ``x``, bit for bit."""
    import functools

    import jax
    import numpy as np

    from fewbit_tpu.functional.activations import resolve_activation
    from fewbit_tpu.ops import codec

    spec, borders, levels = resolve_activation(name, bits=bits)
    kf = jax.jit(functools.partial(codec.triton_forward, spec,
                                   interpret=interpret))
    pf = jax.jit(functools.partial(codec.plain_forward, spec))
    pb = jax.jit(functools.partial(codec.plain_backward, spec))
    y_k, packed_k = kf(x, borders)
    y_p, packed_p = pf(x, borders)
    dx = pb(packed_k, levels, g)
    codes = np.asarray(spec.codes(np.asarray(x), borders, spec.args))
    want = (np.asarray(levels)[codes] * np.asarray(g, np.float32)).astype(
        np.asarray(g).dtype)
    tol = TOL["y_ulp_f32" if x.dtype == np.float32 else "y_ulp_bf16"][0]
    out = {
        "packed_equal": bool(np.array_equal(np.asarray(packed_k),
                                            np.asarray(packed_p))),
        "dx_equal": bool(np.array_equal(np.asarray(dx), want)),
        "y_ulp": ulp_diff(y_k, y_p), "y_ulp_tol": tol,
    }
    out["ok"] = (out["packed_equal"] and out["dx_equal"]
                 and out["y_ulp"] <= tol)
    out["fns"] = (kf, pf, pb, borders, levels, packed_p)
    return out


def phase_codec(shape=CODEC_SHAPE, interpret: bool = False,
                timed: bool = True) -> list:
    import jax
    import jax.numpy as jnp

    rows = []
    n = shape[0] * shape[1]
    for dtype in (jnp.float32, jnp.bfloat16):
        kx, kg = jax.random.split(jax.random.key(0))
        x = (2.0 * jax.random.normal(kx, shape, jnp.float32)).astype(dtype)
        g = jax.random.normal(kg, shape, jnp.float32).astype(dtype)
        for name, bits in [("gelu", b) for b in (1, 2, 3, 4)] + [
                ("relu", None)]:
            res = check_codec(name, bits, x, g, interpret=interpret)
            kf, pf, pb, borders, levels, packed = res.pop("fns")
            nbits = bits or 1
            row = {"act": name, "bits": nbits,
                   "dtype": jnp.dtype(dtype).name, **res}
            if timed:
                moved = codec_bytes(n, jnp.dtype(dtype).itemsize, nbits)
                for tag, fn, args in (("fwd_kernel", kf, (x, borders)),
                                      ("fwd_plain", pf, (x, borders)),
                                      ("bwd_plain", pb, (packed, levels, g))):
                    t = time_calls(fn, *args)
                    row[tag + "_ms"] = t * 1e3
                    row[tag + "_GBps"] = moved / t / 1e9
            log("codec", json.dumps(row))
            if not res["ok"]:
                raise AssertionError(f"codec mismatch: {row}")
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: model steps.
# ---------------------------------------------------------------------------


def _config(variant: str, **overrides):
    import jax.numpy as jnp

    from fewbit_tpu.models import RobertaConfig

    kind, dt = variant.split("-")
    kw = dict(FEWBIT) if kind == "fewbit" else {}
    kw.update(overrides)
    return RobertaConfig(dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dt],
                         **kw)


def _batch(bs: int, seq: int, vocab: int):
    import jax.numpy as jnp

    from fewbit_tpu.train import synthetic_glue

    return {k: jnp.asarray(v)
            for k, v in next(synthetic_glue(bs, seq_len=seq,
                                            vocab_size=vocab)).items()}


def _compiled_step(model, state, batch):
    import jax

    from fewbit_tpu.train import make_train_step

    jitted = jax.jit(make_train_step(model), donate_argnums=(0,))
    return jitted.lower(state, batch, jax.random.key(0)).compile()


def _run_steps(step, state, batch, n: int):
    import jax

    losses = []
    for i in range(n):
        state, m = step(state, batch, jax.random.key(i))
        losses.append(m["loss"])
    return state, [float(l) for l in jax.device_get(losses)]


def _time_block(step, state, batch, n: int):
    import jax

    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, _ = _run_steps(step, state, batch, n)
    jax.block_until_ready(state)
    return state, (time.perf_counter() - t0) / n


def phase_model(variant: str, batch_size: int = BATCH, seq: int = SEQ,
                overrides: dict | None = None, ab: bool = True) -> dict:
    import jax
    import numpy as np

    from fewbit_tpu.models import RobertaForSequenceClassification
    from fewbit_tpu.ops import codec
    from fewbit_tpu.train import TrainConfig, create_train_state
    from fewbit_tpu.util import peak_memory_bytes

    cfg = _config(variant, **(overrides or {}))
    model = RobertaForSequenceClassification(cfg)
    batch = _batch(batch_size, seq, cfg.vocab_size)
    tcfg = TrainConfig(total_steps=100, learning_rate=1e-5)

    # Copies of one state share its static fields (apply_fn, tx), so every
    # copy matches the compiled step's input tree.
    state0 = create_train_state(model, tcfg, batch)

    def fresh():
        return jax.tree.map(lambda a: a.copy(), state0)

    t0 = time.perf_counter()
    step = _compiled_step(model, fresh(), batch)
    row = {"variant": variant, "batch": batch_size, "seq": seq,
           "compile_s": time.perf_counter() - t0,
           "temp_size_in_bytes":
               int(step.memory_analysis().temp_size_in_bytes)}
    state, losses = _run_steps(step, fresh(), batch, STEPS)
    row["losses"] = losses
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{variant}: non-finite loss {losses}")
    state, row["step_ms"] = _time_block(step, state, batch, AB_STEPS)
    row["step_ms"] *= 1e3
    row["peak_bytes_in_use"] = peak_memory_bytes(jax.devices()[0])
    log("model", json.dumps(row))
    del state
    if ab and variant.startswith("fewbit"):
        row["codec_ab"] = _codec_ab(model, fresh, batch, codec)
    return row


def _codec_ab(model, fresh, batch, codec) -> dict:
    """The few-bit step with the forward kernel against the plain codec,
    compiled separately and timed in interleaved rounds in this process."""
    import numpy as np

    configs = {"plain": False, "kernel_fwd": True}
    saved = codec._GPU_KERNEL
    steps, states = {}, {}
    try:
        for name, setting in configs.items():
            codec._GPU_KERNEL = setting
            steps[name] = _compiled_step(model, fresh(), batch)
            states[name], _ = _run_steps(steps[name], fresh(), batch, 1)
    finally:
        codec._GPU_KERNEL = saved
    times = {name: [] for name in configs}
    names = list(configs)
    for r in range(AB_ROUNDS):
        order = names[r % len(names):] + names[:r % len(names)]
        for name in order:
            states[name], t = _time_block(steps[name], states[name], batch,
                                          AB_STEPS)
            times[name].append(t * 1e3)
    out = {name: {"median_ms": float(np.median(ts)), "ms": ts}
           for name, ts in times.items()}
    ratios = [a / b for a, b in zip(times["kernel_fwd"], times["plain"])]
    out["kernel_fwd"]["vs_plain_median"] = float(np.median(ratios))
    log("codec_ab", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 4: against the plain reference.
# ---------------------------------------------------------------------------


def whole_ffn_params(params):
    """Vanilla parameters in the few-bit model's tree: the whole-FFN op
    keeps both FFN projections under ``ffn``."""
    import jax

    def convert(layer):
        layer = dict(layer)
        up, down = layer.pop("intermediate"), layer.pop("ffn_output")
        layer["ffn"] = {"up_kernel": up["kernel"], "up_bias": up["bias"],
                        "down_kernel": down["kernel"],
                        "down_bias": down["bias"]}
        return layer

    params = jax.tree.map(lambda a: a, params)
    roberta = dict(params["roberta"])
    roberta["layers"] = convert(roberta["layers"])
    return {**params, "roberta": roberta}


def phase_reference(batch_size: int = BATCH, seq: int = SEQ,
                    grad_batch: int = 4, overrides: dict | None = None,
                    devices=None) -> dict:
    import jax
    import numpy as np

    from fewbit_tpu.models import RobertaForSequenceClassification
    from fewbit_tpu.train.loop import classification_loss

    devices = devices or (jax.devices()[0], jax.devices("cpu")[0])
    off = dict(hidden_dropout=0.0, attention_dropout=0.0,
               **(overrides or {}))
    params = RobertaForSequenceClassification(
        _config("vanilla-f32", **off)).init(jax.random.key(0))
    fewbit_params = {"params": whole_ffn_params(params["params"])}
    rngs = {"sketch": jax.random.key(1)}
    out = {}

    def logits(variant, p, batch):
        model = RobertaForSequenceClassification(_config(variant, **off))
        return np.asarray(jax.jit(lambda p, b: model.apply(
            p, b["input_ids"], b["attention_mask"], rngs=rngs))(p, batch),
            np.float32)

    def dist(a, b):
        # Relative to the largest logit: single logits pass through 0.
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    with jax.default_matmul_precision("highest"):
        batch = _batch(batch_size, seq, off.get("vocab_size", 50265))
        exact = logits("vanilla-f32", params, batch)
        for dt in ("f32", "bf16"):
            lv = logits(f"vanilla-{dt}", params, batch)
            lf = logits(f"fewbit-{dt}", fewbit_params, batch)
            err = dist(lf, lv)
            tol, why = TOL[f"logits_{dt}"]
            if dt == "bf16":
                noise = dist(lv, exact)
                out["vanilla_bf16_vs_f32"] = noise
                tol = max(tol, 2 * noise)
                why = f"{why}; vanilla bf16 vs f32: {noise:.3e}"
            log(f"reference: {dt} few-bit logits vs vanilla, same "
                f"parameters: max |diff| / max |logit| {err:.3e} "
                f"(tol {tol:.3e}: {why})")
            if not err <= tol:
                raise AssertionError(f"{dt} logits differ: {err} > {tol}")
            out[f"logits_{dt}_max_rel"] = err

        # Gradients of the few-bit f32 model: the card against the CPU.
        fewbit = RobertaForSequenceClassification(_config("fewbit-f32", **off))
        small = _batch(grad_batch, seq, fewbit.cfg.vocab_size)

        def loss(p, b, key):
            logits = fewbit.apply(p, b["input_ids"], b["attention_mask"],
                                  deterministic=False, rngs={"sketch": key})
            return classification_loss(logits, b["labels"])

        grads = []
        for dev in devices:
            args = jax.device_put((fewbit_params, small, jax.random.key(2)),
                                  dev)
            grads.append(jax.device_get(jax.jit(jax.grad(loss))(*args)))
    tol, why = TOL["grad_rel_l2"]
    rels = {jax.tree_util.keystr(path): rel_l2(a, b) for (path, a), b in zip(
        jax.tree_util.tree_leaves_with_path(grads[0]),
        jax.tree.leaves(grads[1]))}
    # Softmax is blind to a per-query constant, so the key bias has zero
    # true gradient: on both sides it is rounding noise, compared as such.
    noise = {k: v for k, v in rels.items() if "['key']['bias']" in k}
    checked = {k: v for k, v in rels.items() if k not in noise}
    name = max(checked, key=checked.get)
    worst = checked[name]
    key_bias = [np.linalg.norm(np.asarray(g["params"]["roberta"]["layers"][
        "attention"]["key"]["bias"])) for g in grads]
    total = np.sqrt(sum(np.sum(np.square(np.asarray(l, np.float64)))
                        for l in jax.tree.leaves(grads[1])))
    log(f"reference: few-bit f32 gradients on {devices[0].platform} vs "
        f"{devices[1].platform}: worst per-parameter relative L2 "
        f"{worst:.3e} at {name} (tol {tol}: {why}); key bias excluded "
        f"(zero true gradient): |g| {key_bias[0]:.3e} / {key_bias[1]:.3e} "
        f"of a total {total:.3e}")
    if not worst <= tol:
        raise AssertionError(f"gradient mismatch {worst} > {tol} at {name}")
    out["grad_worst_rel_l2"] = worst
    return out


# ---------------------------------------------------------------------------
# --four: dp x tp over four cards.
# ---------------------------------------------------------------------------


def phase_four(batch_size: int = BATCH, seq: int = SEQ,
               overrides: dict | None = None, devices=None) -> dict:
    import jax
    import numpy as np

    from fewbit_tpu.models import RobertaForSequenceClassification
    from fewbit_tpu.parallel import (assert_collective_compute_overlap,
                                     dp_tp_train_step, init_dp_tp_state,
                                     make_dp_tp_mesh, shard_batch)
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_train_step)

    devices = devices or jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 devices, found {len(devices)}")
    mesh = make_dp_tp_mesh(2, 2, devices=devices[:4])
    base = dict(hidden_dropout=0.0, attention_dropout=0.0, gelu_bits=3,
                **(overrides or {}))
    tcfg = TrainConfig(total_steps=100, learning_rate=1e-5,
                       warmup_ratio=0.0)
    batch = _batch(batch_size, seq, _config("vanilla-f32", **base).vocab_size)
    out = {}
    with jax.default_matmul_precision("highest"):
        model = RobertaForSequenceClassification(
            _config("vanilla-f32", tp_axis="tp", tp_size=2, **base))
        state, specs = init_dp_tp_state(model, tcfg, batch, mesh)
        params0 = jax.device_get(state.params)
        step = dp_tp_train_step(make_train_step(model, dp_axis="dp"), mesh,
                                specs)
        sharded = shard_batch(batch, mesh)
        compiled = step.lower(state, sharded, jax.random.key(0)).compile()
        hlo = compiled.as_text()
        counts = {kind: len(re.findall(rf" {kind}(?:-start)?\(", hlo))
                  for kind in ("all-reduce", "all-gather", "reduce-scatter",
                               "collective-permute", "all-to-all")}
        out["collectives"] = counts
        log("four: collectives in the compiled dp x tp step:",
            json.dumps(counts))
        overlap = assert_collective_compute_overlap(hlo)
        out["overlap"] = overlap
        log("four: collective/compute overlap:", json.dumps(overlap))
        tp_losses = []
        for i in range(3):
            state, m = compiled(state, sharded, jax.random.key(i))
            tp_losses.append(float(m["loss"]))
        tp_params = jax.device_get(state.params)

        # The same two steps on one card with the gathered parameters.
        single = RobertaForSequenceClassification(
            _config("vanilla-f32", **base))
        ref_state = create_train_state(single, tcfg, batch)
        ref_state = ref_state.replace(
            params=single_card_params(params0),
            opt_state=ref_state.tx.init(single_card_params(params0)))
        ref_state = jax.device_put(ref_state, devices[0])
        ref_step = jax.jit(make_train_step(single))
        ref_losses = []
        for i in range(3):
            ref_state, m = ref_step(ref_state, jax.device_put(
                batch, devices[0]), jax.random.key(i))
            ref_losses.append(float(m["loss"]))
        tol, why = TOL["four_rtol"]
        np.testing.assert_allclose(tp_losses, ref_losses, rtol=tol)
        worst = rel_l2(flat(single_card_params(tp_params)),
                       flat(jax.device_get(ref_state.params)))
        log(f"four: dp2 x tp2 losses {tp_losses} vs one card {ref_losses}; "
            f"parameters after 3 steps, relative L2 {worst:.3e} "
            f"(rtol {tol}: {why})")
        if not worst <= tol:
            raise AssertionError(f"dp x tp parameters differ: {worst}")
        out.update(tp_losses=tp_losses, ref_losses=ref_losses,
                   param_worst_rel_l2=worst)

    sk = RobertaForSequenceClassification(
        _config("fewbit-f32", tp_axis="tp", tp_size=2, **base))
    state, specs = init_dp_tp_state(sk, tcfg, batch, mesh)
    step = dp_tp_train_step(make_train_step(sk, dp_axis="dp"), mesh, specs)
    losses = []
    for i in range(3):
        state, m = step(state, shard_batch(batch, mesh), jax.random.key(i))
        losses.append(float(m["loss"]))
    log(f"four: sketched few-bit dp2 x tp2 losses {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite sketched losses {losses}")
    out["sketched_losses"] = losses
    return out


def flat(tree):
    import jax
    import numpy as np

    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def single_card_params(params):
    """tp parameters (global arrays) in the single-card tree: the
    row-parallel biases go back into their dense layers."""
    layers = dict(params["roberta"]["layers"])
    attn = dict(layers["attention"])
    attn["output"] = {"kernel": attn["output"]["kernel"],
                      "bias": attn.pop("output_bias")}
    layers["attention"] = attn
    layers["ffn_output"] = {"kernel": layers["ffn_output"]["kernel"],
                            "bias": layers.pop("ffn_bias")}
    return {**params, "roberta": {**params["roberta"], "layers": layers}}


# ---------------------------------------------------------------------------
# Orchestration: one child process per phase.
# ---------------------------------------------------------------------------


def _child(phase: str, variant: str | None) -> None:
    from fewbit_tpu.util import setup_compile_cache

    info = phase_device(verbose=phase == "device")
    setup_compile_cache()
    if phase == "device":
        result = info
    elif phase == "codec":
        result = phase_codec()
    elif phase == "model":
        result = phase_model(variant)
    elif phase == "reference":
        result = phase_reference()
    elif phase == "four":
        result = phase_four()
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    print("RESULT " + json.dumps(result), flush=True)


def _spawn(phase: str, variant: str | None = None) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", phase]
    if variant:
        cmd += ["--variant", variant]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    result = None
    for line in proc.stdout:
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
        else:
            sys.stdout.write(line)
            sys.stdout.flush()
    if proc.wait() != 0 or result is None:
        raise SystemExit(f"phase {phase} {variant or ''} failed "
                         f"(exit {proc.returncode})")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the dp x tp path on four cards")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child, args.variant)
        return 0
    t0 = time.perf_counter()
    device = _spawn("device")
    log("card:", card_name_and_power().replace("\n", "; "))
    log("tolerances:", json.dumps({k: v[0] for k, v in TOL.items()}))
    if args.four:
        _spawn("four")
    else:
        _spawn("codec")
        for variant in VARIANTS:
            _spawn("model", variant)
        _spawn("reference")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
