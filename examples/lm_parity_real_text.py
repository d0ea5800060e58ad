"""Real-data convergence parity: byte-level LM on genuine English prose.

The reference's headline accuracy evidence is GLUE fine-tuning on real data
(``/root/reference/README.md:10-30``); this image has zero network egress,
so GLUE text cannot be fetched.  The real-data stand-in that runs entirely
in-tree: a byte-level GPT trained on the OS image's common-licenses corpus
(~200 KB of genuine English legal prose — GPL/LGPL/GFDL/MPL).  Labels are
the actual next bytes; nothing about the data is synthetic.  Identical
model, init, data order, and schedule across configurations — only the
backward-pass compression differs — so validation bits-per-byte deltas
isolate the effect of the few-bit/sketched gradients.

    python examples/lm_parity_real_text.py --steps 400 --out docs/ACCURACY.md

(For tokenized-MRPC fine-tuning on a connected machine, see
``tools/prepare_mrpc.py`` + ``examples/finetune_glue.py --glue``.)
"""

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def run(config_name, gelu_bits, proj_dim_ratio, sketch, steps, seq=128,
        batch=32, dtype="float32"):
    import jax
    import jax.numpy as jnp

    from fewbit_tpu.models import GPTConfig, GPTForCausalLM
    from fewbit_tpu.train import (TrainConfig, byte_lm_arrays,
                                  byte_lm_batches, causal_lm_loss,
                                  create_train_state, make_train_step,
                                  real_text_corpus)

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=4,
                    num_heads=4, intermediate_size=512,
                    max_position_embeddings=seq,
                    gelu_bits=gelu_bits, proj_dim_ratio=proj_dim_ratio,
                    sketch=sketch, dtype=jnp.dtype(dtype))
    model = GPTForCausalLM(cfg)

    train_ids, val_ids = byte_lm_arrays(real_text_corpus(), seq_len=seq)
    data = byte_lm_batches(train_ids, batch, seed=7)
    n_val = (len(val_ids) // batch) * batch
    val_stream = byte_lm_batches(val_ids[:n_val], batch, seed=0)
    eval_data = [
        {k: jnp.asarray(v) for k, v in next(val_stream).items()}
        for _ in range(n_val // batch)]

    batch0 = {k: jnp.asarray(v) for k, v in next(data).items()}
    state = create_train_state(
        model, TrainConfig(learning_rate=3e-4, total_steps=steps), batch0)
    step = jax.jit(make_train_step(model, loss_fn=causal_lm_loss),
                   donate_argnums=(0,))

    @jax.jit
    def eval_loss(state, batch):
        logits = state.apply_fn({"params": state.params},
                                batch["input_ids"], batch["attention_mask"],
                                deterministic=True)
        return causal_lm_loss(logits, batch["labels"])

    key = jax.random.key(0)
    t0 = time.time()
    final_train = float("nan")
    for i in range(steps):
        batch_i = {k: jnp.asarray(v) for k, v in next(data).items()}
        state, metrics = step(state, batch_i, jax.random.fold_in(key, i))
        final_train = float(metrics["loss"])
    val_nats = sum(float(eval_loss(state, b)) for b in eval_data) \
        / len(eval_data)
    bpb = val_nats / math.log(2.0)
    print(f"{config_name:24s} train-loss {final_train:.4f} "
          f"val-bits-per-byte {bpb:.4f}  ({time.time()-t0:.0f}s)",
          flush=True)
    return final_train, bpb


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--out", type=Path, default=None,
                        help="append a markdown section to this file")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="activation dtype")
    args = parser.parse_args()

    configs = [
        ("exact", None, None, "countsketch"),
        ("gelu 3-bit", 3, None, "countsketch"),
        ("randomized 20% (countsketch)", None, 0.2, "countsketch"),
        ("randomized 20% (srht)", None, 0.2, "srht"),
        ("gelu 3-bit + rand 20%", 3, 0.2, "countsketch"),
    ]
    rows = [(name,) + run(name, gb, pr, sk, args.steps, dtype=args.dtype)
            for name, gb, pr, sk in configs]

    if args.out:
        lines = [
            "",
            "## Real-data parity: byte-level LM on real English prose",
            "",
            f"4-layer/128-hidden GPT, {args.steps} steps, byte-level LM over "
            "the OS image's common-licenses corpus (genuine English text; "
            "labels are the actual next bytes).  Identical init/data/"
            "schedule; only backward compression differs "
            "(examples/lm_parity_real_text.py).",
            "",
            "| config | final train loss | val bits-per-byte |",
            "|---|---|---|",
        ]
        for name, loss, bpb in rows:
            lines.append(f"| {name} | {loss:.4f} | {bpb:.4f} |")
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
        print("appended to", args.out)


if __name__ == "__main__":
    main()
