"""Real-prose CLASSIFICATION parity: exact vs few-bit/sketched fine-tuning.

The reference's headline accuracy table is RoBERTa fine-tuned on MRPC
(``/root/reference/README.md:10-30``) — real-text classification through a
pooled head.  This environment has zero network egress (no MRPC, no
pretrained checkpoints), so the in-environment classification parity runs
on the real English prose that ships with the OS image (the
common-licenses corpus, the same source as the byte-LM parity experiment):

* ``--task doc`` (default): single-segment DOCUMENT classification — which
  license text did this genuine English segment come from (14 classes)?
  Byte-level topic/style classification that a small from-scratch model
  demonstrably learns, exercising exactly the path MRPC exercises (pooled
  <s> head + cross-entropy fine-tune), with the compression applied where
  the reference applies it (during training).
* ``--task pair``: the MRPC-shaped segment-pair variant
  (``fewbit_tpu.train.real_pair_arrays``).  Recorded finding: at this
  model scale WITHOUT a pretrained encoder the relational pair task sits
  at chance for every configuration (from-scratch post-LN logit collapse;
  a byte-histogram cosine baseline gets ~58%), so it is not a useful
  parity instrument here — kept for completeness and for environments
  where a pretrained encoder is available.

Identical model/init/data/schedule across configurations; only the
backward-pass compression differs, so validation-accuracy deltas isolate
the few-bit/sketched gradients.

    python examples/classification_parity_real_text.py --steps 1200

Writes a markdown table on stdout; paste into docs/ACCURACY.md.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

SEQ = 128
VOCAB = 259  # <s>=0 pad=1 </s>=2, byte b -> b + 3


def model_config(num_labels, gelu_bits=None, proj_dim_ratio=None,
                 sketch="countsketch"):
    from fewbit_tpu.models import RobertaConfig

    # fused_ffn=False keeps one parameter tree across ALL configurations
    # (Dense names `intermediate`/`ffn_output`); the elementwise few-bit
    # path is numerically the same algorithm as the fused kernels.
    return RobertaConfig(vocab_size=VOCAB, hidden_size=128, num_layers=4,
                         num_heads=4, intermediate_size=512,
                         max_position_embeddings=SEQ + 2,
                         num_labels=num_labels, pad_token_id=1,
                         gelu_bits=gelu_bits,
                         proj_dim_ratio=proj_dim_ratio, sketch=sketch,
                         fused_ffn=False)


def train_one(config_name, data, num_labels, gelu_bits, proj_dim_ratio,
              sketch, steps, batch=32, lr=3e-4, seed=0,
              backbone_params=None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fewbit_tpu.models import RobertaForSequenceClassification
    from fewbit_tpu.train import (TrainConfig, batches_from_arrays,
                                  create_train_state, make_eval_step,
                                  make_train_step)

    train_arrays, val_arrays = data
    cfg = model_config(num_labels, gelu_bits, proj_dim_ratio,
                       sketch or "countsketch")
    model = RobertaForSequenceClassification(cfg)
    stream = batches_from_arrays(train_arrays, batch, seed=7 + seed)
    batch0 = {k: jnp.asarray(v) for k, v in next(stream).items()}
    state = create_train_state(
        model, TrainConfig(learning_rate=lr, total_steps=steps), batch0,
        seed=seed)
    if backbone_params is not None:
        # Transplant the MLM-pretrained encoder (same parameter tree for
        # all configurations thanks to fused_ffn=False); head stays
        # seed-fresh, matching the MRPC fine-tune recipe.
        params = dict(state.params)
        # jnp.array(copy=True): each seed's donated step buffers must not
        # alias the shared pretrained tree.
        params["roberta"] = jax.tree.map(lambda a: jnp.array(a, copy=True),
                                         backbone_params)
        state = state.replace(params=params)
    step = jax.jit(make_train_step(model), donate_argnums=(0,))
    eval_step = make_eval_step(model)

    n_val = (len(val_arrays["labels"]) // batch) * batch
    eval_batches = [
        {k: jnp.asarray(v[i:i + batch]) for k, v in val_arrays.items()}
        for i in range(0, n_val, batch)]

    key = jax.random.key(seed)
    t0 = time.time()
    final_train = float("nan")
    for i in range(steps):
        batch_i = {k: jnp.asarray(v) for k, v in next(stream).items()}
        state, metrics = step(state, batch_i, jax.random.fold_in(key, i))
        final_train = float(metrics["loss"])
    accs = [float(eval_step(state, b)["accuracy"]) for b in eval_batches]
    acc = float(np.mean(accs))
    print(f"{config_name:32s} seed {seed} train-loss {final_train:.4f} "
          f"val-accuracy {acc:.4f}  ({time.time()-t0:.0f}s)", flush=True)
    return final_train, acc


def pretrain_backbone(steps, batch=32, lr=3e-4, seed=0):
    """Short in-corpus denoising-MLM pretrain of the (exact) encoder.

    BERT-style corruption without a dedicated mask token: 15% of byte
    positions are replaced by random byte tokens and the model predicts
    the ORIGINAL byte there (cross-entropy at corrupted positions only) —
    the same objective family the reference's MRPC recipe inherits from
    pretrained RoBERTa, scaled to this environment.  Returns the
    ``roberta`` parameter subtree.

    Scope note: this is IN-CORPUS pretraining — the raw windows include
    text that later lands on the val side of the pair split.  The pair
    LABELS (consecutive-vs-different-document) are never seen, so the
    fine-tune comparison across configurations stays fair (all configs
    share the same encoder), but the pair task's absolute val accuracy
    should be read as in-domain, not held-out-domain, generalization.
    """
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from fewbit_tpu.models import RobertaModel
    from fewbit_tpu.train import real_text_corpus

    cfg = model_config(num_labels=2)  # exact encoder (no compression)

    class ByteMLM(nn.Module):
        @nn.compact
        def __call__(self, ids, deterministic=True):
            h = RobertaModel(cfg, name="roberta")(
                ids, jnp.ones_like(ids), deterministic=deterministic)
            return nn.Dense(VOCAB, name="lm_head")(h)

    # Widen BEFORE the +3 shift: a uint8 + 3 wraps bytes >= 253 onto the
    # special tokens 0/1/2 (ASCII corpora never hit this, but raw files
    # are read unvalidated).
    text = np.frombuffer(real_text_corpus(), dtype=np.uint8).astype(np.int32)
    n_win = (len(text) - 1) // (SEQ - 1)
    windows = np.stack([text[i * (SEQ - 1):(i + 1) * (SEQ - 1)] + 3
                        for i in range(n_win)])
    windows = np.concatenate(
        [np.zeros((n_win, 1), np.int32), windows], axis=1)  # <s> prefix

    model = ByteMLM()
    rng = np.random.RandomState(seed)
    init_key = jax.random.key(seed)
    params = model.init({"params": init_key, "dropout": init_key,
                         "sketch": init_key}, jnp.asarray(windows[:2]),
                        deterministic=True)["params"]
    tx = optax.adamw(optax.linear_schedule(lr, 0.0, steps),
                     b1=0.9, b2=0.98, weight_decay=0.01)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, ids, corrupt, originals, key):
        def loss_fn(p):
            logits = model.apply({"params": p}, ids, deterministic=False,
                                 rngs={"dropout": key, "sketch": key})
            per = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), originals)
            m = corrupt.astype(jnp.float32)
            return (per * m).sum() / jnp.maximum(m.sum(), 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.key(1000 + seed)
    t0 = time.time()
    loss = float("nan")
    for i in range(steps):
        idx = rng.randint(0, n_win, size=batch)
        ids = windows[idx].copy()
        originals = ids.copy()
        corrupt = (rng.rand(batch, SEQ) < 0.15)
        corrupt[:, 0] = False  # never corrupt <s>
        ids[corrupt] = rng.randint(3, VOCAB, size=int(corrupt.sum()))
        params, opt_state, l = step(params, opt_state, jnp.asarray(ids),
                                    jnp.asarray(corrupt),
                                    jnp.asarray(originals),
                                    jax.random.fold_in(key, i))
        loss = float(l)
        if (i + 1) % 200 == 0:
            print(f"  pretrain step {i + 1}/{steps} mlm-loss {loss:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    print(f"pretrain done: {steps} steps, final mlm-loss {loss:.4f} "
          f"(chance {np.log(256):.2f})", flush=True)
    return params["roberta"]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", choices=("doc", "pair"), default="doc")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per configuration (mean±std reported)")
    ap.add_argument("--pretrain", type=int, default=0,
                    help="in-corpus denoising-MLM pretrain steps for the "
                         "shared (exact) encoder before fine-tuning")
    args = ap.parse_args()

    import numpy as np

    from fewbit_tpu.train import real_doc_arrays, real_pair_arrays

    if args.task == "doc":
        train_arrays, val_arrays, n_cls = real_doc_arrays()
    else:
        train_arrays, val_arrays = real_pair_arrays(min_segment=64)
        n_cls = 2
    data = (train_arrays, val_arrays)
    print(f"{args.task} dataset: train {len(train_arrays['labels'])}, "
          f"val {len(val_arrays['labels'])}, {n_cls} classes "
          f"(chance {1.0 / n_cls:.3f})", flush=True)

    backbone = None
    if args.pretrain:
        print(f"pretraining shared encoder: {args.pretrain} MLM steps",
              flush=True)
        backbone = pretrain_backbone(args.pretrain, batch=args.batch)

    configs = [
        ("exact", None, None, None),
        ("gelu 3-bit", 3, None, None),
        ("randomized 20% (countsketch)", None, 0.2, "countsketch"),
        ("gelu 3-bit + rand 20%", 3, 0.2, "countsketch"),
    ]
    rows = []
    for name, bits, ratio, sketch in configs:
        losses, accs = [], []
        for seed in range(args.seeds):
            loss, acc = train_one(name, data, n_cls, bits, ratio, sketch,
                                  args.steps, batch=args.batch, seed=seed,
                                  backbone_params=backbone)
            losses.append(loss)
            accs.append(acc)
        rows.append((name, float(np.mean(losses)), float(np.mean(accs)),
                     float(np.std(accs)), len(accs)))

    print(f"\n| config | final train loss (mean) | val accuracy "
          f"mean±std over {args.seeds} seeds (chance {1.0 / n_cls:.3f}) |")
    print("|---|---|---|")
    for name, loss, acc, std, n in rows:
        print(f"| {name} | {loss:.4f} | {acc:.3f} ± {std:.3f} |")


if __name__ == "__main__":
    main()
