"""Fine-tune RoBERTa with few-bit compression (reference parity:
notebooks/few-bit-backward/exp-fine-tuning-glue.py and
notebooks/randomized-backward/exp-fine-tuning-glue.py).

Runs on synthetic MRPC-shaped data by default (this environment has no
network); pass ``--glue path/to/mrpc_tokenized.npz`` to fine-tune and
evaluate on real tokenized MRPC (produce the file once with
``tools/prepare_mrpc.py`` on a machine with network access).

    python examples/finetune_glue.py --num-bits 3 --proj-dim-ratio 0.2 \
        --steps 50 --batch 16 [--glue data/mrpc_tokenized.npz]

For a real-data convergence-parity experiment that runs fully inside this
zero-egress image, see ``examples/lm_parity_real_text.py`` (byte-level LM on
genuine English prose shipped with the OS).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--num-bits", type=int, default=None,
                        help="few-bit GELU backward (default: exact)")
    parser.add_argument("--proj-dim-ratio", type=float, default=None,
                        help="RandomizedLinear sketch ratio (default: exact)")
    parser.add_argument("--matmul", default="gaussian",
                        choices=["gaussian", "rademacher", "dct", "dft",
                                 "countsketch", "srht"])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--hidden", type=int, default=768)
    parser.add_argument("--checkpoint-dir", type=Path, default=None)
    parser.add_argument("--glue", type=Path, default=None, metavar="NPZ",
                        help="path to a tokenized MRPC npz (schema of "
                             "fewbit_tpu.train.load_tokenized_npz; produce "
                             "it with tools/prepare_mrpc.py on a connected "
                             "machine). Default: synthetic MRPC-shaped data.")
    parser.add_argument("--eval-every", type=int, default=25)
    parser.add_argument("--log-dir", type=Path, default=None,
                        help="write metrics.jsonl for this run under "
                             "LOG_DIR/<param>/<task>/ (summarise runs with "
                             "tools/summarize_runs.py — the reference's "
                             "TensorBoard+postprocessing pipeline)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from fewbit_tpu.util import setup_compile_cache

    setup_compile_cache()
    from fewbit_tpu.models import (RobertaConfig,
                                   RobertaForSequenceClassification)
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_eval_step, make_train_step,
                                  save_checkpoint, synthetic_glue)

    cfg = RobertaConfig(num_layers=args.layers, hidden_size=args.hidden,
                        num_heads=max(args.hidden // 64, 1),
                        intermediate_size=args.hidden * 4,
                        gelu_bits=args.num_bits,
                        proj_dim_ratio=args.proj_dim_ratio,
                        sketch=args.matmul)
    model = RobertaForSequenceClassification(cfg)

    eval_batches = None
    if args.glue:
        from fewbit_tpu.train import batches_from_arrays, load_tokenized_npz

        splits = load_tokenized_npz(args.glue)
        train = splits["train"]
        val = splits.get("validation")
        data = batches_from_arrays(train, args.batch)
        if val is not None:
            n_eval = (len(val["labels"]) // args.batch) * args.batch
            eval_batches = [
                {k: jnp.asarray(v[s:s + args.batch])
                 for k, v in val.items()}
                for s in range(0, n_eval, args.batch)]
        print(f"MRPC: {len(train['labels'])} train / "
              f"{len(val['labels']) if val else 0} validation examples")
    else:
        data = synthetic_glue(args.batch, seq_len=args.seq,
                              vocab_size=cfg.vocab_size)

    batch0 = {k: jnp.asarray(v) for k, v in next(data).items()}
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps)
    state = create_train_state(model, tcfg, batch0)
    step = jax.jit(make_train_step(model), donate_argnums=(0,))
    evaluate = make_eval_step(model)

    def run_eval(state):
        if eval_batches is None:
            ev = evaluate(state, batch0)
            return float(ev["accuracy"])
        correct = 0.0
        for eb in eval_batches:
            correct += float(evaluate(state, eb)["accuracy"]) * args.batch
        return correct / (len(eval_batches) * args.batch)

    logger = None
    if args.log_dir:
        from fewbit_tpu.metrics import MetricsLogger

        param = (f"gelu{args.num_bits or 0}-"
                 f"rand{int(100 * (args.proj_dim_ratio or 0))}%")
        task = "mrpc" if args.glue else "synthetic"
        logger = MetricsLogger(args.log_dir / param / task,
                               task=task, param=param)

    print(f"config: {cfg.num_layers}L/{cfg.hidden_size}H gelu_bits="
          f"{cfg.gelu_bits} proj_dim_ratio={cfg.proj_dim_ratio}")
    t0 = time.time()
    key = jax.random.key(0)
    for i in range(args.steps):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        state, metrics = step(state, batch, jax.random.fold_in(key, i))
        if logger:
            logger.log(i + 1, **{"train/loss": float(metrics["loss"])})
        if (i + 1) % args.eval_every == 0 or i == 0:
            acc = run_eval(state)
            which = "val" if eval_batches is not None else "holdout"
            if logger:
                logger.log(i + 1, **{"eval/accuracy": acc})
            print(f"step {i+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"{which} acc {acc:.3f}  ({time.time()-t0:.1f}s)")
    final_acc = run_eval(state)
    if logger:
        logger.log(args.steps, **{"eval/accuracy": final_acc})
        logger.close()
    print(f"final {'val' if eval_batches is not None else 'holdout'} "
          f"accuracy: {final_acc:.4f}")

    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir / "final", state)
        print("checkpoint saved to", args.checkpoint_dir / "final")


if __name__ == "__main__":
    main()
