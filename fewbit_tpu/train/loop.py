"""Training loop: optimizer schedule, train/eval steps, checkpointing.

The optimizer/schedule reproduces the reference's GLUE fine-tuning recipe
(AdamW beta=(0.9, 0.98) eps=1e-6 weight-decay=0.1, polynomial decay with 6%
warmup — ``notebooks/few-bit-backward/exp-fine-tuning-glue.py:240-257``),
re-expressed in optax.  ``model`` is anything with the linen ``init`` /
``apply`` convention: the plain-JAX RoBERTa, or a flax module.
Checkpoint/resume — absent from the reference, which delegated to the HF
Trainer — is first-class here via orbax, imported only when used.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax
from jax import lax

__all__ = ("TrainConfig", "TrainState", "make_schedule", "make_optimizer",
           "create_train_state", "make_train_step", "make_eval_step",
           "causal_lm_loss", "save_checkpoint", "restore_checkpoint")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    warmup_ratio: float = 0.06
    total_steps: int = 1000
    max_grad_norm: Optional[float] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, parameters and optimizer state as one pytree.

    ``apply_fn`` and ``tx`` are static (not leaves), so a state can be a jit
    argument and its spec tree can hold PartitionSpecs in the leaves."""

    step: Any
    params: Any
    opt_state: Any
    apply_fn: Callable = dataclasses.field(metadata=dict(static=True))
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True))

    @classmethod
    def create(cls, *, apply_fn: Callable, params, tx) -> "TrainState":
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_schedule(cfg: TrainConfig) -> optax.Schedule:
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 1)
    return optax.join_schedules([
        optax.linear_schedule(0.0, cfg.learning_rate, warmup),
        optax.polynomial_schedule(cfg.learning_rate, 0.0, power=1.0,
                                  transition_steps=cfg.total_steps - warmup),
    ], boundaries=[warmup])


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    tx = optax.adamw(make_schedule(cfg), b1=cfg.beta1, b2=cfg.beta2,
                     eps=cfg.eps, weight_decay=cfg.weight_decay)
    if cfg.max_grad_norm:
        tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm), tx)
    return tx


def create_train_state(model, cfg: TrainConfig, sample_batch,
                       seed: int = 0) -> TrainState:
    init_key = jax.random.key(seed)
    params = model.init(
        {"params": init_key, "dropout": init_key, "sketch": init_key},
        *_model_inputs(sample_batch), deterministic=True)["params"]
    return TrainState.create(apply_fn=model.apply, params=params,
                             tx=make_optimizer(cfg))


def _model_inputs(batch):
    return (batch["input_ids"], batch.get("attention_mask"))


def classification_loss(logits: jax.Array, labels: jax.Array) -> jax.Array:
    return optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), labels).mean()


def _causal_lm_sum_count(logits: jax.Array, labels: jax.Array):
    """(loss sum over valid tokens, valid-token count) — the decomposition
    the dp step uses to weight shards by their true token counts."""
    valid = labels >= 0
    per_tok = optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), jnp.maximum(labels, 0))
    return (per_tok * valid).sum(), valid.sum()


def causal_lm_loss(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Next-token cross entropy; ``labels`` are pre-shifted (label at
    position t = token t+1) with negative values masked out."""
    total, count = _causal_lm_sum_count(logits, labels)
    return total / jnp.maximum(count, 1)


# Marks the loss as token-weighted: under dp the step combines shard losses
# via globally psum-ed (sum, count) instead of a pmean of per-shard means,
# which would be biased whenever shards hold unequal valid-token counts.
causal_lm_loss.sum_count = _causal_lm_sum_count


def make_train_step(model, dp_axis: Optional[str] = None,
                    loss_fn: Callable = classification_loss) -> Callable:
    """Build ``step(state, batch, key) -> (state, metrics)``.

    With ``dp_axis`` set, gradients and metrics are ``pmean``-ed over that
    axis and the RNG key is folded per shard — wrap the result with
    :func:`fewbit_tpu.parallel.data_parallel_step` (or run under pjit).
    """

    def step(state: TrainState, batch, key):
        if dp_axis is not None:
            key = jax.random.fold_in(key, lax.axis_index(dp_axis))
        dropout_key, sketch_key = jax.random.split(key)

        sum_count = getattr(loss_fn, "sum_count", None)

        def compute_loss(params):
            logits = state.apply_fn(
                {"params": params}, *_model_inputs(batch),
                deterministic=False,
                rngs={"dropout": dropout_key, "sketch": sketch_key})
            if dp_axis is not None and sum_count is not None:
                # Token-weighted loss: divide each shard's loss *sum* by the
                # GLOBAL valid-token count (psum), scaled by the axis size so
                # the later pmean of gradients/metrics recovers exactly
                # sum_i s_i / n_total — unbiased under unequal shard counts.
                total, count = sum_count(logits, batch["labels"])
                n_total = lax.psum(count, dp_axis)
                d = lax.psum(1, dp_axis)
                return total * d / jnp.maximum(n_total, 1)
            return loss_fn(logits, batch["labels"])

        loss, grads = jax.value_and_grad(compute_loss)(state.params)
        if dp_axis is not None:
            grads = lax.pmean(grads, dp_axis)
            loss = lax.pmean(loss, dp_axis)
        state = state.apply_gradients(grads=grads)
        return state, {"loss": loss}

    return step


def make_eval_step(model) -> Callable:

    @jax.jit
    def step(state: TrainState, batch):
        # Sketches only affect gradients, so eval could run on the constant-
        # key fallback — but thread an explicit key anyway so eval never
        # trips the fallback warning (or the strict mode).
        logits = state.apply_fn({"params": state.params},
                                *_model_inputs(batch), deterministic=True,
                                rngs={"sketch": jax.random.key(0)})
        preds = jnp.argmax(logits, axis=-1)
        return {"accuracy": (preds == batch["labels"]).mean(),
                "loss": classification_loss(logits, batch["labels"])}

    return step


# ---------------------------------------------------------------------------
# Checkpointing (orbax).
# ---------------------------------------------------------------------------


def save_checkpoint(path, state: TrainState) -> None:
    import orbax.checkpoint as ocp

    path = Path(path).absolute()
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, {"params": state.params,
                          "opt_state": state.opt_state,
                          "step": state.step})


def restore_checkpoint(path, state: TrainState) -> TrainState:
    import orbax.checkpoint as ocp

    path = Path(path).absolute()
    with ocp.StandardCheckpointer() as ckptr:
        template = {"params": state.params, "opt_state": state.opt_state,
                    "step": state.step}
        restored = ckptr.restore(path, template)
    return state.replace(params=restored["params"],
                         opt_state=restored["opt_state"],
                         step=restored["step"])
