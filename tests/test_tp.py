"""Tensor-parallel (dp x tp) tests on the 8-device virtual mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fewbit_tpu.models import RobertaConfig, RobertaForSequenceClassification
from fewbit_tpu.parallel import (dp_tp_train_step, init_dp_tp_state,
                                 make_dp_tp_mesh, shard_batch)
from fewbit_tpu.train import TrainConfig, make_train_step, synthetic_glue


def tp_config(tp_size, **kw):
    base = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=66,
                num_labels=2, hidden_dropout=0.0, attention_dropout=0.0,
                gelu_bits=3)
    base.update(kw)
    return RobertaConfig(tp_axis="tp" if tp_size > 1 else None,
                         tp_size=tp_size, **base)


def batch_of(bs):
    return {k: jnp.asarray(v) for k, v in
            next(synthetic_glue(bs, seq_len=16, vocab_size=128)).items()}


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_dp_tp_step_runs(dp, tp):
    mesh = make_dp_tp_mesh(dp, tp)
    cfg = tp_config(tp)
    model = RobertaForSequenceClassification(cfg)
    batch = batch_of(2 * dp)
    state, specs = init_dp_tp_state(
        model, TrainConfig(total_steps=4, learning_rate=1e-4), batch, mesh)
    step = dp_tp_train_step(make_train_step(model, dp_axis="dp"), mesh,
                            specs)
    new_state, metrics = step(state, shard_batch(batch, mesh),
                              jax.random.key(0))
    assert np.isfinite(float(metrics["loss"]))
    assert int(jax.device_get(new_state.step)) == 1

    # Sharded kernels: the global (unsharded) view of the intermediate
    # kernel is (L, hidden, inter_local * tp) == (2, 32, 64); each tp shard
    # holds 1/tp of the last dim.
    inter = new_state.params["roberta"]["layers"]["intermediate"]["kernel"]
    assert inter.shape == (2, 32, 64)


def test_tp_matches_single_device():
    """tp=2 training step equals the single-device step on the gathered
    global parameters (deterministic config: dropout 0, exact linear)."""
    dp, tp = 1, 2
    mesh = make_dp_tp_mesh(dp, tp)
    cfg = tp_config(tp)
    model = RobertaForSequenceClassification(cfg)
    batch = batch_of(2)
    tcfg = TrainConfig(total_steps=4, learning_rate=1e-4)
    state, specs = init_dp_tp_state(model, tcfg, batch, mesh)
    # Fetch params before the step donates the state buffers.
    tparams = jax.device_get(state.params)
    step = dp_tp_train_step(make_train_step(model, dp_axis="dp"), mesh,
                            specs)
    _, metrics = step(state, shard_batch(batch, mesh), jax.random.key(0))
    tp_loss = float(metrics["loss"])

    # Rebuild the global model: same layer dims, no tp, params assembled
    # from the tp shards.
    gcfg = tp_config(1)
    gmodel = RobertaForSequenceClassification(gcfg)
    gparams = gmodel.init(
        {"params": jax.random.key(9)}, batch["input_ids"],
        batch["attention_mask"], deterministic=True)["params"]

    def to_global(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        return np.asarray(jax.device_get(leaf))

    # The tp state's params are already global-shaped arrays (jax assembles
    # shards); translate the separate psum biases back into Dense biases.
    tparams = jax.tree.map(np.asarray, tparams)

    def fix_layer(layer):
        layer = dict(layer)
        attn = dict(layer["attention"])
        attn["output"] = {"kernel": attn["output"]["kernel"],
                          "bias": attn.pop("output_bias")}
        layer["attention"] = attn
        layer["ffn_output"] = {"kernel": layer["ffn_output"]["kernel"],
                               "bias": layer.pop("ffn_bias")}
        return layer

    roberta = dict(tparams["roberta"])
    roberta["layers"] = fix_layer(roberta["layers"])
    gp = dict(tparams)
    gp["roberta"] = roberta

    import optax

    logits = gmodel.apply({"params": gp}, batch["input_ids"],
                          batch["attention_mask"], deterministic=True)
    ref_loss = float(optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), batch["labels"]).mean())

    # make_train_step uses deterministic=False, but dropout rates are 0 and
    # gelu/linear are deterministic, so losses must agree.
    np.testing.assert_allclose(tp_loss, ref_loss, rtol=1e-4)


@pytest.mark.parametrize("fewbit", [False, True], ids=["dense", "whole_ffn"])
def test_tp_step_updates_match_single_device(fewbit):
    """Gradients through the tp region: tp_copy sums the partial input
    gradients of the column-parallel layers and tp_sum passes the replicated
    cotangent through once, so one SGD step moves every parameter exactly
    as the single-device step does (dp=2 x tp=2, no dropout)."""
    import optax

    from fewbit_tpu.train.loop import classification_loss

    extra = (dict(proj_dim_ratio=0.5, sketch="countsketch") if fewbit
             else {})
    mesh = make_dp_tp_mesh(2, 2)
    model = RobertaForSequenceClassification(tp_config(2, **extra))
    batch = batch_of(4)
    state, specs = init_dp_tp_state(
        model, TrainConfig(total_steps=4), batch, mesh)
    tparams = jax.device_get(state.params)
    sgd = optax.sgd(1.0)
    state = state.replace(tx=sgd, opt_state=sgd.init(state.params))
    specs = specs.replace(tx=sgd, opt_state=sgd.init(state.params))
    step = dp_tp_train_step(make_train_step(model, dp_axis="dp"), mesh,
                            specs)
    new, _ = step(state, shard_batch(batch, mesh), jax.random.key(0))
    moved = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         tparams, jax.device_get(new.params))

    def to_single(p):
        layers = dict(p["roberta"]["layers"])
        attn = dict(layers["attention"])
        attn["output"] = {"kernel": attn["output"]["kernel"],
                          "bias": attn.pop("output_bias")}
        layers["attention"] = attn
        bias = layers.pop("ffn_bias")
        if "ffn" in layers:
            layers["ffn"] = {**layers["ffn"], "down_bias": bias}
        else:
            layers["ffn_output"] = {"kernel": layers["ffn_output"]["kernel"],
                                    "bias": bias}
        return {**p, "roberta": {**p["roberta"], "layers": layers}}

    single = RobertaForSequenceClassification(tp_config(1, **extra))

    def loss(p, half):
        # Each dp shard folds its index into the step key, as the step does.
        b = {k: v[2 * half:2 * half + 2] for k, v in batch.items()}
        drop, sketch = jax.random.split(
            jax.random.fold_in(jax.random.key(0), half))
        logits = single.apply({"params": p}, b["input_ids"],
                              b["attention_mask"], deterministic=False,
                              rngs={"dropout": drop, "sketch": sketch})
        return classification_loss(logits, b["labels"])

    p0 = to_single(tparams)
    grads = [jax.grad(loss)(p0, h) for h in (0, 1)]
    want = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2,
                        *grads)
    got = to_single(moved)
    for path, g in jax.tree_util.tree_leaves_with_path(want):
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            continue  # softmax is blind to the key bias: its gradient is 0
        a = got
        for k in path:
            a = a[k.key]
        np.testing.assert_allclose(a, g, rtol=2e-4, atol=2e-6,
                                   err_msg=name)
