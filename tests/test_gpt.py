"""GPT causal-LM family tests (tiny configs, CPU).

The reference only ever drives RoBERTa (``benchmark/bench-roberta.py``);
the GPT family is net-new coverage showing the few-bit engine generalises
across model families.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fewbit_tpu.models import GPTConfig, GPTForCausalLM
from fewbit_tpu.train import (TrainConfig, causal_lm_loss, create_train_state,
                              make_train_step, synthetic_lm)

TINY = GPTConfig(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
                 intermediate_size=64, max_position_embeddings=32)


def tiny_batch(bs=4, seq=16, seed=0):
    b = next(synthetic_lm(bs, seq_len=seq, vocab_size=TINY.vocab_size,
                          seed=seed))
    return {k: jnp.asarray(v) for k, v in b.items()}


def init(model, batch):
    return model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "sketch": jax.random.key(2)},
        batch["input_ids"], batch["attention_mask"], deterministic=True)


class TestGPT:

    @pytest.mark.parametrize("cfg", [
        TINY,
        GPTConfig(**{**TINY.__dict__, "gelu_bits": 3}),
        GPTConfig(**{**TINY.__dict__, "gelu_bits": 3,
                     "proj_dim_ratio": 0.25}),
        GPTConfig(**{**TINY.__dict__, "tie_lm_head": False}),
        GPTConfig(**{**TINY.__dict__, "scan_layers": False}),
    ], ids=["exact", "gelu3", "gelu3+grp", "untied", "unrolled"])
    def test_forward_and_grad(self, cfg):
        model = GPTForCausalLM(cfg)
        batch = tiny_batch()
        params = init(model, batch)
        logits = model.apply(params, batch["input_ids"],
                             batch["attention_mask"], deterministic=True,
                             rngs={"sketch": jax.random.key(9)})
        assert logits.shape == (4, 16, cfg.vocab_size)
        assert bool(jnp.isfinite(logits).all())

        def loss(p):
            out = model.apply(p, batch["input_ids"],
                              batch["attention_mask"], deterministic=False,
                              rngs={"dropout": jax.random.key(3),
                                    "sketch": jax.random.key(4)})
            return causal_lm_loss(out, batch["labels"])

        g = jax.grad(loss)(params)
        norm = jnp.sqrt(sum(jnp.sum(x * x)
                            for x in jax.tree_util.tree_leaves(g)))
        assert bool(jnp.isfinite(norm)) and float(norm) > 0

    def test_causality(self):
        """Logits at position t must not depend on tokens after t."""
        model = GPTForCausalLM(TINY)
        batch = tiny_batch()
        params = init(model, batch)
        ids = np.asarray(batch["input_ids"]).copy()
        base = model.apply(params, jnp.asarray(ids), None)
        ids[:, 10:] = (ids[:, 10:] + 17) % TINY.vocab_size
        perturbed = model.apply(params, jnp.asarray(ids), None)
        np.testing.assert_allclose(np.asarray(base[:, :10]),
                                   np.asarray(perturbed[:, :10]), atol=1e-5)
        assert not np.allclose(np.asarray(base[:, 10:]),
                               np.asarray(perturbed[:, 10:]))

    def test_fewbit_forward_matches_exact(self):
        """gelu_bits only changes the backward; forward must be identical."""
        model_a = GPTForCausalLM(TINY)
        model_b = GPTForCausalLM(GPTConfig(**{**TINY.__dict__,
                                              "gelu_bits": 3}))
        batch = tiny_batch()
        params = init(model_a, batch)
        la = model_a.apply(params, batch["input_ids"],
                           batch["attention_mask"])
        lb = model_b.apply(params, batch["input_ids"],
                           batch["attention_mask"])
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=1e-5)

    def test_tied_head_shares_embedding(self):
        model = GPTForCausalLM(TINY)
        batch = tiny_batch()
        params = init(model, batch)
        flat = jax.tree_util.tree_leaves_with_path(params)
        names = ["/".join(str(k) for k in path) for path, _ in flat]
        assert not any("lm_head" in n for n in names)
        untied = GPTForCausalLM(GPTConfig(**{**TINY.__dict__,
                                             "tie_lm_head": False}))
        uparams = init(untied, batch)
        uflat = jax.tree_util.tree_leaves_with_path(uparams)
        unames = ["/".join(str(k) for k in path) for path, _ in uflat]
        assert any("lm_head" in n for n in unames)

    def test_lm_loss_masking(self):
        logits = jnp.zeros((2, 4, 8))
        labels = jnp.array([[1, 2, 3, -100], [-100, -100, -100, -100]])
        # Uniform logits: CE = log(8) on the 3 valid positions only.
        loss = causal_lm_loss(logits, labels)
        np.testing.assert_allclose(float(loss), np.log(8), rtol=1e-6)

    def test_training_step_and_convergence(self):
        cfg = GPTConfig(**{**TINY.__dict__, "gelu_bits": 3,
                           "proj_dim_ratio": 0.5})
        model = GPTForCausalLM(cfg)
        it = synthetic_lm(8, seq_len=16, vocab_size=cfg.vocab_size)
        batch = {k: jnp.asarray(v) for k, v in next(it).items()}
        state = create_train_state(
            model, TrainConfig(total_steps=60, learning_rate=3e-3), batch)
        step = jax.jit(make_train_step(model, loss_fn=causal_lm_loss))
        first = None
        for i in range(60):
            nb = {k: jnp.asarray(v) for k, v in next(it).items()}
            state, metrics = step(state, nb, jax.random.key(i))
            if first is None:
                first = float(metrics["loss"])
        last = float(metrics["loss"])
        assert np.isfinite(last)
        # The synthetic stream is 75% next = f(prev): the loss must drop
        # clearly below the initial uniform level as the transition is
        # learnt (60 tiny steps ~ 0.45 nats at this scale).
        assert last < first - 0.25

    def test_dp_tp_mesh(self):
        """GPT under the same dp x tp machinery as RoBERTa (shared
        module-name sharding rules)."""
        from fewbit_tpu.parallel import (dp_tp_train_step, init_dp_tp_state,
                                         make_dp_tp_mesh, shard_batch)

        cfg = GPTConfig(**{**TINY.__dict__, "num_heads": 4, "tp_axis": "tp",
                           "tp_size": 2, "gelu_bits": 3,
                           "proj_dim_ratio": 0.25})
        model = GPTForCausalLM(cfg)
        mesh = make_dp_tp_mesh(4, 2)
        batch = tiny_batch(bs=8)
        state, specs = init_dp_tp_state(
            model, TrainConfig(total_steps=4, learning_rate=1e-4), batch,
            mesh)
        step = dp_tp_train_step(
            make_train_step(model, dp_axis="dp", loss_fn=causal_lm_loss),
            mesh, specs)
        new_state, metrics = step(state, shard_batch(batch, mesh),
                                  jax.random.key(0))
        assert np.isfinite(float(metrics["loss"]))
        assert int(jax.device_get(new_state.step)) == 1


def test_sequence_length_guard():
    model = GPTForCausalLM(TINY)
    too_long = jnp.zeros((2, TINY.max_position_embeddings + 1), jnp.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.init(jax.random.key(0), too_long)
