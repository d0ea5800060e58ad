"""Model + training-loop tests (tiny configs, CPU)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fewbit_tpu.models import (MLP, RobertaConfig,
                               RobertaForSequenceClassification)
from fewbit_tpu.train import (TrainConfig, create_train_state, make_eval_step,
                              make_schedule, make_train_step,
                              restore_checkpoint, save_checkpoint,
                              synthetic_glue)

TINY = RobertaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64,
                     max_position_embeddings=66, num_labels=2)


def tiny_batch(bs=4, seq=16):
    return next(synthetic_glue(bs, seq_len=seq, vocab_size=TINY.vocab_size))


class TestRoberta:

    @pytest.mark.parametrize("cfg", [
        TINY,
        RobertaConfig(**{**TINY.__dict__, "gelu_bits": 3}),
        RobertaConfig(**{**TINY.__dict__, "gelu_bits": 3,
                         "proj_dim_ratio": 0.25}),
    ], ids=["exact", "gelu3", "gelu3+grp"])
    def test_forward_and_grad(self, cfg):
        model = RobertaForSequenceClassification(cfg)
        batch = tiny_batch()
        keys = {"params": jax.random.key(0), "dropout": jax.random.key(1),
                "sketch": jax.random.key(2)}
        params = model.init(keys, batch["input_ids"],
                            batch["attention_mask"], deterministic=True)
        logits = model.apply(params, batch["input_ids"],
                             batch["attention_mask"], deterministic=True,
                             rngs={"sketch": jax.random.key(9)})
        assert logits.shape == (4, 2)
        assert bool(jnp.isfinite(logits).all())

        def loss(p):
            out = model.apply(p, batch["input_ids"],
                              batch["attention_mask"], deterministic=False,
                              rngs={"dropout": jax.random.key(3),
                                    "sketch": jax.random.key(4)})
            return out.sum()

        g = jax.grad(loss)(params)
        norm = jnp.sqrt(sum(jnp.sum(x * x)
                            for x in jax.tree_util.tree_leaves(g)))
        assert bool(jnp.isfinite(norm)) and float(norm) > 0

    def test_fewbit_forward_matches_exact(self):
        """gelu_bits only changes the backward; forward must be identical."""
        model_a = RobertaForSequenceClassification(TINY)
        model_b = RobertaForSequenceClassification(
            RobertaConfig(**{**TINY.__dict__, "gelu_bits": 3}))
        batch = tiny_batch()
        params = model_a.init(jax.random.key(0), batch["input_ids"],
                              batch["attention_mask"])
        la = model_a.apply(params, batch["input_ids"],
                           batch["attention_mask"])
        lb = model_b.apply(params, batch["input_ids"],
                           batch["attention_mask"])
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=1e-5)

    def test_bf16_activations(self):
        cfg = RobertaConfig(**{**TINY.__dict__, "gelu_bits": 3,
                               "proj_dim_ratio": 0.25,
                               "dtype": jnp.bfloat16})
        model = RobertaForSequenceClassification(cfg)
        batch = tiny_batch()
        params = model.init(
            {"params": jax.random.key(0), "sketch": jax.random.key(1)},
            batch["input_ids"], batch["attention_mask"])
        logits = model.apply(params, batch["input_ids"],
                             batch["attention_mask"],
                             rngs={"sketch": jax.random.key(9)})
        assert logits.dtype == jnp.bfloat16
        g = jax.grad(lambda p: model.apply(
            p, batch["input_ids"], batch["attention_mask"],
            deterministic=False,
            rngs={"dropout": jax.random.key(2),
                  "sketch": jax.random.key(3)}).astype(jnp.float32).sum())(
            params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(bool(jnp.isfinite(l).all()) for l in leaves)

    def test_position_ids_skip_padding(self):
        cfg = TINY
        model = RobertaForSequenceClassification(cfg)
        ids = np.full((1, 8), cfg.pad_token_id, np.int32)
        ids[0, :3] = [0, 5, 6]
        mask = (ids != cfg.pad_token_id).astype(np.int32)
        params = model.init(jax.random.key(0), jnp.asarray(ids),
                            jnp.asarray(mask))
        out = model.apply(params, jnp.asarray(ids), jnp.asarray(mask))
        assert bool(jnp.isfinite(out).all())


class TestMLP:

    def test_training_convergence_parity(self):
        """North-star config 1 extended: exact vs 3-bit GELU training."""
        x = jnp.asarray(np.random.RandomState(0).randn(256, 16), jnp.float32)
        y = (np.asarray(x)[:, 0] > 0).astype(np.int32)
        y = jnp.asarray(y)

        def train(gelu_bits, steps=150):
            model = MLP(features=(32, 2), gelu_bits=gelu_bits)
            params = model.init(jax.random.key(0), x)

            import optax
            tx = optax.adam(5e-3)
            opt = tx.init(params)

            @jax.jit
            def step(params, opt):
                def loss(p):
                    logits = model.apply(p, x)
                    return optax.softmax_cross_entropy_with_integer_labels(
                        logits, y).mean()
                l, g = jax.value_and_grad(loss)(params)
                updates, opt = tx.update(g, opt, params)
                return optax.apply_updates(params, updates), opt, l

            for _ in range(steps):
                params, opt, l = step(params, opt)
            return float(l)

        exact = train(None)
        fewbit = train(3)
        assert fewbit < exact + 0.05  # few-bit grads converge comparably


class TestTrainLoop:

    def test_schedule_shape(self):
        cfg = TrainConfig(learning_rate=1e-3, total_steps=100,
                          warmup_ratio=0.1)
        sched = make_schedule(cfg)
        assert float(sched(0)) < 1e-4
        assert abs(float(sched(10)) - 1e-3) < 1e-9
        assert float(sched(100)) < 1e-5

    def test_train_and_eval_step(self):
        model = RobertaForSequenceClassification(
            RobertaConfig(**{**TINY.__dict__, "gelu_bits": 3,
                             "proj_dim_ratio": 0.5}))
        batch = tiny_batch()
        cfg = TrainConfig(total_steps=10, learning_rate=1e-4)
        state = create_train_state(model, cfg, batch)
        step = jax.jit(make_train_step(model))
        new_state, metrics = step(state, batch, jax.random.key(0))
        assert float(metrics["loss"]) > 0
        assert new_state.step == 1
        ev = make_eval_step(model)(new_state, batch)
        assert 0.0 <= float(ev["accuracy"]) <= 1.0

    def test_checkpoint_roundtrip(self, tmp_path):
        model = RobertaForSequenceClassification(TINY)
        batch = tiny_batch()
        cfg = TrainConfig(total_steps=10)
        state = create_train_state(model, cfg, batch)
        step = jax.jit(make_train_step(model))
        state, _ = step(state, batch, jax.random.key(0))
        save_checkpoint(tmp_path / "ckpt", state)

        fresh = create_train_state(model, cfg, batch, seed=123)
        restored = restore_checkpoint(tmp_path / "ckpt", fresh)
        assert int(restored.step) == 1
        a = jax.tree_util.tree_leaves(state.params)[0]
        b = jax.tree_util.tree_leaves(restored.params)[0]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestPlainRoberta:
    """The plain-JAX RoBERTa keeps the linen calling convention and
    parameter paths."""

    @staticmethod
    def paths(tree):
        return sorted(jax.tree_util.keystr(p)
                      for p, _ in jax.tree_util.tree_leaves_with_path(tree))

    LAYER = ["['attention']['key']['bias']", "['attention']['key']['kernel']",
             "['attention']['output']['bias']",
             "['attention']['output']['kernel']",
             "['attention']['query']['bias']",
             "['attention']['query']['kernel']",
             "['attention']['value']['bias']",
             "['attention']['value']['kernel']",
             "['attention_norm']['bias']", "['attention_norm']['scale']"]

    @pytest.mark.parametrize("kw,ffn", [
        ({}, ["['ffn_output']['bias']", "['ffn_output']['kernel']",
              "['intermediate']['bias']", "['intermediate']['kernel']"]),
        ({"gelu_bits": 3, "proj_dim_ratio": 0.25, "sketch": "countsketch"},
         ["['ffn']['down_bias']", "['ffn']['down_kernel']",
          "['ffn']['up_bias']", "['ffn']['up_kernel']"]),
    ], ids=["dense", "whole_ffn"])
    def test_parameter_paths_and_shapes(self, kw, ffn):
        cfg = RobertaConfig(**{**TINY.__dict__, **kw})
        params = RobertaForSequenceClassification(cfg).init(
            jax.random.key(0))["params"]
        layer = sorted(self.LAYER + ffn + ["['output_norm']['bias']",
                                           "['output_norm']['scale']"])
        emb = ["['embeddings']['layer_norm']['bias']",
               "['embeddings']['layer_norm']['scale']",
               "['embeddings']['position_embeddings']['embedding']",
               "['embeddings']['token_type_embeddings']['embedding']",
               "['embeddings']['word_embeddings']['embedding']"]
        want = sorted(["['head_dense']['bias']", "['head_dense']['kernel']",
                       "['head_out']['bias']", "['head_out']['kernel']"]
                      + ["['roberta']" + p for p in emb]
                      + ["['roberta']['layers']" + p for p in layer])
        assert self.paths(params) == want
        layers = params["roberta"]["layers"]
        # Stacked layer axis first, (in, out) kernels after it.
        assert layers["attention"]["query"]["kernel"].shape == (2, 32, 32)
        first = "ffn" if "ffn" in layers else "intermediate"
        kernel = layers[first].get("up_kernel", layers[first].get("kernel"))
        assert kernel.shape == (2, 32, 64)
        assert params["roberta"]["embeddings"]["word_embeddings"][
            "embedding"].shape == (128, 32)
        assert all(l.dtype == jnp.float32 for l in jax.tree.leaves(params))

    def test_unscanned_layers_are_named_per_layer(self):
        cfg = RobertaConfig(**{**TINY.__dict__, "scan_layers": False})
        model = RobertaForSequenceClassification(cfg)
        params = model.init(jax.random.key(0))
        assert {"layer_0", "layer_1"} <= set(params["params"]["roberta"])
        batch = tiny_batch()
        out = model.apply(params, batch["input_ids"],
                          batch["attention_mask"])
        assert out.shape == (4, 2)

    def test_tp_paths_split_the_row_parallel_biases(self):
        cfg = RobertaConfig(**{**TINY.__dict__, "tp_axis": "tp",
                               "tp_size": 2, "num_heads": 4})
        layers = RobertaForSequenceClassification(cfg).init(
            jax.random.key(0))["params"]["roberta"]["layers"]
        assert "bias" not in layers["attention"]["output"]
        assert layers["attention"]["output_bias"].shape == (2, 32)
        assert layers["ffn_bias"].shape == (2, 32)
        # Column-parallel layers hold the local half of the width.
        assert layers["attention"]["query"]["kernel"].shape == (2, 32, 16)
        assert layers["intermediate"]["kernel"].shape == (2, 32, 32)

    def test_init_accepts_a_key_or_an_rng_dict(self):
        model = RobertaForSequenceClassification(TINY)
        a = model.init(jax.random.key(5))
        b = model.init({"params": jax.random.key(5),
                        "dropout": jax.random.key(1)})
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        c = model.init(jax.random.key(6))
        assert not np.array_equal(
            np.asarray(a["params"]["head_dense"]["kernel"]),
            np.asarray(c["params"]["head_dense"]["kernel"]))

    def test_encoder_alone(self):
        from fewbit_tpu.models import RobertaModel

        model = RobertaModel(TINY)
        batch = tiny_batch()
        params = model.init(jax.random.key(0))
        hidden = model.apply(params, batch["input_ids"],
                             batch["attention_mask"])
        assert hidden.shape == (4, 16, 32)

    def test_dropout_needs_a_key(self):
        model = RobertaForSequenceClassification(TINY)
        batch = tiny_batch()
        params = model.init(jax.random.key(0))
        with pytest.raises(ValueError, match="dropout"):
            model.apply(params, batch["input_ids"], batch["attention_mask"],
                        deterministic=False)
        # Dropout keys change the output; the same key reproduces it.
        run = lambda k: model.apply(  # noqa: E731
            params, batch["input_ids"], batch["attention_mask"],
            deterministic=False, rngs={"dropout": jax.random.key(k)})
        np.testing.assert_array_equal(np.asarray(run(1)), np.asarray(run(1)))
        assert not np.array_equal(np.asarray(run(1)), np.asarray(run(2)))

    def test_sketched_apply_without_sketch_key_warns(self):
        cfg = RobertaConfig(**{**TINY.__dict__, "proj_dim_ratio": 0.5})
        model = RobertaForSequenceClassification(cfg)
        batch = tiny_batch()
        params = model.init(jax.random.key(0))
        with pytest.warns(UserWarning, match="constant key"):
            model.apply(params, batch["input_ids"], batch["attention_mask"])

    def test_main_path_imports_no_flax(self):
        import subprocess
        import sys

        code = ("import sys, fewbit_tpu.models.roberta, fewbit_tpu.train; "
                "bad = [m for m in sys.modules "
                "if m.split('.')[0] in ('flax', 'orbax')]; "
                "assert not bad, bad")
        subprocess.run([sys.executable, "-c", code], check=True,
                       env={**__import__("os").environ,
                            "JAX_PLATFORMS": "cpu"})


class TestTrainState:

    def make(self):
        from fewbit_tpu.train import TrainState
        import optax

        params = {"w": jnp.ones((3,)), "b": jnp.zeros(())}
        return TrainState.create(apply_fn=lambda *a: None, params=params,
                                 tx=optax.sgd(0.5))

    def test_create_and_apply_gradients(self):
        state = self.make()
        assert int(state.step) == 0
        new = state.apply_gradients(grads={"w": jnp.full((3,), 2.0),
                                           "b": jnp.ones(())})
        assert int(new.step) == 1
        np.testing.assert_allclose(np.asarray(new.params["w"]), 0.0)
        np.testing.assert_allclose(float(new.params["b"]), -0.5)
        assert new.tx is state.tx and new.apply_fn is state.apply_fn

    def test_is_a_pytree_with_static_fields(self):
        state = self.make()
        leaves, tree = jax.tree_util.tree_flatten(state)
        assert len(leaves) == 3  # step, w, b; sgd keeps no state arrays
        back = jax.tree_util.tree_unflatten(tree, leaves)
        assert back.tx is state.tx
        stepped = jax.jit(lambda s: s.replace(step=s.step + 2))(state)
        assert int(stepped.step) == 2
