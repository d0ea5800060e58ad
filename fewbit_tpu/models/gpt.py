"""GPT-2-style decoder-only causal LM with swappable few-bit components.

A second model family beyond the reference's RoBERTa-only scope
(``/root/reference/benchmark/bench-roberta.py`` is the only model the
reference ever drives, and only through monkey-patching) — here the
memory-efficient training path is first-class config, identical in spirit to
:mod:`fewbit_tpu.models.roberta`:

* ``gelu_bits`` — the FFN activation saves a packed ``bits``/8-byte code
  residual instead of the fp32 pre-activation (the fused dense + activation
  op);
* ``proj_dim_ratio`` — every projection becomes a RandomizedDense whose VJP
  saves a sketch of its input along the flattened batch*seq axis.  Causal
  LMs train on full sequences, so the batch*seq axis is large and the
  sketch saving is proportionally bigger than in classification fine-tuning.

Architecture: pre-LayerNorm blocks, learned positions, weight-tied LM head
(GPT-2 conventions).  Tensor parallelism reuses the exact module-name rules
of :func:`fewbit_tpu.parallel.tp_param_spec` (``query``/``key``/``value``/
``intermediate`` column-parallel, ``output``/``ffn_output`` row-parallel), so
the dp x tp machinery works for both families without modification.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from fewbit_tpu import functional as F
from fewbit_tpu.modules.linear import RandomizedDense
from fewbit_tpu.parallel.tp import tp_copy, tp_sum

__all__ = ("GPTConfig", "GPTModel", "GPTForCausalLM")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: Any = jnp.float32
    # Few-bit switches (same semantics as RobertaConfig).
    gelu_bits: Optional[int] = None
    proj_dim_ratio: Optional[float] = None
    sketch: str = "countsketch"
    # One scanned block with stacked parameters (compile the layer once).
    scan_layers: bool = True
    # Megatron-style tensor parallelism over a named mesh axis (see
    # fewbit_tpu.parallel.tp — the same name rules shard this model).
    tp_axis: Optional[str] = None
    tp_size: int = 1
    # GPT-2 ties the LM head to the token embedding.
    tie_lm_head: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _dense(cfg: GPTConfig, features: int, name: str,
           use_bias: bool = True) -> nn.Module:
    if cfg.proj_dim_ratio:
        return RandomizedDense(features=features, dtype=cfg.dtype,
                               use_bias=use_bias,
                               proj_dim_ratio=cfg.proj_dim_ratio,
                               matmul=cfg.sketch, name=name)
    return nn.Dense(features=features, dtype=cfg.dtype, use_bias=use_bias,
                    name=name)


def _enter_tp(cfg: GPTConfig, x: jax.Array) -> jax.Array:
    return x if cfg.tp_axis is None else tp_copy(x, cfg.tp_axis)


class GPTSelfAttention(nn.Module):
    cfg: GPTConfig

    @nn.compact
    def __call__(self, x, attention_mask, deterministic: bool):
        cfg = self.cfg
        b, s, h = x.shape
        heads = cfg.num_heads // cfg.tp_size  # local heads under TP
        width = heads * cfg.head_dim
        x = _enter_tp(cfg, x)
        q = _dense(cfg, width, "query")(x)
        k = _dense(cfg, width, "key")(x)
        v = _dense(cfg, width, "value")(x)

        def split(t):
            return t.reshape(b, s, heads, cfg.head_dim)

        q, k, v = split(q), split(k), split(v)
        scale = cfg.head_dim ** -0.5

        logits = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k)
        neg = jnp.finfo(jnp.float32).min
        causal = jnp.tril(jnp.ones((s, s), bool))
        keep = causal[None, None, :, :]
        if attention_mask is not None:
            keep = keep & (attention_mask[:, None, None, :] > 0)
        logits = logits + jnp.where(keep, 0.0, neg).astype(logits.dtype)
        probs = jax.nn.softmax(logits, axis=-1)
        probs = nn.Dropout(cfg.attention_dropout)(
            probs, deterministic=deterministic)
        ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, width)

        if cfg.tp_axis is None:
            out = _dense(cfg, h, "output")(ctx)
        else:
            out = _dense(cfg, h, "output", use_bias=False)(ctx)
            out = tp_sum(out, cfg.tp_axis)
            out = out + self.param("output_bias", nn.initializers.zeros,
                                   (h,), cfg.dtype)
        return nn.Dropout(cfg.hidden_dropout)(out,
                                              deterministic=deterministic)


class GPTBlock(nn.Module):
    """Pre-LN transformer decoder block."""
    cfg: GPTConfig

    @nn.compact
    def __call__(self, x, attention_mask, deterministic: bool):
        cfg = self.cfg
        attn = GPTSelfAttention(cfg, name="attention")(
            nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                         name="attention_norm")(x),
            attention_mask, deterministic)
        x = x + attn

        inner_features = cfg.intermediate_size // cfg.tp_size
        y = _enter_tp(cfg, nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                        dtype=cfg.dtype, name="ffn_norm")(x))
        if cfg.gelu_bits:
            from fewbit_tpu.modules.fused import FusedDenseActivation

            inner = FusedDenseActivation(
                features=inner_features, activation="gelu",
                bits=cfg.gelu_bits, dtype=cfg.dtype,
                proj_dim_ratio=cfg.proj_dim_ratio, matmul=cfg.sketch,
                name="intermediate")(y)
        else:
            inner = _dense(cfg, inner_features, "intermediate")(y)
            inner = jax.nn.gelu(inner, approximate=False)
        if cfg.tp_axis is None:
            out = _dense(cfg, cfg.hidden_size, "ffn_output")(inner)
        else:
            out = _dense(cfg, cfg.hidden_size, "ffn_output",
                         use_bias=False)(inner)
            out = tp_sum(out, cfg.tp_axis)
            out = out + self.param("ffn_bias", nn.initializers.zeros,
                                   (cfg.hidden_size,), cfg.dtype)
        out = nn.Dropout(cfg.hidden_dropout)(out,
                                             deterministic=deterministic)
        return x + out


class _ScanGPTBlock(GPTBlock):

    @nn.compact
    def __call__(self, x, attention_mask, deterministic: bool):
        return super().__call__(x, attention_mask, deterministic), None


class GPTModel(nn.Module):
    """Decoder backbone; with ``logits=True`` the (optionally tied) LM head
    is applied inside, so weight tying uses flax's ``Embed.attend``."""
    cfg: GPTConfig

    @nn.compact
    def __call__(self, input_ids, attention_mask=None,
                 deterministic: bool = True, logits: bool = False):
        cfg = self.cfg
        s = input_ids.shape[-1]
        if s > cfg.max_position_embeddings:
            # Without this check nn.Embed's gather would silently clamp
            # out-of-range position ids to the last learned position.
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        embed = nn.Embed(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                         name="word_embeddings")
        positions = nn.Embed(cfg.max_position_embeddings, cfg.hidden_size,
                             dtype=cfg.dtype,
                             name="position_embeddings")(jnp.arange(s))
        x = embed(input_ids) + positions[None, :, :]
        x = nn.Dropout(cfg.hidden_dropout)(x, deterministic=deterministic)
        if cfg.scan_layers:
            scanned = nn.scan(
                _ScanGPTBlock,
                variable_axes={"params": 0},
                split_rngs={"params": True, "dropout": True, "sketch": True},
                in_axes=(nn.broadcast, nn.broadcast),
                length=cfg.num_layers,
                metadata_params={nn.PARTITION_NAME: None},
            )
            x, _ = scanned(cfg, name="layers")(x, attention_mask,
                                               deterministic)
        else:
            for i in range(cfg.num_layers):
                x = GPTBlock(cfg, name=f"layer_{i}")(x, attention_mask,
                                                     deterministic)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                         name="final_norm")(x)
        if not logits:
            return x
        if cfg.tie_lm_head:
            return embed.attend(x)
        return _dense(cfg, cfg.vocab_size, "lm_head", use_bias=False)(x)


class GPTForCausalLM(nn.Module):
    cfg: GPTConfig

    @nn.compact
    def __call__(self, input_ids, attention_mask=None,
                 deterministic: bool = True):
        return GPTModel(self.cfg, name="transformer")(
            input_ids, attention_mask, deterministic, logits=True)
