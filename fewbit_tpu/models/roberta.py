"""RoBERTa-base in plain JAX with swappable few-bit components — the flagship
model (RoBERTa-base MRPC fine-tune with 3-bit GELU + RandomizedLinear; the
reference drives HF RoBERTa through monkey-patching,
``benchmark/bench-roberta.py:118-149`` / ``bench-linear.py:122-152``; here
the compression choices are first-class config).

Architecture follows the published RoBERTa-base (12 layers, hidden 768,
heads 12, FFN 3072, learned positions with the pad-offset quirk).  Two
config switches inject the memory-efficient training path:

* ``gelu_bits`` — FFN activations run through the few-bit engine (packed
  ``bits``/8-byte residuals instead of saved inputs);
* ``proj_dim_ratio`` — every dense layer becomes a randomized one whose VJP
  saves a sketch of its input.

The model is a nested dict of parameters and pure functions over it that
call :mod:`fewbit_tpu.functional` directly; it needs no module library.
``init`` and ``apply`` keep the linen calling convention
(``{"params": ...}`` variables, ``rngs={"dropout": k, "sketch": k}``) and
the linen parameter paths, including the stacked ``layers`` axis of the
scanned encoder, so checkpoints and the tensor-parallel name rules of
:mod:`fewbit_tpu.parallel.tp` carry over.

``dtype`` is the activation dtype; parameters stay float32.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional

import jax
import jax.numpy as jnp

from fewbit_tpu import functional as F
from fewbit_tpu.functional.linear import fallback_sketch_key
from fewbit_tpu.parallel.tp import tp_copy, tp_sum

__all__ = ("RobertaConfig", "RobertaModel", "RobertaForSequenceClassification")


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    num_labels: int = 2
    dtype: Any = jnp.float32
    # Few-bit switches.
    gelu_bits: Optional[int] = None        # None = exact gelu backward
    proj_dim_ratio: Optional[float] = None  # None = exact Dense backward
    sketch: str = "gaussian"
    # Run the encoder as one lax.scan over stacked layer parameters (the
    # layer is traced and compiled once instead of num_layers times).  Set
    # False for per-layer parameter naming.
    scan_layers: bool = True
    # Tensor parallelism (Megatron-style): when ``tp_axis`` names a mesh axis
    # the model expects to run inside shard_map with attention heads and the
    # FFN inner dimension split ``tp_size`` ways — column-parallel up
    # projections, row-parallel down projections with a psum.  Few-bit GELU
    # residuals then shard over the *feature* dimension on top of the batch
    # sharding.  ``num_heads`` / ``intermediate_size`` stay the GLOBAL sizes.
    tp_axis: Optional[str] = None
    tp_size: int = 1
    # FFN structure with gelu_bits set.  True runs the block as one custom
    # VJP op: with a countsketch, the whole FFN (fewbit_ffn, which keeps
    # only sketches of its input and of the activation), otherwise the up
    # projection + activation (fewbit_dense_act).  False keeps a dense
    # layer, the elementwise few-bit GELU and a dense layer, so the down
    # projection saves its full input.
    fused_ffn: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------

_lecun_normal = jax.nn.initializers.lecun_normal()
_embed_init = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal",
                                                   out_axis=0)


def _key(root: jax.Array, name: str) -> jax.Array:
    """A stable per-name subkey (crc32, not Python's salted ``hash``)."""
    return jax.random.fold_in(root, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def _dense_params(key, fan_in: int, features: int, bias: bool = True):
    p = {"kernel": _lecun_normal(key, (fan_in, features), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((features,), jnp.float32)
    return p


def _norm_params(width: int):
    return {"scale": jnp.ones((width,), jnp.float32),
            "bias": jnp.zeros((width,), jnp.float32)}


def _layer_params(cfg: RobertaConfig, key: jax.Array) -> dict:
    h = cfg.hidden_size
    width = cfg.num_heads // cfg.tp_size * cfg.head_dim
    inner = cfg.intermediate_size // cfg.tp_size
    tp = cfg.tp_axis is not None
    attention = {name: _dense_params(_key(key, name), h, width)
                 for name in ("query", "key", "value")}
    attention["output"] = _dense_params(_key(key, "output"), width, h,
                                        bias=not tp)
    if tp:
        attention["output_bias"] = jnp.zeros((h,), jnp.float32)
    p = {"attention": attention,
         "attention_norm": _norm_params(h),
         "output_norm": _norm_params(h)}
    if _whole_ffn(cfg):
        ffn = {"up_kernel": _lecun_normal(_key(key, "up"), (h, inner)),
               "down_kernel": _lecun_normal(_key(key, "down"), (inner, h)),
               "up_bias": jnp.zeros((inner,), jnp.float32)}
        if not tp:
            ffn["down_bias"] = jnp.zeros((h,), jnp.float32)
        p["ffn"] = ffn
    else:
        p["intermediate"] = _dense_params(_key(key, "intermediate"), h,
                                          inner)
        p["ffn_output"] = _dense_params(_key(key, "ffn_output"), inner, h,
                                        bias=not tp)
    if tp:
        p["ffn_bias"] = jnp.zeros((h,), jnp.float32)
    return p


def _encoder_params(cfg: RobertaConfig, key: jax.Array) -> dict:
    h = cfg.hidden_size
    embeddings = {
        "word_embeddings": {"embedding": _embed_init(
            _key(key, "word"), (cfg.vocab_size, h), jnp.float32)},
        "position_embeddings": {"embedding": _embed_init(
            _key(key, "position"), (cfg.max_position_embeddings, h),
            jnp.float32)},
        "token_type_embeddings": {"embedding": _embed_init(
            _key(key, "token_type"), (cfg.type_vocab_size, h),
            jnp.float32)},
        "layer_norm": _norm_params(h),
    }
    layer_keys = jax.random.split(_key(key, "layers"), cfg.num_layers)
    if cfg.scan_layers:
        return {"embeddings": embeddings,
                "layers": jax.vmap(lambda k: _layer_params(cfg, k))(
                    layer_keys)}
    p = {"embeddings": embeddings}
    for i in range(cfg.num_layers):
        p[f"layer_{i}"] = _layer_params(cfg, layer_keys[i])
    return p


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


def _whole_ffn(cfg: RobertaConfig) -> bool:
    return bool(cfg.gelu_bits and cfg.fused_ffn and cfg.proj_dim_ratio
                and cfg.sketch == "countsketch")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _Rngs:
    """Dropout and sketch keys of one call; ``None`` where not given."""
    dropout: Optional[jax.Array]
    sketch: Optional[jax.Array]

    def fold(self, name: str) -> "_Rngs":
        return _Rngs(*(None if k is None else _key(k, name)
                       for k in (self.dropout, self.sketch)))


def _cast(cfg, *arrays):
    return [None if a is None else a.astype(cfg.dtype) for a in arrays]


def _dense(cfg, p, x, rngs: _Rngs, name: str):
    kernel, bias, x = _cast(cfg, p["kernel"], p.get("bias"), x)
    if cfg.proj_dim_ratio:
        return F.linear_grp_native(x, kernel, bias, _sketch_key(rngs, name),
                                   proj_dim_ratio=cfg.proj_dim_ratio,
                                   matmul=cfg.sketch)
    y = jnp.einsum("...i,io->...o", x, kernel)
    return y if bias is None else y + bias


def _sketch_key(rngs: _Rngs, name: str) -> jax.Array:
    if rngs.sketch is None:
        return fallback_sketch_key(f"RobertaConfig.proj_dim_ratio ({name})",
                                   stacklevel=5)
    return _key(rngs.sketch, name)


def _layer_norm(cfg, p, x):
    xf = x.astype(jnp.float32)
    mean = xf.mean(axis=-1, keepdims=True)
    var = jnp.square(xf - mean).mean(axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + cfg.layer_norm_eps)
    return (y * p["scale"] + p["bias"]).astype(cfg.dtype)


def _dropout(rate: float, x, rngs: _Rngs, name: str, deterministic: bool):
    if deterministic or rate == 0.0:
        return x
    if rngs.dropout is None:
        raise ValueError("training with dropout needs rngs={'dropout': key}")
    keep = jax.random.bernoulli(_key(rngs.dropout, name), 1.0 - rate,
                                x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


def _enter_tp(cfg, x):
    """The replicated input of column-parallel layers: its gradient is the
    sum of every rank's partial gradient."""
    return x if cfg.tp_axis is None else tp_copy(x, cfg.tp_axis)


def _row_parallel(cfg, out, bias):
    """Sum the row-parallel partial products, then add the bias once."""
    return tp_sum(out, cfg.tp_axis) + bias.astype(cfg.dtype)


def _attention(cfg, p, x, mask, rngs: _Rngs, deterministic: bool):
    b, s, h = x.shape
    heads = cfg.num_heads // cfg.tp_size  # local heads under TP
    width = heads * cfg.head_dim
    x = _enter_tp(cfg, x)
    with jax.named_scope("qkv_proj"):
        q, k, v = (_dense(cfg, p[n], x, rngs, n).reshape(
            b, s, heads, cfg.head_dim) for n in ("query", "key", "value"))
    with jax.named_scope("attention"):
        logits = jnp.einsum("bqhd,bkhd->bhqk", q * cfg.head_dim ** -0.5, k)
        if mask is not None:
            logits = logits + jnp.where(
                mask[:, None, None, :] > 0, 0.0,
                jnp.finfo(jnp.float32).min).astype(logits.dtype)
        probs = jax.nn.softmax(logits, axis=-1)
        probs = _dropout(cfg.attention_dropout, probs, rngs, "probs",
                         deterministic)
        ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, width)
    with jax.named_scope("out_proj"):
        out = _dense(cfg, p["output"], ctx, rngs, "output")
        if cfg.tp_axis is not None:
            out = _row_parallel(cfg, out, p["output_bias"])
    return _dropout(cfg.hidden_dropout, out, rngs, "attention_out",
                    deterministic)


def _ffn(cfg, p, x, rngs: _Rngs):
    """Column-parallel up projection and few-bit activation on the local
    shard of the FFN inner dim (the packed residual inherits the tp
    feature sharding), then the row-parallel down projection."""
    x = _enter_tp(cfg, x)
    if _whole_ffn(cfg):
        f = p["ffn"]
        up, b_up, down, b_down, xc = _cast(
            cfg, f["up_kernel"], f["up_bias"], f["down_kernel"],
            f.get("down_bias"), x)
        out = F.fewbit_ffn(xc, up, b_up, down, b_down,
                           _sketch_key(rngs, "ffn"), activation="gelu",
                           bits=cfg.gelu_bits,
                           proj_dim_ratio=cfg.proj_dim_ratio)
    else:
        if cfg.gelu_bits and cfg.fused_ffn:
            kernel, bias, xc = _cast(cfg, p["intermediate"]["kernel"],
                                     p["intermediate"]["bias"], x)
            key = (_sketch_key(rngs, "intermediate")
                   if cfg.proj_dim_ratio else None)
            inner = F.fewbit_dense_act(xc, kernel, bias, key,
                                       activation="gelu", bits=cfg.gelu_bits,
                                       proj_dim_ratio=cfg.proj_dim_ratio,
                                       matmul=cfg.sketch)
        else:
            inner = _dense(cfg, p["intermediate"], x, rngs, "intermediate")
            inner = (F.gelu(inner, bits=cfg.gelu_bits) if cfg.gelu_bits
                     else jax.nn.gelu(inner, approximate=False))
        out = _dense(cfg, p["ffn_output"], inner, rngs, "ffn_output")
    if cfg.tp_axis is not None:
        out = _row_parallel(cfg, out, p["ffn_bias"])
    return out


def _layer(cfg, p, x, mask, rngs: _Rngs, deterministic: bool):
    attn = _attention(cfg, p["attention"], x, mask, rngs, deterministic)
    x = _layer_norm(cfg, p["attention_norm"], x + attn)
    with jax.named_scope("ffn"):
        out = _ffn(cfg, p, x, rngs)
    out = _dropout(cfg.hidden_dropout, out, rngs, "ffn_out", deterministic)
    return _layer_norm(cfg, p["output_norm"], x + out)


def _embed(cfg, p, input_ids, token_type_ids, rngs, deterministic):
    # RoBERTa position quirk: positions count from pad_token_id + 1 and
    # padding tokens keep position pad_token_id.
    mask = (input_ids != cfg.pad_token_id).astype(jnp.int32)
    position_ids = jnp.cumsum(mask, axis=-1) * mask + cfg.pad_token_id

    def lookup(name, ids):
        return jnp.take(p[name]["embedding"].astype(cfg.dtype), ids, axis=0)

    x = (lookup("word_embeddings", input_ids)
         + lookup("position_embeddings", position_ids)
         + lookup("token_type_embeddings", token_type_ids))
    x = _layer_norm(cfg, p["layer_norm"], x)
    return _dropout(cfg.hidden_dropout, x, rngs, "embeddings", deterministic)


def _encode(cfg, p, input_ids, mask, token_type_ids, rngs: _Rngs,
            deterministic: bool):
    if token_type_ids is None:
        token_type_ids = jnp.zeros_like(input_ids)
    with jax.named_scope("embeddings"):
        x = _embed(cfg, p["embeddings"], input_ids, token_type_ids,
                   rngs.fold("embeddings"), deterministic)
    layer_rngs = [rngs.fold(f"layer_{i}") for i in range(cfg.num_layers)]
    if not cfg.scan_layers:
        for i in range(cfg.num_layers):
            x = _layer(cfg, p[f"layer_{i}"], x, mask, layer_rngs[i],
                       deterministic)
        return x
    stacked = jax.tree.map(lambda *ks: jnp.stack(ks), *layer_rngs)

    def body(x, xs):
        params, r = xs
        return _layer(cfg, params, x, mask, r, deterministic), None

    x, _ = jax.lax.scan(body, x, (p["layers"], stacked))
    return x


def _root_key(rngs) -> jax.Array:
    return rngs["params"] if isinstance(rngs, dict) else rngs


def _call_rngs(rngs) -> _Rngs:
    rngs = rngs or {}
    return _Rngs(rngs.get("dropout"), rngs.get("sketch"))


class RobertaModel:
    """The encoder: ``init(rngs, input_ids, ...) -> {"params": ...}`` and
    ``apply(variables, input_ids, attention_mask=None, token_type_ids=None,
    deterministic=True, rngs=None)`` -> hidden states ``(b, s, hidden)``."""

    def __init__(self, cfg: RobertaConfig):
        self.cfg = cfg

    def init(self, rngs, input_ids=None, attention_mask=None,
             token_type_ids=None, deterministic: bool = True) -> dict:
        return {"params": _encoder_params(self.cfg, _root_key(rngs))}

    def apply(self, variables, input_ids, attention_mask=None,
              token_type_ids=None, deterministic: bool = True,
              rngs=None) -> jax.Array:
        return _encode(self.cfg, variables["params"], input_ids,
                       attention_mask, token_type_ids, _call_rngs(rngs),
                       deterministic)


class RobertaForSequenceClassification:
    """RoBERTa with the classification head on the ``<s>`` token; the same
    ``init`` / ``apply`` convention as :class:`RobertaModel`, returning
    logits ``(b, num_labels)``."""

    def __init__(self, cfg: RobertaConfig):
        self.cfg = cfg

    def init(self, rngs, input_ids=None, attention_mask=None,
             token_type_ids=None, deterministic: bool = True) -> dict:
        cfg = self.cfg
        key = _root_key(rngs)
        return {"params": {
            "roberta": _encoder_params(cfg, _key(key, "roberta")),
            "head_dense": _dense_params(_key(key, "head_dense"),
                                        cfg.hidden_size, cfg.hidden_size),
            "head_out": _dense_params(_key(key, "head_out"),
                                      cfg.hidden_size, cfg.num_labels),
        }}

    def apply(self, variables, input_ids, attention_mask=None,
              token_type_ids=None, deterministic: bool = True,
              rngs=None) -> jax.Array:
        cfg = self.cfg
        p = variables["params"]
        r = _call_rngs(rngs)
        hidden = _encode(cfg, p["roberta"], input_ids, attention_mask,
                         token_type_ids, r.fold("roberta"), deterministic)
        r = r.fold("head")
        with jax.named_scope("head"):
            x = _dropout(cfg.hidden_dropout, hidden[:, 0, :], r, "cls",
                         deterministic)
            x = jnp.tanh(_dense(cfg, p["head_dense"], x, r, "head_dense"))
            x = _dropout(cfg.hidden_dropout, x, r, "head", deterministic)
            return _dense(cfg, p["head_out"], x, r, "head_out")
