"""The whole few-bit FFN block as one op: up projection + few-bit
activation + down projection in one ``custom_vjp``.

The transformer FFN pair is where both of the reference's techniques meet
(its experiments patch the FFN GELU *and* convert the FFN linears,
``/root/reference/notebooks/few-bit-backward/exp-fine-tuning-glue.py:272-303``,
``notebooks/randomized-backward/exp-fine-tuning-glue.py:200-210``).  As one
op, no ``(N, M)`` tensor of the block survives the forward pass:

* **forward**: ``y = act(x @ w_up + b_up)`` through the codec
  (:func:`fewbit_tpu.ops.codec.forward`), which also packs the few-bit
  codes of the pre-activation; then ``countsketch(x)`` and
  ``countsketch(y)``, the residuals of the two weight gradients;
* **backward**: ``dz = levels[codes] * (g @ w_down^T)``
  (:func:`fewbit_tpu.ops.codec.backward`), ``countsketch(dz)`` for the up
  projection's weight gradient, and ``db_up = sum dz``.

The matrix products are XLA's (the vendor library's on a GPU).

Residuals for the whole block: ``countsketch(x)``, packed codes
(``bits/8`` B per pre-activation element), ``countsketch(y)``, and the two
weights.

Weight-gradient estimators (unbiased; see ``tests/test_ffn.py``):
``dW_up = sk(x)^T sk(dz)`` with the up key's signs, ``dW_down =
sk(y)^T sk(g)`` with the down key's signs.  The stride-partition countsketch
``P`` satisfies ``E[P^T P] = I`` exactly (sign independence makes every
cross term vanish), so no normalisation factor is needed.  Both sides of
each estimator share one sign vector derived from the op's PRNG key — the
functional replacement for the reference's generator-state save/restore
(``/root/reference/fewbit/functional/linear.py:100-105,158-160``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from fewbit_tpu.functional.activations import resolve_activation
from fewbit_tpu.functional.linear import (_countsketch_partition,
                                          _countsketch_signed,
                                          _dot_acc_f32 as _dot_f32,
                                          _int_zero_cot, calc_proj_dim,
                                          sketch_dtype)
from fewbit_tpu.ops import codec

__all__ = ("fewbit_ffn",)


@dataclasses.dataclass(frozen=True)
class _FFNConfig:
    spec: object      # ActivationSpec
    k_proj: int       # requested sketch dimension
    has_b_up: bool
    has_b_down: bool


def _signs(key: jax.Array, n: int) -> jax.Array:
    return jax.random.bernoulli(key, 0.5, (n,)).astype(jnp.float32) * 2.0 - 1


def _keff(n: int, k: int) -> int:
    """Bucket count of the stride-partition countsketch."""
    part = _countsketch_partition(n, k)
    return part[1] if part is not None else min(k, n)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _ffn(cfg: _FFNConfig, x, w_up, b_up, w_down, b_down, key, borders,
         levels):
    x2 = x.reshape(-1, x.shape[-1])
    z = _dot_f32(x2, w_up)
    if b_up is not None:
        z = z + b_up
    y = cfg.spec.fwd(z, cfg.spec.args).astype(x.dtype)
    out = _dot_f32(y, w_down.astype(y.dtype))
    if b_down is not None:
        out = out + b_down
    return out.reshape(*x.shape[:-1], w_down.shape[-1]).astype(x.dtype)


def _ffn_fwd(cfg, x, w_up, b_up, w_down, b_down, key, borders, levels):
    spec = cfg.spec
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    h = w_down.shape[-1]
    key_up = jax.random.fold_in(key, 0)
    key_down = jax.random.fold_in(key, 1)
    sig_up = _signs(key_up, n)
    sig_down = _signs(key_down, n)
    k_eff = _keff(n, cfg.k_proj)

    z = _dot_f32(x2, w_up)
    if b_up is not None:
        z = z + b_up
    y2, packed = codec.forward(spec, z, borders)
    y2 = y2.astype(x.dtype)
    sk_y = _countsketch_signed(y2, sig_down, k_eff)
    sk_x = _countsketch_signed(x2, sig_up, k_eff)

    out = _dot_f32(y2, w_down.astype(y2.dtype))
    if b_down is not None:
        out = out + b_down
    out = out.reshape(*x.shape[:-1], h).astype(x.dtype)
    return out, (packed, sk_x, sk_y, w_up, w_down, key, levels)


def _ffn_bwd(cfg, residual, g):
    spec = cfg.spec
    packed, sk_x, sk_y, w_up, w_down, key, levels = residual
    h = w_down.shape[-1]
    kdim = w_up.shape[0]
    g2 = g.reshape(-1, h)
    n = g2.shape[0]
    key_up = jax.random.fold_in(key, 0)
    key_down = jax.random.fold_in(key, 1)
    sig_up = _signs(key_up, n)
    sig_down = _signs(key_down, n)
    k_eff = sk_x.shape[0]

    db_down = g2.sum(axis=0).astype(g2.dtype) if cfg.has_b_down else None
    sk_g = _countsketch_signed(g2, sig_down, k_eff)
    dw_down = _dot_f32(sk_y.T, sk_g).astype(w_down.dtype)

    # dz32 is f32 whatever the model dtype; sketch storage follows the
    # model dtype (sketch_dtype).
    dz32 = codec.backward(spec, packed, levels,
                          _dot_f32(g2, w_down.T.astype(g2.dtype)))
    sk_dz = _countsketch_signed(dz32, sig_up, k_eff,
                                out_dtype=sketch_dtype(g2.dtype))
    db_up = dz32.sum(axis=0)
    dz = dz32.astype(g2.dtype)

    dw_up = _dot_f32(sk_x.T, sk_dz).astype(w_up.dtype)
    dx = _dot_f32(dz, w_up.T.astype(dz.dtype))
    dx = dx.reshape(*g.shape[:-1], kdim).astype(g.dtype)
    db_up = db_up.astype(w_up.dtype) if cfg.has_b_up else None
    zeros = (jnp.zeros((spec.n_borders,), jnp.float32),
             jnp.zeros_like(levels))
    return (dx, dw_up, db_up, dw_down, db_down,
            _int_zero_cot(key)) + zeros


_ffn.defvjp(_ffn_fwd, _ffn_bwd)


def fewbit_ffn(x: jax.Array,
               w_up: jax.Array,
               b_up: Optional[jax.Array],
               w_down: jax.Array,
               b_down: Optional[jax.Array],
               key: jax.Array,
               activation: str = "gelu",
               bits: Optional[int] = None,
               act_args: tuple = (),
               borders=None,
               values=None,
               proj_dim_ratio: Optional[float] = None,
               proj_dim: Optional[int] = None,
               proj_dim_min: Optional[int] = None,
               proj_dim_max: Optional[int] = None) -> jax.Array:
    """``act(x @ w_up + b_up) @ w_down + b_down`` with few-bit + sketched
    residuals (countsketch) for the whole block.

    :param x: ``(..., K)`` input.
    :param w_up: ``(K, M)`` kernel; :param w_down: ``(M, H)`` kernel (flax
        orientation).
    :param key: PRNG key; both weight-gradient sketches derive their shared
        forward/backward signs from folds of it.
    :param proj_dim_ratio: sketch size as a fraction of the flattened batch
        (the stride partition may round the bucket count UP — never
        down).
    """
    spec, b_arr, v_arr = resolve_activation(activation, bits=bits,
                                            borders=borders, values=values,
                                            args=act_args)
    if proj_dim_ratio is None and proj_dim is None:
        raise ValueError("fewbit_ffn requires proj_dim or proj_dim_ratio; "
                         "use fewbit_dense_act + an exact Dense otherwise")
    ndim = int(np.prod(x.shape[:-1]))
    k = calc_proj_dim(ndim, proj_dim_ratio, proj_dim, proj_dim_max,
                      proj_dim_min)
    cfg = _FFNConfig(spec=spec, k_proj=k, has_b_up=b_up is not None,
                     has_b_down=b_down is not None)
    return _ffn(cfg, x, w_up, b_up, w_down, b_down, key, b_arr, v_arr)
