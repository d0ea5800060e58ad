"""Dense + few-bit activation as one op: the memory-lean FFN prefix.

``fewbit_dense_act(x, w, b) = act(x @ w + b)`` as one ``custom_vjp``:

* **forward**: the matmul (XLA's, on the vendor library), then the codec
  (:func:`fewbit_tpu.ops.codec.forward`) computes the activation and packs
  the interval codes of the pre-activation ``z``;
* **residuals**: packed codes (``bits/8`` B per element of ``z``), the
  weight, and either the exact input or — with a sketch configured — only a
  ``(k, K)`` random sketch of it;
* **backward**: ``dz = g * levels[codes]`` (:func:`fewbit_tpu.ops.codec.
  backward`), then ``dx = dz @ w^T`` and ``dw = sketch(x)^T``-paired
  estimate (or exact ``x^T dz``), ``db = sum(dz)``.

Where a vanilla dense+gelu saves the full pre-activation (or recomputes it
from a saved input), this op's extra storage for the whole block is
``bits``/32 of one activation tensor plus an optional small sketch.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from fewbit_tpu.functional.activations import resolve_activation
from fewbit_tpu.functional.linear import (MATMUL_KINDS, _GRPConfig,
                                          _int_zero_cot, _sketch,
                                          calc_proj_dim)
from fewbit_tpu.ops import codec

__all__ = ("fewbit_dense_act",)


@dataclasses.dataclass(frozen=True)
class _FusedConfig:
    spec: object              # ActivationSpec (hashable dataclass)
    grp: Optional[_GRPConfig]  # weight-grad sketch; None = exact
    has_bias: bool


def _plain_forward(cfg, x2, w, b):
    z = x2 @ w
    if b is not None:
        z = z + b
    return z


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _fused(cfg: _FusedConfig, x, w, b, key, borders, levels):
    x2 = x.reshape(-1, x.shape[-1])
    z = _plain_forward(cfg, x2, w, b)
    y = cfg.spec.fwd(z, cfg.spec.args)
    return y.reshape(*x.shape[:-1], w.shape[-1]).astype(x.dtype)


def _fused_fwd(cfg, x, w, b, key, borders, levels):
    spec = cfg.spec
    x2 = x.reshape(-1, x.shape[-1])
    m = w.shape[-1]

    z = _plain_forward(cfg, x2, w, b)
    y2, packed = codec.forward(spec, z, borders)
    y2 = y2.astype(x.dtype)

    x_saved = (_sketch(cfg.grp, key, x2, normalise=True)
               if cfg.grp is not None else x2)
    y = y2.reshape(*x.shape[:-1], m)
    return y, (packed, x_saved, w, key, levels)


def _fused_bwd(cfg, residual, g):
    spec = cfg.spec
    packed, x_saved, w, key, levels = residual
    m = w.shape[-1]
    g2 = g.reshape(-1, m)

    dz = codec.backward(spec, packed, levels, g2)

    dx = (dz @ w.T).reshape(*g.shape[:-1], w.shape[0]).astype(g.dtype)
    if cfg.grp is not None:
        dz_proj = _sketch(cfg.grp, key, dz, normalise=False)
        dw = x_saved.T @ dz_proj
        if jnp.iscomplexobj(dw):
            dw = jnp.real(dw)
    else:
        dw = x_saved.T @ dz
    dw = dw.astype(w.dtype)
    db = dz.sum(axis=0) if cfg.has_bias else None
    zeros = (jnp.zeros((spec.n_borders,), jnp.float32),
             jnp.zeros_like(levels))
    return (dx, dw, db, _int_zero_cot(key)) + zeros


_fused.defvjp(_fused_fwd, _fused_bwd)


def fewbit_dense_act(x: jax.Array,
                     w: jax.Array,
                     b: Optional[jax.Array] = None,
                     key: Optional[jax.Array] = None,
                     activation: str = "gelu",
                     bits: Optional[int] = None,
                     act_args: tuple = (),
                     borders=None,
                     values=None,
                     proj_dim_ratio: Optional[float] = None,
                     proj_dim: Optional[int] = None,
                     proj_dim_min: Optional[int] = None,
                     proj_dim_max: Optional[int] = None,
                     matmul: str = "countsketch") -> jax.Array:
    """``act(x @ w + b)`` with few-bit activation residuals and (optionally)
    a sketched weight gradient.

    :param x: ``(..., K)`` input.
    :param w: ``(K, M)`` weight (flax kernel orientation).
    :param key: PRNG key for the sketch (required when a ``proj_dim*``
        setting is given).
    :param activation: continuous name (gelu, silu, ...) or a 1-bit
        piecewise name (relu, hardtanh, ...).
    """
    spec, b_arr, v_arr = resolve_activation(activation, bits=bits,
                                            borders=borders, values=values,
                                            args=act_args)
    grp = None
    if proj_dim_ratio is not None or proj_dim is not None:
        if key is None:
            raise ValueError("a PRNG key is required for sketched gradients")
        if matmul not in MATMUL_KINDS:
            raise ValueError(f"unknown matmul kind {matmul!r}")
        ndim = int(np.prod(x.shape[:-1]))
        k = calc_proj_dim(ndim, proj_dim_ratio, proj_dim, proj_dim_max,
                          proj_dim_min)
        grp = _GRPConfig(proj_features=k, matmul=matmul, has_bias=False)
    if key is None:
        key = jax.random.key(0)
    cfg = _FusedConfig(spec=spec, grp=grp, has_bias=b is not None)
    return _fused(cfg, x, w, b, key, b_arr, v_arr)
