"""Tensor-parallel (dp x tp) training over a 2-D mesh.

Megatron-style TP for the RoBERTa family: attention heads and the FFN inner
dimension split over the ``tp`` mesh axis (column-parallel up projections,
row-parallel down projections with one psum per block — see
``models/roberta.py``), composed with the data-parallel batch sharding from
:mod:`fewbit_tpu.parallel.mesh`.  Everything runs inside one ``shard_map``:

* sharded parameters (q/k/v/intermediate kernels + their biases along the
  output dim; output/ffn_output kernels along the input dim) carry a ``tp``
  PartitionSpec entry; all other state is replicated;
* the model marks where activations enter and leave the tp region with
  :func:`tp_copy` (identity forward, psum backward: the input of a
  column-parallel layer gathers its partial input gradients) and
  :func:`tp_sum` (psum forward, identity backward: the partial products of
  a row-parallel layer), Megatron's ``f`` and ``g``;
* gradients are ``pmean``-ed over ``dp`` only — replicated parameters see
  identical gradients on every tp rank (the loss itself is tp-replicated),
  sharded parameters own their slice;
* the bitpacked few-bit residuals shard over *both* axes: batch via dp and
  the FFN feature dim via tp.

Net-new capability relative to the reference, which is single-device
(SURVEY.md §2.3).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import numpy as np

__all__ = ("make_dp_tp_mesh", "tp_param_spec", "state_specs",
           "init_dp_tp_state", "dp_tp_train_step", "tp_copy", "tp_sum")


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def tp_copy(x: jax.Array, axis: str) -> jax.Array:
    """Identity forward, psum over ``axis`` backward (Megatron's ``f``)."""
    return x


def _tp_copy_fwd(x, axis):
    return x, None


def _tp_copy_bwd(axis, _, g):
    return (lax.psum(g, axis),)


tp_copy.defvjp(_tp_copy_fwd, _tp_copy_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tp_sum(x, axis):
    return lax.psum(x, axis)


def _tp_sum_fwd(x, axis):
    return lax.psum(x, axis), None


def _tp_sum_bwd(axis, _, g):
    return (g,)


_tp_sum.defvjp(_tp_sum_fwd, _tp_sum_bwd)


def tp_sum(x: jax.Array, axis: str) -> jax.Array:
    """psum over ``axis`` forward, identity backward (Megatron's ``g``): the
    cotangent of the replicated sum is already each rank's cotangent.
    Identity when traced outside shard_map (abstract initialisation)."""
    try:
        return _tp_sum(x, axis)
    except NameError:
        return x

# Parameter-name rules: (last-path-component of the owning module, leaf name)
# -> which axis of the *unstacked* parameter is tp-sharded (None = replicated)
_COLUMN_MODULES = ("query", "key", "value", "intermediate")
_ROW_MODULES = ("output", "ffn_output")
# The whole-FFN op keeps both projections under one name.
_FFN_COLUMN = ("up_kernel", "up_bias")
_FFN_ROW = ("down_kernel",)


def make_dp_tp_mesh(dp: int, tp: int, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if dp * tp > len(devices):
        raise ValueError(f"dp*tp={dp*tp} exceeds {len(devices)} devices")
    arr = np.asarray(devices[:dp * tp]).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def tp_param_spec(path: Tuple, leaf) -> P:
    """PartitionSpec for one parameter leaf, from its tree path."""
    names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
    module = names[-2] if len(names) >= 2 else ""
    leaf_name = names[-1]
    rank = len(leaf.shape)
    spec = [None] * rank
    if module in _COLUMN_MODULES:
        if leaf_name == "kernel":
            spec[-1] = "tp"          # (..., in, out_local)
        elif leaf_name == "bias":
            spec[-1] = "tp"          # (..., out_local)
    elif module in _ROW_MODULES and leaf_name == "kernel":
        spec[-2] = "tp"              # (..., in_local, out)
    elif module == "ffn" and leaf_name in _FFN_COLUMN:
        spec[-1] = "tp"
    elif module == "ffn" and leaf_name in _FFN_ROW:
        spec[-2] = "tp"
    return P(*spec)


def state_specs(state) -> object:
    """Spec pytree for a TrainState: parameters by rule, optimizer moments
    mirror their parameters, scalars replicated."""
    param_specs = jax.tree_util.tree_map_with_path(tp_param_spec,
                                                   state.params)

    def like_params(tree):
        # optax adamw state contains mu/nu trees shaped like params plus
        # scalar counts; map matching subtrees, replicate the rest.
        def map_leaf_with_path(path, leaf):
            if hasattr(leaf, "shape") and leaf.ndim >= 1:
                return tp_param_spec(path, leaf)
            return P()

        return jax.tree_util.tree_map_with_path(map_leaf_with_path, tree)

    return state.replace(
        step=P(),
        params=param_specs,
        opt_state=like_params(state.opt_state),
        apply_fn=state.apply_fn,
        tx=state.tx,
    )


def init_dp_tp_state(model, train_cfg, batch, mesh: Mesh, seed: int = 0):
    """Initialise a TrainState sharded over the mesh.

    Sharded leaves draw from a tp-rank-folded key (independent slices of one
    random global weight); replicated leaves draw from the shared key so all
    tp ranks agree bit-for-bit.
    """
    from fewbit_tpu.train.loop import TrainState, make_optimizer

    tx = make_optimizer(train_cfg)

    def build(key):
        params = model.init(
            {"params": key, "dropout": key, "sketch": key},
            batch["input_ids"], batch.get("attention_mask"),
            deterministic=True)["params"]
        return TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    base_key = jax.random.key(seed)
    template = jax.eval_shape(build, base_key)
    specs = state_specs(template)

    def init_fn(batch_shard):
        tp_idx = lax.axis_index("tp")
        shared = build(base_key)
        folded = build(jax.random.fold_in(base_key, tp_idx + 1))

        def select(path, a, b):
            spec = tp_param_spec(path, a)
            return b if any(s == "tp" for s in spec) else a

        params = jax.tree_util.tree_map_with_path(
            select, shared.params, folded.params)
        return shared.replace(params=params)

    shard_init = shard_map(
        init_fn, mesh=mesh, in_specs=(P("dp"),),
        out_specs=specs, check_vma=False)
    return jax.jit(shard_init)(batch["input_ids"]), specs


def dp_tp_train_step(step_fn, mesh: Mesh, specs) -> callable:
    """Lift ``step_fn(state, batch, key) -> (state, metrics)`` (built with
    ``make_train_step(model, dp_axis='dp')`` on a tp-configured model) onto
    the dp x tp mesh."""
    sharded = shard_map(
        step_fn, mesh=mesh,
        in_specs=(specs, P("dp"), P()),
        out_specs=(specs, P()),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,))
