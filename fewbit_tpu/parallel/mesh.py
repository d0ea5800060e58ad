"""Device mesh + data-parallel training.

Net-new relative to the reference, which is strictly single-device (SURVEY.md
§2.3): training scales over a ``jax.sharding.Mesh`` with ``shard_map`` —
batches sharded along the ``dp`` axis, parameters replicated, gradients
``pmean``-ed by XLA collectives (NCCL on GPUs).

Key design point for the few-bit engine: the bitpacked residual codes are
*produced inside* the shard-mapped step from the local activation shard, so
they inherit the batch sharding for free and no resharding ever happens
between forward and backward.  Sketch randomness folds the ``dp`` axis index
into the key so every shard draws an independent projection (the
functional replacement for per-device torch Generator state).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np

import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

__all__ = ("make_mesh", "shard_batch", "replicate", "data_parallel_step",
           "fold_shard_key")


def make_mesh(dp: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``dp`` devices (all by default)."""
    devices = list(devices if devices is not None else jax.devices())
    dp = dp or len(devices)
    if dp > len(devices):
        raise ValueError(f"requested dp={dp} but only {len(devices)} devices")
    return Mesh(np.asarray(devices[:dp]), axis_names=("dp",))


def shard_batch(batch, mesh: Mesh):
    """Place a pytree of arrays batch-sharded along the dp axis."""
    sharding = NamedSharding(mesh, P("dp"))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), batch)


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def fold_shard_key(key: jax.Array, axis: str = "dp") -> jax.Array:
    """Per-shard independent key (call inside shard_map/pjit)."""
    return jax.random.fold_in(key, lax.axis_index(axis))


def data_parallel_step(step_fn: Callable, mesh: Mesh,
                       donate_state: bool = True) -> Callable:
    """Lift ``step_fn(state, batch, key) -> (state, metrics)`` to the mesh.

    ``step_fn`` runs per shard on the local batch; it must already
    ``lax.pmean`` its gradients/metrics over ``'dp'`` (the helpers in
    :mod:`fewbit_tpu.train.loop` do).  State is replicated, the batch is
    sharded along its leading axis, the key is folded per shard.
    """
    sharded = shard_map(
        step_fn, mesh=mesh,
        in_specs=(P(), P("dp"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded, donate_argnums=(0,) if donate_state else ())
