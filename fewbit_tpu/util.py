"""Model surgery and memory introspection.

Surgery: :func:`map_module` rewrites a flax linen module tree (post-order,
with an optional path regex filter) and :func:`convert_linear` swaps a
``nn.Dense`` for a sketched replacement while keeping the parameter tree
structure — because the replacement uses the same ``kernel``/``bias`` names
at the same tree path, existing trained parameters load unchanged.
Reference surface: ``/root/reference/fewbit/util.py:147-208``.

Introspection: where the reference walks torch's autograd graph for saved
tensors (``util.py:20-144``), the JAX equivalents are *exact and static*:
``jax.vjp``'s closure **is** the set of saved residuals, and
``jax.eval_shape`` sizes it without allocating a byte.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import jax
import numpy as np

__all__ = ("map_module", "convert_linear", "residual_shapes",
           "estimate_memory_usage", "memory_delta_bytes",
           "device_memory_stats", "peak_memory_bytes", "profile_trace",
           "compiled_memory_stats", "setup_compile_cache")


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compile cache for an entry-point script.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and nothing else is set.  Otherwise the cache lives at the fixed
    path ``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is
    part of the cache key, so a cache that moves never hits.  The library
    never calls this on import; entry points do.  Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = str(Path(__file__).resolve().parent.parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def _nn():
    import flax.linen as nn

    return nn


# ---------------------------------------------------------------------------
# Surgery.
# ---------------------------------------------------------------------------


def _map_value(value, func, patt, path):
    if isinstance(value, _nn().Module):
        return _map_module(value, func, patt, path)
    if isinstance(value, (list, tuple)):
        mapped = [_map_value(v, func, patt, f"{path}/{i}")
                  for i, v in enumerate(value)]
        if all(a is b for a, b in zip(mapped, value)):
            return value
        return type(value)(mapped)
    if isinstance(value, dict):
        mapped = {k: _map_value(v, func, patt, f"{path}/{k}")
                  for k, v in value.items()}
        if all(mapped[k] is value[k] for k in value):
            return value
        return mapped
    return value


def _map_module(root, func, patt, path):
    updates = {}
    for field in dataclasses.fields(root):
        if field.name in ("parent", "name"):
            continue
        value = getattr(root, field.name)
        mapped = _map_value(value, func, patt, f"{path}/{field.name}")
        if mapped is not value:
            updates[field.name] = mapped
    if updates:
        root = root.clone(**updates)
    if patt.match(path or "/"):
        root = func(root, path or "/")
        if not isinstance(root, _nn().Module):
            raise ValueError("map_module callback must return a Module")
    return root


def map_module(root: "nn.Module",
               func: Callable[["nn.Module", str], "nn.Module"],
               patt: Optional[str] = None) -> "nn.Module":
    """Apply ``func`` to every submodule (post-order) whose tree path matches
    ``patt``; returns a rebuilt module tree (linen modules are immutable).

    Works on setup-style models whose submodules are dataclass fields
    (including lists/tuples/dicts of modules).  Submodules created inline
    inside ``@nn.compact`` bodies are invisible to any tree walk — define
    them as fields to make them rewritable.
    """
    return _map_module(root, func, re.compile(patt or r".*"), "")


def convert_linear(module: "nn.Module", ctor: Callable, **kwargs):
    """Rebuild a ``flax.linen.Dense`` as ``ctor`` (e.g. RandomizedDense),
    preserving its configuration.  Non-Dense modules pass through intact.

    The replacement keeps the ``kernel``/``bias`` parameter names, so an
    existing parameter tree loads into the converted model unchanged.
    """
    if not isinstance(module, _nn().Dense):
        return module
    return ctor(features=module.features,
                use_bias=module.use_bias,
                dtype=module.dtype,
                param_dtype=module.param_dtype,
                kernel_init=module.kernel_init,
                bias_init=module.bias_init,
                name=module.name,
                **kwargs)


# ---------------------------------------------------------------------------
# Introspection.
# ---------------------------------------------------------------------------


def residual_shapes(fn: Callable, *args) -> Iterator[jax.ShapeDtypeStruct]:
    """Shapes/dtypes of every residual the VJP of ``fn`` would save, computed
    abstractly (no device allocation)."""
    _, vjp_struct = jax.eval_shape(lambda *a: jax.vjp(fn, *a), *args)
    yield from jax.tree_util.tree_leaves(vjp_struct)


def estimate_memory_usage(fn: Callable, *args, saved_only: bool = True) -> int:
    """Bytes of backward-pass residual storage for ``fn(*args)``.

    With ``saved_only=False`` the sizes of the inputs and outputs are added
    (the analog of the reference's whole-graph walk).
    """
    total = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                for leaf in residual_shapes(fn, *args))
    if not saved_only:
        out, _ = jax.eval_shape(lambda *a: jax.vjp(fn, *a), *args)
        for leaf in jax.tree_util.tree_leaves((args, out)):
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    return total


def memory_delta_bytes(baseline_fn: Callable, fn: Callable, *args) -> int:
    """Residual-byte difference between two implementations of the same
    computation (e.g. exact vs few-bit activation)."""
    return (estimate_memory_usage(baseline_fn, *args)
            - estimate_memory_usage(fn, *args))


def device_memory_stats(device=None) -> dict:
    """Raw allocator statistics for a device (empty dict if unsupported)."""
    device = device or jax.local_devices()[0]
    stats = device.memory_stats()
    return dict(stats) if stats else {}


def peak_memory_bytes(device=None) -> Optional[int]:
    """Peak bytes in use on ``device`` since process start, if reported."""
    stats = device_memory_stats(device)
    return stats.get("peak_bytes_in_use")


def compiled_memory_stats(fn: Callable, *args, **jit_kwargs) -> dict:
    """Compile ``fn`` for the current backend and report XLA's memory
    analysis (argument/output/temp/alias sizes).  ``temp_size_bytes`` is the
    device scratch of one call — activations and temporaries between forward
    and backward for a training step — the static equivalent of the
    reference's ``max_memory_allocated`` delta measurement
    (``benchmark/benchmark.py:165-188``)."""
    compiled = jax.jit(fn, **jit_kwargs).lower(*args).compile()
    ma = compiled.memory_analysis()
    return {
        "argument_size_bytes": int(ma.argument_size_in_bytes),
        "output_size_bytes": int(ma.output_size_in_bytes),
        "temp_size_bytes": int(ma.temp_size_in_bytes),
        "alias_size_bytes": int(ma.alias_size_in_bytes),
        "generated_code_size_bytes": int(ma.generated_code_size_in_bytes),
    }


class profile_trace:
    """Context manager around ``jax.profiler.trace`` (TensorBoard trace with
    device memory timeline) — the observability hook the reference reaches
    for torch.profiler for (``memory-usage-operation-only.py:47-73``)."""

    def __init__(self, logdir: str):
        self.logdir = str(logdir)

    def __enter__(self):
        jax.profiler.start_trace(self.logdir)
        return self

    def __exit__(self, *exc):
        jax.profiler.stop_trace()
        return False
