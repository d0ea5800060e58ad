"""Linear layers with memory-efficient sketched weight gradients.

``linear_grp`` (Gaussian/structured Random Projection) computes the exact
forward ``y = x @ W^T + b`` but its VJP saves only a random *sketch* of the
input — a ``(proj_dim, in_features)`` projection along the flattened batch
axis — instead of the full ``(batch*seq, in_features)`` activation.  The
backward pass re-materialises the *same* projection of the output gradient
and estimates ``grad_W = (P g)^T (P x) / normalisation``, which is unbiased
because ``E[P^T P / c] = I``.

Functional randomness: the shared forward/backward projection comes from
an explicit ``jax.random`` key saved in the residual (a few bytes), replacing
the reference's save-and-restore of a mutable ``torch.Generator`` state blob
(``/root/reference/fewbit/functional/linear.py:100-105,158-160``).  Under
``pjit``/``shard_map`` the key is folded with the shard index so every
data-parallel shard draws an independent projection.

Sketch types (reference parity: ``functional/linear.py:113-148``):

* ``gaussian`` — dense N(0,1) projection, scaled ``1/k``;
* ``rademacher`` — dense ±0.5 projection, scaled ``4/k``;
* ``dct`` / ``dft`` — orthonormal transform along the batch axis + uniform
  row subsampling with replacement, scaled ``N/k``.  (The reference scales
  these by ``k*N``, which makes the estimator biased by ``k^2``; its test
  suite only exercises the gaussian path, ``modules/linear_test.py:95-104``.
  The ``N/k`` factor here is the unbiased one — verified by the Monte-Carlo
  tests in ``tests/test_linear.py``.)
* ``srht`` — subsampled randomized Hadamard transform (random signs +
  Kronecker-factored Walsh-Hadamard as two matmuls + row subsampling) —
  net-new relative to the reference; real-valued, no FFT needed.
* ``countsketch`` — signed bucket sum over a fixed stride partition; one
  O(N d) memory pass, no matmul FLOPs.  The recommended kind.

``linear_crs`` implements column-row sampling: backward keeps ``nopairs``
input *feature columns* sampled uniformly with replacement
(reference: ``functional/linear.py:27-66``), with the static-shape JAX
formulation (duplicates kept and scatter-added) replacing the dynamic
``bincount``/``nonzero`` shapes that XLA cannot compile.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from fewbit_tpu.fft import dct, fwht

__all__ = ("linear", "linear_crs", "linear_grp", "linear_grp_native",
           "linear_randomized", "calc_proj_dim")

MATMUL_KINDS = ("gaussian", "rademacher", "dct", "dft", "countsketch",
                "srht")


_FALLBACK_WARNING = (
    "{owner}: no 'sketch' RNG was provided; falling back to a constant key. "
    "Every training step will reuse the SAME random sketch signs, so the "
    "weight-gradient noise is perfectly correlated across steps and will "
    "not average out.  Pass rngs={{'sketch': key}} (fresh per step) when "
    "training; this fallback is only safe for inference.  Set "
    "FEWBIT_TPU_STRICT_SKETCH=1 to make this an error.")


def fallback_sketch_key(owner: str, stacklevel: int = 3) -> jax.Array:
    """The constant sketch key for callers that were given no sketch RNG.

    The sketched weight-gradient estimators are unbiased only over fresh
    random signs, so this warns (or, under ``FEWBIT_TPU_STRICT_SKETCH=1``,
    raises): inference without RNGs must still work — the sketch only
    affects gradients — but training this way would freeze the sketch.  The
    reference hides the same hazard inside an optional ``generator``
    argument (``/root/reference/fewbit/modules/linear.py:58-76``)."""
    msg = _FALLBACK_WARNING.format(owner=owner)
    if os.environ.get("FEWBIT_TPU_STRICT_SKETCH") == "1":
        raise RuntimeError(msg)
    warnings.warn(msg, stacklevel=stacklevel)
    return jax.random.key(0)


def calc_proj_dim(ndim: int,
                  proj_dim_ratio: Optional[float] = None,
                  proj_dim: Optional[int] = None,
                  proj_dim_max: Optional[int] = None,
                  proj_dim_min: Optional[int] = None) -> int:
    """Resolve the sketch dimension from ratio/exact/min/max settings."""
    if proj_dim:
        result = proj_dim
    elif proj_dim_ratio:
        result = int(proj_dim_ratio * ndim)
    else:
        result = ndim
    if proj_dim_min:
        result = max(proj_dim_min, result)
    if proj_dim_max:
        result = min(proj_dim_max, result)
    return max(result, 1)


def linear(x: jax.Array, weight: jax.Array,
           bias: Optional[jax.Array] = None) -> jax.Array:
    """Exact ``x @ W^T + b`` with torch-style ``(out, in)`` weight."""
    y = jnp.einsum("...i,oi->...o", x, weight)
    if bias is not None:
        y = y + bias
    return y


@dataclasses.dataclass(frozen=True)
class _GRPConfig:
    proj_features: int
    matmul: str
    has_bias: bool


def _int_zero_cot(a: jax.Array):
    # Cotangent convention for integer-typed primal inputs (PRNG keys).
    return np.zeros(a.shape, dtype=jax.dtypes.float0)


def _dot_acc_f32(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b`` with operand-dtype promotion and an f32 accumulator —
    the sketch-contraction matmul (bf16 sketches use the bf16 tensor cores;
    the accumulation error stays f32-bounded)."""
    dt = jnp.promote_types(a.dtype, b.dtype)
    return jax.lax.dot_general(a.astype(dt), b.astype(dt),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def sketch_dtype(dtype) -> jnp.dtype:
    """Storage dtype for countsketch residuals, keyed on the MODEL dtype.

    bf16 models store bf16 sketches: the sketched weight-gradient estimator
    carries sampling variance ~ ||x||^2 ||g||^2 / k_eff, orders of magnitude
    above bf16's 2^-8 rounding, so the cast costs no accuracy while it
    halves the residual memory and the sketch's memory traffic.  f32 models
    keep f32 sketches.  Accumulation stays f32.
    """
    return (jnp.bfloat16.dtype if jnp.dtype(dtype) == jnp.bfloat16.dtype
            else jnp.float32.dtype)


def _countsketch_partition(n: int, k: int):
    """Pick an exact stride partition for the countsketch.

    Returns ``(block, k_eff)`` with ``block * k_eff == n`` and ``k_eff >= k``
    (never *less* accurate than requested), or ``None`` when no exact
    partition exists within a 2x bucket budget.  An exact partition lets the
    bucket reduction lower to one ``reshape(block, k_eff, d).sum(0)``
    instead of a slice plus a folded tail; a bucket count that is a multiple
    of 8 keeps the reshape aligned.
    """
    if k >= n:
        return 1, n
    for block in range(n // k, 0, -1):
        if n % block:
            continue
        k_eff = n // block
        if k_eff > 2 * k:
            return None
        if k_eff % 8 == 0 or block == 1:
            return block, k_eff
    return None


def _countsketch_signed(mat: jax.Array, sigma: jax.Array, k_eff: int,
                        out_dtype=None) -> jax.Array:
    """Signed bucket sum with bucket = row % k_eff — the stride partition
    shared by every countsketch, so the forward and backward sketches
    contract bucket-for-bucket against each other.

    Storage follows :func:`sketch_dtype`; accumulation is f32."""
    n, d = mat.shape
    if out_dtype is None:
        out_dtype = sketch_dtype(mat.dtype)
    out_dtype = jnp.dtype(out_dtype)
    signed = mat.astype(out_dtype) * sigma.astype(out_dtype)[:, None]
    if k_eff >= n:
        return signed
    block = n // k_eff
    main = signed[:block * k_eff].reshape(block, k_eff, d).sum(
        axis=0, dtype=jnp.float32)
    rem = n - block * k_eff
    if rem:
        main = main.at[:rem].add(signed[block * k_eff:].astype(jnp.float32))
    return main.astype(out_dtype)


def _dense_proj_chunks(n: int, k: int) -> int:
    """Row-chunk size for dense projections: the transient (k, chunk)
    projection block is generated on the fly and freed chunk by chunk, so
    peak memory stays ~32 MiB instead of the reference's full (k, N) matrix
    (859 MiB at batch 64 x seq 512, ratio 0.2)."""
    target = (32 << 20) // (4 * max(k, 1))
    return max(256, min(n, target))


def _dense_sketch(key: jax.Array, mat: jax.Array, k: int, rademacher: bool,
                  scale) -> jax.Array:
    n, d = mat.shape
    chunk = _dense_proj_chunks(n, k)
    acc = jnp.zeros((k, d), dtype=mat.dtype)
    start, idx = 0, 0
    while start < n:
        size = min(chunk, n - start)
        ck = jax.random.fold_in(key, idx)
        if rademacher:
            block = jax.random.bernoulli(ck, 0.5, (k, size)).astype(
                mat.dtype) - 0.5
        else:
            block = jax.random.normal(ck, (k, size), dtype=mat.dtype)
        acc = acc + block @ mat[start:start + size]
        start += size
        idx += 1
    return acc * scale if scale != 1.0 else acc


def _sketch(cfg: _GRPConfig, key: jax.Array, mat: jax.Array,
            normalise: bool) -> jax.Array:
    """Project ``mat`` of shape (N, d) down to (k, d) along the batch axis.

    ``normalise=True`` applies the unbiasedness factor (forward/input side);
    the gradient side uses the raw projection so that the product of the two
    carries the factor exactly once.  The chunking is keyed by ``fold_in``
    counters, so forward and backward re-derive identical projections from
    the shared key regardless of feature width.
    """
    n = mat.shape[0]
    k = cfg.proj_features
    if cfg.matmul == "gaussian":
        return _dense_sketch(key, mat, k, False,
                             1.0 / k if normalise else 1.0)
    if cfg.matmul == "rademacher":
        return _dense_sketch(key, mat, k, True,
                             4.0 / k if normalise else 1.0)
    if cfg.matmul == "countsketch":
        # Count sketch with random signs over a fixed strided partition:
        # row j lands in bucket j mod k with sign sigma_j.  Unbiasedness of
        # the gradient estimator needs only sign independence
        # (E[sigma_i sigma_j] = delta_ij makes every cross term vanish for
        # ANY fixed partition), so no permutation gather is needed and the
        # whole projection is one fused multiply + reshape-sum — a single
        # O(N d) memory pass instead of the O(k N d) FLOPs of a dense
        # sketch.  The stride-k partition also mixes tokens from different
        # sequence positions into each bucket.  The recommended kind.
        signs = (jax.random.bernoulli(key, 0.5, (n,)).astype(mat.dtype)
                 * 2.0 - 1.0)
        part = _countsketch_partition(n, k)
        k_eff = part[1] if part is not None else k
        return _countsketch_signed(mat, signs, k_eff)
    if cfg.matmul == "srht":
        # Subsampled Randomized Hadamard Transform: rows of H_orth D mat,
        # D = random signs, H the Kronecker-factored Walsh-Hadamard (two
        # matmuls — see fewbit_tpu.fft.fwht).  Unlike plain dct-row-sampling
        # the sign randomisation D makes the estimator robust to coherent
        # inputs.
        # Unbiasedness: E[S^T S] = (k/n_p) I under uniform row sampling with
        # replacement, and D H^T H D = I, so scaling by n_p/k gives
        # E[(P g)^T (P x) * n_p/k] = g^T x.
        sign_key = jax.random.fold_in(key, 0)
        row_key = jax.random.fold_in(key, 1)
        n_p = 1 << (max(n - 1, 1)).bit_length()
        signs = (jax.random.bernoulli(sign_key, 0.5, (n,)).astype(mat.dtype)
                 * 2.0 - 1.0)
        signed = mat * signs[:, None]
        if n_p != n:
            signed = jnp.pad(signed, ((0, n_p - n), (0, 0)))
        transformed = fwht(signed, norm="ortho")
        rows = jax.random.randint(row_key, (k,), 0, n_p)
        out = jnp.take(transformed, rows, axis=0)
        return out * (n_p / k) if normalise else out
    if cfg.matmul == "dct":
        rows = jax.random.randint(key, (k,), 0, n)
        transformed = dct(mat, type=2, axis=0, norm="ortho")
        out = jnp.take(transformed, rows, axis=0)
        return out * (n / k) if normalise else out
    if cfg.matmul == "dft":
        rows = jax.random.randint(key, (k,), 0, n)
        if normalise:
            transformed = jnp.fft.fft(mat, axis=0, norm="ortho")
            return jnp.take(transformed, rows, axis=0) * (n / k)
        # Gradient side: conjugate spectrum so that sum_r conj(Fg)_r (Fx)_r
        # recovers g^T x by Parseval.
        transformed = jnp.fft.ifft(mat, axis=0, norm="ortho")
        return jnp.take(transformed, rows, axis=0)
    raise ValueError(f"unknown matmul kind: {cfg.matmul!r}")


def _cs_signs(key: jax.Array, n: int, dtype) -> jax.Array:
    # The SAME sign draw the jnp countsketch in _sketch uses — forward and
    # backward projections must share it for the estimator to be unbiased.
    return jax.random.bernoulli(key, 0.5, (n,)).astype(dtype) * 2.0 - 1.0


# Core VJP in natural (in, out) weight orientation — every matmul in
# forward and backward runs without a threaded transpose (the torch-style
# (out, in) public API transposes once at the boundary and AD transposes the
# gradient back for free).
@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _linear_grp_core(cfg: _GRPConfig, x, kernel, bias, key):
    y = jnp.einsum("...i,io->...o", x, kernel)
    if bias is not None:
        y = y + bias
    return y


def _linear_grp_core_fwd(cfg, x, kernel, bias, key):
    y = _linear_grp_core(cfg, x, kernel, bias, key)
    sketch = _sketch(cfg, key, x.reshape(-1, x.shape[-1]), normalise=True)
    return y, (sketch, kernel, key)


def _linear_grp_core_bwd(cfg, residual, g):
    sketch, kernel, key = residual
    g2 = g.reshape(-1, g.shape[-1])
    if cfg.matmul == "countsketch":
        # The backward contracts AGAINST the forward's sketch, so its bucket
        # partition is whatever the forward stored: read k_eff off the
        # residual's static shape.
        k_eff = sketch.shape[0]
        sigma = _cs_signs(key, g2.shape[0], jnp.float32)
        grad_x = (g2 @ kernel.T).reshape(*g.shape[:-1], kernel.shape[0])
        g_proj = _countsketch_signed(g2, sigma, k_eff)
        grad_k = _dot_acc_f32(sketch.T, g_proj).astype(kernel.dtype)
        grad_b = g2.sum(axis=0) if cfg.has_bias else None
        return grad_x.astype(g.dtype), grad_k, grad_b, _int_zero_cot(key)
    grad_x = (g2 @ kernel.T).reshape(*g.shape[:-1], kernel.shape[0])
    g_proj = _sketch(cfg, key, g2, normalise=False)
    grad_k = sketch.T @ g_proj
    if jnp.iscomplexobj(grad_k):
        grad_k = jnp.real(grad_k)
    grad_k = grad_k.astype(kernel.dtype)
    grad_b = g2.sum(axis=0) if cfg.has_bias else None
    return grad_x.astype(g.dtype), grad_k, grad_b, _int_zero_cot(key)


_linear_grp_core.defvjp(_linear_grp_core_fwd, _linear_grp_core_bwd)


def linear_grp_native(x: jax.Array,
                      kernel: jax.Array,
                      bias: Optional[jax.Array],
                      key: jax.Array,
                      proj_dim_ratio: Optional[float] = None,
                      proj_dim: Optional[int] = None,
                      proj_dim_max: Optional[int] = None,
                      proj_dim_min: Optional[int] = None,
                      matmul: str = "gaussian") -> jax.Array:
    """:func:`linear_grp` with a flax-orientation ``(in, out)`` kernel —
    the preferred entry for modules (no boundary transposes)."""
    cfg = _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max,
                        proj_dim_min, matmul, bias)
    return _linear_grp_core(cfg, x, kernel, bias, key)


def _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max, proj_dim_min,
                  matmul, bias) -> _GRPConfig:
    if proj_dim_ratio is None and proj_dim is None:
        raise ValueError("either proj_dim or proj_dim_ratio must be given")
    if proj_dim_min is not None and proj_dim_min <= 0:
        raise ValueError("proj_dim_min must be strictly positive")
    if (proj_dim_min is not None and proj_dim_max is not None
            and proj_dim_max < proj_dim_min):
        raise ValueError("proj_dim_min must not exceed proj_dim_max")
    if matmul not in MATMUL_KINDS:
        raise ValueError(
            f"unknown matmul kind {matmul!r}; expected one of {MATMUL_KINDS}")
    ndim = int(np.prod(x.shape[:-1]))
    k = calc_proj_dim(ndim, proj_dim_ratio, proj_dim, proj_dim_max,
                      proj_dim_min)
    return _GRPConfig(proj_features=k, matmul=matmul,
                      has_bias=bias is not None)


def linear_grp(x: jax.Array,
               weight: jax.Array,
               bias: Optional[jax.Array],
               key: jax.Array,
               proj_dim_ratio: Optional[float] = None,
               proj_dim: Optional[int] = None,
               proj_dim_max: Optional[int] = None,
               proj_dim_min: Optional[int] = None,
               matmul: str = "gaussian") -> jax.Array:
    """Exact linear forward with a sketched weight-gradient backward.

    :param x: input, shape ``(..., in_features)``.
    :param weight: torch-convention weight, shape ``(out, in)``.
    :param bias: optional ``(out,)`` bias.
    :param key: ``jax.random`` key shared (via the residual) between the
        forward sketch and the backward gradient projection.
    """
    cfg = _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max,
                        proj_dim_min, matmul, bias)
    return _linear_grp_core(cfg, x, weight.T, bias, key)


linear_randomized = linear_grp  # Prettier alias (reference parity).


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _linear_crs(cfg, x, weight, bias, key):
    return linear(x, weight, bias)


def _linear_crs_fwd(cfg, x, weight, bias, key):
    nopairs, _ = cfg
    y = linear(x, weight, bias)
    in_features = weight.shape[-1]
    cols = jax.random.randint(key, (nopairs,), 0, in_features)
    x2 = x.reshape(-1, in_features)
    # Keep duplicates; each sampled column is scaled by 1/(p * nopairs) with
    # p = 1/in_features, applied once on the input side.
    x_cols = jnp.take(x2, cols, axis=1) * (in_features / nopairs)
    return y, (x_cols, cols, weight, key)


def _linear_crs_bwd(cfg, residual, g):
    _, has_bias = cfg
    x_cols, cols, weight, key = residual
    g2 = g.reshape(-1, g.shape[-1])
    grad_x = (g2 @ weight).reshape(*g.shape[:-1], weight.shape[-1])
    outer = g2.T @ x_cols  # (out, nopairs)
    grad_w = jnp.zeros_like(weight).at[:, cols].add(outer)
    grad_b = g2.sum(axis=0) if has_bias else None
    return grad_x.astype(g.dtype), grad_w, grad_b, _int_zero_cot(key)


_linear_crs.defvjp(_linear_crs_fwd, _linear_crs_bwd)


def linear_crs(x: jax.Array,
               weight: jax.Array,
               bias: Optional[jax.Array],
               key: jax.Array,
               nopairs: int) -> jax.Array:
    """Exact linear forward; backward keeps only ``nopairs`` sampled input
    feature columns (column-row sampling) for the weight gradient."""
    if nopairs <= 0:
        raise ValueError("nopairs must be positive")
    return _linear_crs((int(nopairs), bias is not None), x, weight, bias, key)
