"""The few-bit codec: one entry pair for every op that stores codes.

* ``forward(spec, z, borders) -> (y, packed)``: the exact activation
  ``y = f(z)`` and the ``bits``-wide interval codes of ``z``, bit-plane
  packed (:mod:`fewbit_tpu.ops.bitpack`);
* ``backward(spec, packed, levels, g) -> dz``: the cotangent times the
  stepwise derivative ``levels[code]``.

The elementwise op (:mod:`fewbit_tpu.ops.activations`), the dense +
activation op (:mod:`fewbit_tpu.functional.fused`) and the whole FFN block
(:mod:`fewbit_tpu.functional.ffn`) call only these two, so the choice of
implementation is made here, once.

The forward has two implementations that write the same packed words: the
plain ``jnp`` path, which XLA compiles for every backend, and a Pallas
kernel on the Triton route, one pass over device memory, which a CUDA
lowering picks (``lax.platform_dependent`` chooses per lowering, so one
process can still run the plain path on its CPU devices).  The backward is
the plain path everywhere: XLA fuses the unpack and the LUT into the ops
that consume ``dz``, which a kernel would have to write out.

The kernel views the flat ``n`` elements as the ``(32, m)`` matrix of the
bit-plane layout (``m = ceil(n / 32)``: element ``i * m + j`` is bit ``i``
of word ``j``).  A program owns ``BLOCK_WORDS`` consecutive words: it walks
the 32 rows of its ``(32, BLOCK_WORDS)`` tile — each row a contiguous run
of the input — writing ``y`` as it goes and keeping the ``bits`` words of
every column in registers, stores the words at the end, and masks the
ragged tail.  The borders are a handful of scalars that each program loads
once.  This is the design of the reference library's CUDA forward (one
kernel: activation, binary search, warp-shuffle pack), with the byte stream
replaced by the bit-plane layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fewbit_tpu.ops.bitpack import GROUP, pack_codes, unpack_codes

__all__ = ("forward", "backward", "plain_forward", "plain_backward",
           "triton_forward", "apply_lut")

# Words (columns of the (32, m) view) per Triton program, and its warps.
BLOCK_WORDS = 512
NUM_WARPS = 4

# Whether the CUDA lowering runs the forward as the Triton kernel.  Set
# from the interleaved train-step A/B on an H100 (PERF.md); chip_smoke.py
# flips it for that A/B.  Not a user option.
_GPU_KERNEL = True


def apply_lut(codes: jax.Array, levels, bits: int) -> jax.Array:
    """``levels[codes]`` as a balanced tree of ``2**bits - 1`` selects, one
    mask per code bit, no gather: no sequential chain of compares, so it
    stays cheap even at the 256 levels of the generic ``stepwise`` op."""
    vals = [levels[k] for k in range(1 << bits)]
    for b in range(bits):
        mask = ((codes >> jnp.uint32(b)) & jnp.uint32(1)).astype(bool)
        vals = [jnp.where(mask, vals[2 * k + 1], vals[2 * k])
                for k in range(len(vals) // 2)]
    return vals[0]


# ---------------------------------------------------------------------------
# Plain path.
# ---------------------------------------------------------------------------


def plain_forward(spec, z: jax.Array, borders: jax.Array):
    y = spec.fwd(z, spec.args)
    codes = spec.codes(z, borders, spec.args)
    return y, pack_codes(codes.reshape(-1), spec.bits)


def plain_backward(spec, packed: jax.Array, levels: jax.Array,
                   g: jax.Array) -> jax.Array:
    codes = unpack_codes(packed, spec.bits, g.size)
    mult = apply_lut(codes, levels, spec.bits).reshape(g.shape)
    return (mult * g.astype(mult.dtype)).astype(g.dtype)


# ---------------------------------------------------------------------------
# Triton kernel.
# ---------------------------------------------------------------------------


class _Scalars:
    """The borders as scalars loaded once per program, indexable like the
    1-D array ``spec.codes`` expects."""

    def __init__(self, ref, n: int):
        self._vals = [ref[k] for k in range(n)]
        self.shape = (n,)

    def __getitem__(self, k):
        return self._vals[k]


def _columns():
    """This program's word indices (columns of the (32, m) view)."""
    return pl.program_id(0) * BLOCK_WORDS + jnp.arange(BLOCK_WORDS,
                                                       dtype=jnp.int32)


def kernel_fwd(spec, x: jax.Array) -> jax.Array:
    """The activation as the kernel computes it: ``spec.fwd_kernel`` when
    the spec has one (a form the Triton route lowers, in XLA's op order and
    dtypes), else ``spec.fwd`` in float32, which the caller rounds once to
    the output dtype.  For float32 inputs both equal the plain path; for a
    bfloat16 chain of several ops XLA rounds after each op, so the plain
    ``y`` may differ from the kernel's in the last bit."""
    if spec.fwd_kernel is not None:
        return spec.fwd_kernel(x, spec.args)
    return spec.fwd(x.astype(jnp.float32), spec.args)


def _forward_kernel(spec, m, n, borders_ref, x_ref, y_ref, packed_ref):
    j = _columns()
    live = j < m
    borders = _Scalars(borders_ref, spec.n_borders)

    # Row i of the (32, m) view is bit i of every word: each thread keeps
    # its columns' words in registers while the 32 rows stream past, so no
    # reduction crosses threads.
    def row(i, words):
        idx = i * m + j
        mask = live & (idx < n)
        x = plgpu.load(x_ref.at[idx], mask=mask, other=0)
        plgpu.store(y_ref.at[idx], kernel_fwd(spec, x).astype(y_ref.dtype),
                    mask=mask)
        # Padding codes are zero, as in pack_codes.
        codes = jnp.where(mask, spec.codes(x, borders, spec.args).astype(
            jnp.uint32), jnp.uint32(0))
        shift = i.astype(jnp.uint32)
        return tuple(w | (((codes >> jnp.uint32(b)) & jnp.uint32(1)) << shift)
                     for b, w in enumerate(words))

    words = lax.fori_loop(0, GROUP, row, (jnp.zeros(
        (BLOCK_WORDS,), jnp.uint32),) * spec.bits)
    for b in range(spec.bits):
        plgpu.store(packed_ref.at[b * m + j], words[b], mask=live)


def _grid(n: int):
    m = -(-n // GROUP)
    return m, (-(-m // BLOCK_WORDS),)


def triton_forward(spec, z: jax.Array, borders: jax.Array, *,
                   interpret: bool = False):
    """One pass: ``y = f(z)`` and the packed codes, as
    :func:`plain_forward`."""
    n = z.size
    m, grid = _grid(n)
    # A zero-length operand cannot be a kernel argument; the 1-bit family
    # never reads it.
    b = borders.astype(jnp.float32) if spec.n_borders else jnp.zeros(
        (1,), jnp.float32)
    y, packed = pl.pallas_call(
        functools.partial(_forward_kernel, spec, m, n),
        grid=grid,
        out_shape=(jax.ShapeDtypeStruct((n,), z.dtype),
                   jax.ShapeDtypeStruct((spec.bits * m,), jnp.uint32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name=f"fewbit_{spec.name}_fwd",
    )(b, z.reshape(-1))
    return y.reshape(z.shape), packed.reshape(spec.bits, m)


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------


def forward(spec, z: jax.Array, borders: jax.Array):
    if not _GPU_KERNEL:
        return plain_forward(spec, z, borders)
    return lax.platform_dependent(
        z, borders, cuda=functools.partial(triton_forward, spec),
        default=functools.partial(plain_forward, spec))


def backward(spec, packed: jax.Array, levels: jax.Array,
             g: jax.Array) -> jax.Array:
    return plain_backward(spec, packed, levels, g)
