"""Dense bit-plane layout for few-bit activation codes.

The reference library packs codes into a dense byte stream with a CUDA
warp-shuffle butterfly (8 elements -> ``bits`` bytes, block aligned;
``/root/reference/fewbit/cuda/codec.cu:142-220``).  Here the layout is a
**bit-plane transpose** of 32-bit words, which plain XLA ops and a GPU
kernel both build with shifts and sums alone:

* the flat code vector (values in ``[0, 2**bits)``) is viewed as a
  ``(32, n // 32)`` matrix (C order);
* plane ``b`` of the packed output is the uint32 word obtained by OR-ing bit
  ``b`` of the 32 codes in each column, shifted by the row index:
  ``word[b, j] = OR_i ((code[i, j] >> b) & 1) << i``.

Properties:

* exactly ``bits`` bits per element — same density as the reference stream
  codec (``fp32 -> bits/8`` bytes per element);
* pack and unpack are pure shift/or/sum operations, fully vectorised — the
  per-plane OR across 32 disjoint bit positions is a plain integer ``sum``
  over the leading axis, and no gathers or byte shuffles are ever needed;
* each row of the ``(32, m)`` view is a contiguous run of the input, so a
  kernel reads it coalesced and keeps each column's words in registers;
* the group size 32 divides every realistic activation shape (the reference's
  group of 8 had the same role, ``cuda/codec.h:4-6``).

The functions here are the pure-``jnp`` reference implementation; the
Triton forward kernel in :mod:`fewbit_tpu.ops.codec` produces bit-identical
buffers, so a residual from either path decodes in the other.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = (
    "GROUP",
    "pack_codes",
    "unpack_codes",
    "packed_num_words",
    "packed_nbytes",
)

# Number of elements whose codes share one uint32 word per plane.
GROUP = 32


def packed_num_words(n: int, bits: int) -> int:
    """Number of uint32 words per plane for ``n`` elements."""
    return -(-n // GROUP)


def packed_nbytes(n: int, bits: int) -> int:
    """Total packed residual size in bytes for ``n`` elements."""
    return packed_num_words(n, bits) * bits * 4


def _row_shift(m: int) -> jax.Array:
    # Row index of the (GROUP, m) code matrix, used as the bit position of
    # each element inside its plane word.
    return jax.lax.broadcasted_iota(jnp.uint32, (GROUP, m), 0)


def pack_codes(codes: jax.Array, bits: int) -> jax.Array:
    """Pack a flat integer code vector into ``(bits, ceil(n/32))`` uint32.

    ``codes`` must be 1-D with values in ``[0, 2**bits)``.  A ragged tail is
    zero-padded (the consumer is expected to drop the corresponding decoded
    elements, which :func:`unpack_codes` does via its ``n`` argument).
    """
    if codes.ndim != 1:
        raise ValueError(f"pack_codes expects a flat vector, got {codes.shape}")
    n = codes.shape[0]
    m = packed_num_words(n, bits)
    c = codes.astype(jnp.uint32)
    if n != m * GROUP:
        c = jnp.pad(c, (0, m * GROUP - n))
    c = c.reshape(GROUP, m)
    shift = _row_shift(m)
    planes = []
    for b in range(bits):
        plane = (c >> b) & jnp.uint32(1)
        # The 32 shifted single-bit rows occupy disjoint bit positions, so an
        # integer sum over the leading axis is exactly the bitwise OR.
        planes.append(jnp.sum(plane << shift, axis=0, dtype=jnp.uint32))
    return jnp.stack(planes, axis=0)


def unpack_codes(packed: jax.Array, bits: int, n: int) -> jax.Array:
    """Inverse of :func:`pack_codes`: recover the first ``n`` codes."""
    if packed.ndim != 2 or packed.shape[0] != bits:
        raise ValueError(
            f"expected packed shape (bits={bits}, m), got {packed.shape}")
    m = packed.shape[1]
    shift = _row_shift(m)
    c = jnp.zeros((GROUP, m), dtype=jnp.uint32)
    for b in range(bits):
        bit = (packed[b][None, :] >> shift) & jnp.uint32(1)
        c = c | (bit << jnp.uint32(b))
    return c.reshape(-1)[:n]
