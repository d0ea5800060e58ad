"""DCT-II/DCT-III for JAX via a single complex FFT (Makhoul's method).

Used as the structured orthonormal transform behind the ``dct`` sketch of
:func:`fewbit_tpu.functional.linear.linear_grp`.  Follows scipy's
``scipy.fft.dct`` conventions for ``type`` and ``norm`` (the test suite
checks against scipy directly).  Capability parity with the reference's
torch implementation (``/root/reference/fewbit/fft.py``), re-derived from
Makhoul (1980), "A Fast Cosine Transform in One and Two Dimensions".

Core identities (calibrated numerically against scipy):

* ``dct2_backward(x)_k = 2 Re(e^{-i pi k / 2N} FFT(P x)_k)`` where ``P`` is
  the even-indices-then-reversed-odds permutation;
* its exact inverse ``idct2_backward(y)``: build
  ``V_k = (y_k - i y_{N-k}) e^{i pi k / 2N} / 2`` (with ``y_N := 0``),
  inverse-FFT, undo the permutation;
* ``dct3_backward = 2N * idct2_backward``; ortho norms rescale entry 0 by
  ``1/(2 sqrt(N))`` and the rest by ``1/sqrt(2N)``.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ("dct", "idct", "fwht")


def _hadamard(n: int) -> np.ndarray:
    """Sylvester-construction Hadamard matrix, n a power of two."""
    h = np.ones((1, 1), dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def fwht(x: jnp.ndarray, norm: str = "ortho") -> jnp.ndarray:
    """Walsh-Hadamard transform along axis 0 (rows); power-of-two length.

    Instead of log2(N) sequential butterfly stages (N reshapes), the
    transform factors as a Kronecker product ``H_N = H_a (x) H_b`` with
    ``a*b = N`` — two *matmuls* with small constant Hadamard matrices that
    run on the matrix units:
    ``(H_N X).reshape(a,b,d) = H_a @ (X.reshape(a,b,d) @_b H_b)``.
    This is the structured transform behind the ``srht`` sketch — a
    real-valued alternative to the reference's complex-FFT ``dft`` sketch
    (``/root/reference/fewbit/functional/linear.py:130-148``).
    """
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"fwht length must be a power of two, got {n}")
    log2 = n.bit_length() - 1
    a = 1 << (log2 // 2)
    b = n // a
    ha = jnp.asarray(_hadamard(a), dtype=x.dtype)
    hb = jnp.asarray(_hadamard(b), dtype=x.dtype)
    tail = x.shape[1:]
    y = x.reshape((a, b) + tail)
    y = jnp.einsum("bq,aq...->ab...", hb, y)
    y = jnp.einsum("ap,pb...->ab...", ha, y)
    y = y.reshape((n,) + tail)
    if norm == "ortho":
        return y * (1.0 / np.sqrt(n))
    if norm == "backward":
        return y
    raise ValueError(f"unknown norm: {norm!r}")


def _ortho_scale(n: int) -> np.ndarray:
    s = np.full((n,), 1.0 / np.sqrt(2.0 * n))
    s[0] = 1.0 / (2.0 * np.sqrt(n))
    return s


def _dct2_backward(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[-1]
    v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]], axis=-1)
    fv = jnp.fft.fft(v, axis=-1)
    k = np.arange(n)
    twiddle = jnp.asarray(np.exp(-0.5j * np.pi * k / n))
    return 2.0 * jnp.real(fv * twiddle)


def _idct2_backward(y: jnp.ndarray) -> jnp.ndarray:
    n = y.shape[-1]
    k = np.arange(n)
    tail = jnp.concatenate(
        [jnp.zeros_like(y[..., :1]), y[..., :0:-1]], axis=-1)
    twiddle = jnp.asarray(np.exp(0.5j * np.pi * k / n))
    v = jnp.fft.ifft((y - 1j * tail) * twiddle * 0.5, axis=-1)
    nhalf = (n + 1) // 2
    out = jnp.zeros(y.shape, dtype=v.real.dtype)
    out = out.at[..., 0::2].set(jnp.real(v[..., :nhalf]))
    out = out.at[..., 1::2].set(jnp.real(v[..., nhalf:][..., ::-1]))
    return out


def _dct_last(x: jnp.ndarray, type: int, norm: str) -> jnp.ndarray:
    n = x.shape[-1]
    if type == 2:
        y = _dct2_backward(x)
        if norm == "backward":
            return y
        if norm == "forward":
            return y / (2.0 * n)
        if norm == "ortho":
            return y * jnp.asarray(_ortho_scale(n))
    elif type == 3:
        if norm == "backward":
            return 2.0 * n * _idct2_backward(x)
        if norm == "forward":
            return _idct2_backward(x)
        if norm == "ortho":
            return _idct2_backward(x / jnp.asarray(_ortho_scale(n)))
    else:
        raise ValueError(f"unsupported DCT type: {type}")
    raise ValueError(f"unknown norm: {norm!r}")


def dct(x: jnp.ndarray, type: int = 2, axis: int = -1,
        norm: str = "backward") -> jnp.ndarray:
    """Discrete cosine transform (types 2 and 3), scipy conventions."""
    x = jnp.moveaxis(x, axis, -1)
    y = _dct_last(x, type, norm).astype(x.dtype)
    return jnp.moveaxis(y, -1, axis)


def idct(x: jnp.ndarray, type: int = 2, axis: int = -1,
         norm: str = "backward") -> jnp.ndarray:
    """Inverse DCT, scipy conventions: ``idct(dct(x, t, norm), t, norm) == x``."""
    inverse_type = {2: 3, 3: 2}[type]
    inverse_norm = {"backward": "forward", "forward": "backward",
                    "ortho": "ortho"}[norm]
    return dct(x, inverse_type, axis, inverse_norm)
