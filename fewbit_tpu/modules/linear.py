"""Flax linen linear layers with sketched weight gradients.

``RandomizedDense`` (aliases ``LinearGRP``, ``RandomizedLinear``) is a
drop-in for ``flax.linen.Dense`` whose VJP stores a random projection of the
input instead of the input itself; ``DenseCRS`` (alias ``LinearCRS``) stores
sampled input feature columns.  Reference surface:
``/root/reference/fewbit/modules/linear.py`` (whose ``LinearCRS.__init__``
mis-passes ``proj_dim`` as the ``bias`` flag and whose ``extra_repr`` reads a
nonexistent attribute — both deliberately not reproduced).

Randomness: each call pulls a fresh key from the ``'sketch'`` RNG collection
when one is provided at ``apply`` (training); without one the layer falls
back to a constant key WITH a warning — inference still works (the sketch
only affects gradients), but training that way would freeze the sketch
signs (see :mod:`fewbit_tpu.modules._rng`).
"""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from fewbit_tpu.functional.linear import linear_crs, linear_grp_native
from fewbit_tpu.modules._rng import sketch_key

__all__ = ("RandomizedDense", "LinearGRP", "RandomizedLinear", "DenseCRS",
           "LinearCRS")


class _SketchedBase(nn.Module):
    features: int
    use_bias: bool = True
    dtype: Optional[jnp.dtype] = None
    param_dtype: jnp.dtype = jnp.float32
    kernel_init: nn.initializers.Initializer = nn.initializers.lecun_normal()
    bias_init: nn.initializers.Initializer = nn.initializers.zeros_init()

    def _params(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        kernel = kernel.astype(dtype)
        bias = bias.astype(dtype) if bias is not None else None
        return x, kernel, bias

    def _key(self):
        return sketch_key(self)


class RandomizedDense(_SketchedBase):
    """Dense layer whose weight gradient uses a randomized sketch.

    :param proj_dim_ratio: sketch size as a fraction of the flattened batch.
    :param proj_dim: exact sketch size (overrides the ratio).
    :param proj_dim_min: lower clamp on the sketch size.
    :param proj_dim_max: upper clamp on the sketch size.
    :param matmul: ``'gaussian' | 'rademacher' | 'dct' | 'dft' |
        'countsketch' | 'srht'`` (countsketch is the recommended kind).
    """
    proj_dim_ratio: Optional[float] = None
    proj_dim: Optional[int] = None
    proj_dim_min: Optional[int] = None
    proj_dim_max: Optional[int] = None
    matmul: str = "gaussian"

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x, kernel, bias = self._params(x)
        # Natural (in, out) kernel orientation end to end — no boundary
        # transposes threading through forward/backward/residuals.
        return linear_grp_native(x, kernel, bias, self._key(),
                                 proj_dim_ratio=self.proj_dim_ratio,
                                 proj_dim=self.proj_dim,
                                 proj_dim_max=self.proj_dim_max,
                                 proj_dim_min=self.proj_dim_min,
                                 matmul=self.matmul)


class DenseCRS(_SketchedBase):
    """Dense layer whose weight gradient uses column-row sampling."""
    nopairs: Optional[int] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x, kernel, bias = self._params(x)
        nopairs = self.nopairs or max(self.features // 2, 1)
        return linear_crs(x, kernel.T, bias, self._key(), nopairs)


LinearGRP = RandomizedDense
RandomizedLinear = RandomizedDense
LinearCRS = DenseCRS
