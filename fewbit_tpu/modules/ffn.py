"""Flax module for the fully-fused few-bit FFN block."""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp

from fewbit_tpu.functional.ffn import fewbit_ffn
from fewbit_tpu.modules._rng import sketch_key

__all__ = ("FewBitFFN",)


class FewBitFFN(nn.Module):
    """``act(x @ up + b_up) @ down + b_down`` with few-bit activation
    residuals and countsketched weight gradients for both projections,
    as one op (:func:`fewbit_tpu.functional.fewbit_ffn`).

    Parameters live under ``up``/``down`` submodule-style names
    (``up_kernel``, ``up_bias``, ``down_kernel``, ``down_bias``).
    """
    inner_features: int
    out_features: int
    activation: str = "gelu"
    bits: int = 3
    act_args: tuple = ()
    use_bias: bool = True
    use_down_bias: bool = True
    dtype: Optional[jnp.dtype] = None
    param_dtype: jnp.dtype = jnp.float32
    kernel_init: nn.initializers.Initializer = nn.initializers.lecun_normal()
    bias_init: nn.initializers.Initializer = nn.initializers.zeros_init()
    proj_dim_ratio: Optional[float] = None
    proj_dim: Optional[int] = None
    proj_dim_min: Optional[int] = None
    proj_dim_max: Optional[int] = None

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        kdim = x.shape[-1]
        up = self.param("up_kernel", self.kernel_init,
                        (kdim, self.inner_features), self.param_dtype)
        down = self.param("down_kernel", self.kernel_init,
                          (self.inner_features, self.out_features),
                          self.param_dtype)
        b_up = (self.param("up_bias", self.bias_init,
                           (self.inner_features,), self.param_dtype)
                if self.use_bias else None)
        b_down = (self.param("down_bias", self.bias_init,
                             (self.out_features,), self.param_dtype)
                  if self.use_bias and self.use_down_bias else None)
        dtype = self.dtype or x.dtype
        x = x.astype(dtype)
        up = up.astype(dtype)
        down = down.astype(dtype)
        b_up = b_up.astype(dtype) if b_up is not None else None
        b_down = b_down.astype(dtype) if b_down is not None else None
        key = sketch_key(self)
        return fewbit_ffn(
            x, up, b_up, down, b_down, key,
            activation=self.activation, bits=self.bits,
            act_args=self.act_args,
            proj_dim_ratio=self.proj_dim_ratio, proj_dim=self.proj_dim,
            proj_dim_min=self.proj_dim_min, proj_dim_max=self.proj_dim_max)
