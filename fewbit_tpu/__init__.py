"""fewbit-tpu: a few-bit backward-pass engine for JAX.

Memory-efficient training primitives with the capabilities of the reference
CUDA/PyTorch library (skolai/fewbit):

* **Few-bit activations** — every activation function is a ``jax.custom_vjp``
  whose backward residual is a dense bitpacked code tensor (``bits`` bits per
  element instead of 32); one codec (:mod:`fewbit_tpu.ops.codec`) computes
  the codes and applies the stepwise derivative.
* **Randomized linear layers** — ``x @ W^T + b`` whose VJP saves only a random
  sketch of the input (projection along the batch axis) plus the PRNG key
  needed to re-materialise the matching sketch of the output gradient.
* **Offline quantizer** — Lloyd-style and DP-exact solvers producing the
  stepwise derivative LUTs, with a CLI.
* **Models and training** — RoBERTa in plain JAX, a training loop, data- and
  tensor-parallel steps over device meshes, memory introspection.

The flax module surface (``fewbit_tpu.modules``, model surgery, the GPT and
MLP models) needs flax and loads on first use.
"""

import importlib

from fewbit_tpu import functional  # noqa: F401
from fewbit_tpu.approx import Stepwise, approximate, dp_quantize  # noqa: F401
from fewbit_tpu.lut import StepwiseStore, store  # noqa: F401
from fewbit_tpu.util import (  # noqa: F401
    estimate_memory_usage, memory_delta_bytes, peak_memory_bytes,
    residual_shapes)

__version__ = "0.1.0"

# Names that need flax, resolved on first access.
_FLAX_SURFACE = {
    "fewbit_tpu.util": ("convert_linear", "map_module"),
    "fewbit_tpu.modules": (
        "CELU", "DenseCRS", "ELU", "FewBitFFN", "FusedDenseActivation",
        "GELU", "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
        "LeakyReLU", "LinearCRS", "LinearGRP", "LogSigmoid", "Mish",
        "RandomizedDense", "RandomizedLinear", "ReLU", "ReLU6", "SELU",
        "SiLU", "Sigmoid", "Softplus", "Softshrink", "Softsign", "Tanh",
        "Tanhshrink", "Threshold", "VarianceEstimator",
        "VarianceEstimatorState"),
}


def __getattr__(name):
    for module, names in _FLAX_SURFACE.items():
        if name in names:
            return getattr(importlib.import_module(module), name)
    raise AttributeError(f"module 'fewbit_tpu' has no attribute {name!r}")
