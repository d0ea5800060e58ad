"""Compute-path primitives: bit-plane layout, codec, activation engine."""

from fewbit_tpu.ops.bitpack import (  # noqa: F401
    GROUP, pack_codes, packed_nbytes, packed_num_words, unpack_codes)
from fewbit_tpu.ops.activations import (  # noqa: F401
    ActivationSpec, apply_lut, fewbit_activation, quantize_codes)
