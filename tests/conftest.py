"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators by forcing the host
platform to expose 8 virtual devices — the fake-backend story the reference
library never had (see SURVEY.md §4).  Must run before jax is imported.
Tests that need a GPU carry the ``gpu`` marker and decide inside the test
whether one is present.
"""

import functools
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402


@pytest.fixture
def kernel_codec(monkeypatch):
    """Route the codec's forward through the Triton kernel in interpret
    mode, as the CUDA lowering routes it through the compiled kernel."""
    from fewbit_tpu.ops import codec

    monkeypatch.setattr(codec, "forward", functools.partial(
        codec.triton_forward, interpret=True))
    return codec
