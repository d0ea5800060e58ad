"""Models.  RoBERTa is plain JAX; GPT and the MLP are flax modules and load
on first use (they need flax)."""

import importlib

from fewbit_tpu.models.roberta import (  # noqa: F401
    RobertaConfig, RobertaForSequenceClassification, RobertaModel)

_FLAX_MODELS = {"GPTConfig": "gpt", "GPTForCausalLM": "gpt",
                "GPTModel": "gpt", "MLP": "mlp"}


def __getattr__(name):
    if name in _FLAX_MODELS:
        module = importlib.import_module(
            f"fewbit_tpu.models.{_FLAX_MODELS[name]}")
        return getattr(module, name)
    raise AttributeError(
        f"module 'fewbit_tpu.models' has no attribute {name!r}")
