"""Codec, float32: every activation x bits x aligned/ragged shape (see
codec_cases)."""

import jax.numpy as jnp
import pytest

from codec_cases import SHAPES, case_id, cases, check


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("case", cases(), ids=case_id)
def test_codec(case, shape):
    check(*case, jnp.float32, shape)
