"""tools/timing.py — the shared micro-benchmark protocol, pinned on the
CPU so a protocol change cannot silently skew its consumers."""

import jax.numpy as jnp
import numpy as np

from tools.timing import timed_loop, touch


def test_timed_loop_runs_body_and_returns_positive_seconds():
    calls = []

    def body(i, c):
        calls.append(1)  # traced once per jit, not per iteration
        return touch(c, c + 1.0)

    x = jnp.zeros((8, 128), jnp.float32)
    t = timed_loop(body, x, iters=4, rounds=2)
    assert t > 0.0
    # the body is traced (not re-executed in Python) — one trace total
    assert len(calls) == 1


def test_touch_is_shape_preserving_and_near_noop():
    c = jnp.ones((16, 8), jnp.float32)
    v = jnp.full((16, 8), 7.0, jnp.float32)
    out = touch(c, v)
    assert out.shape == c.shape and out.dtype == c.dtype
    # only the [0, 0] element changes, and only by ~1e-6 * v
    np.testing.assert_allclose(np.asarray(out)[1:], np.asarray(c)[1:])
    assert abs(float(out[0, 0]) - 7e-6) < 1e-9
