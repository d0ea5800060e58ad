"""chip_smoke.py off the card: it refuses to run without a GPU or without
the rest of the repository, and its helpers and phases are right at tiny
sizes on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=66)


def _run(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (json.JSONDecodeError, TypeError):
            continue
    return False


def test_fails_without_a_gpu():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "no GPU" in proc.stdout + proc.stderr


def test_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


@pytest.mark.parametrize("dtype,bits", [(np.float32, np.int32),
                                        (jnp.bfloat16, np.int16)])
def test_ulp_diff(dtype, bits):
    a = np.asarray([1.0, -2.0, 0.0, 3.5], dtype)
    assert cs.ulp_diff(a, a) == 0
    up = (np.asarray(a).view(bits) + 1).view(a.dtype)
    assert cs.ulp_diff(a[:2], up[:2]) == 1
    # +0 and the smallest negative number are one step apart.
    tiny_neg = np.asarray([0x80000001 if bits is np.int32 else 0x8001],
                          np.int64).astype(bits).view(a.dtype)
    assert cs.ulp_diff(np.zeros(1, a.dtype), tiny_neg) == 1
    with pytest.raises(ValueError):
        cs.ulp_diff(a, a[:2])


def test_rel_l2_and_bytes():
    assert cs.rel_l2(np.ones(4), np.ones(4)) == 0.0
    assert cs.rel_l2(np.zeros(3), np.zeros(3)) == 0.0
    assert abs(cs.rel_l2(np.asarray([3.0, 4.0]), np.asarray([0.0, 5.0]))
               - np.sqrt(9 + 1) / 5) < 1e-12
    # f32, 3 bits: read 4 + write 4 bytes per element + 3/8 packed.
    assert cs.codec_bytes(64, 4, 3) == 64 * 8 + 3 * 4 * 2


def test_codec_phase_interpreted():
    rows = cs.phase_codec(shape=(64, 128), interpret=True, timed=False)
    assert len(rows) == 10
    assert all(r["ok"] and r["y_ulp"] == 0 for r in rows)


def test_whole_ffn_params_keep_the_weights():
    from fewbit_tpu.models import RobertaForSequenceClassification

    vanilla = RobertaForSequenceClassification(
        cs._config("vanilla-f32", **TINY)).init(jax.random.key(0))["params"]
    fewbit = RobertaForSequenceClassification(
        cs._config("fewbit-f32", **TINY)).init(jax.random.key(0))["params"]
    moved = cs.whole_ffn_params(vanilla)
    assert (jax.tree.structure(moved) == jax.tree.structure(fewbit))
    np.testing.assert_array_equal(
        moved["roberta"]["layers"]["ffn"]["up_kernel"],
        vanilla["roberta"]["layers"]["intermediate"]["kernel"])


def test_reference_phase_on_two_cpu_devices():
    out = cs.phase_reference(batch_size=4, seq=16, grad_batch=2,
                             overrides=TINY, devices=jax.devices()[:2])
    assert out["logits_f32_max_rel"] <= cs.TOL["logits_f32"][0]
    assert out["grad_worst_rel_l2"] <= cs.TOL["grad_rel_l2"][0]


def test_four_phase_on_four_cpu_devices():
    """The dp2 x tp2 step against one device: losses and parameters agree,
    the schedule overlaps collectives, the sketched config steps."""
    out = cs.phase_four(batch_size=4, seq=16, overrides=TINY,
                        devices=jax.devices()[:4])
    assert out["param_worst_rel_l2"] <= cs.TOL["four_rtol"][0]
    assert out["collectives"]["all-reduce"] > 0
    assert all(np.isfinite(out["sketched_losses"]))
