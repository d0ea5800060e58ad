"""Real 2-process ``jax.distributed.initialize`` smoke test (SURVEY §2.3).

Every other multi-host artifact in this repo simulates host partitions
inside one process; this test finally executes the actual bootstrap path
(``parallel/distributed.py:init_distributed`` ->
``jax.distributed.initialize``) by spawning two CPU worker processes, each
with 4 virtual devices, wired through a localhost coordinator — the same
env-var recipe a real pod slice uses.  Asserts:

* both workers see the global 8-device cluster (4 local each);
* a fewbit data-parallel train step runs over the cross-process mesh
  (its gradient pmean is a REAL cross-process collective);
* both workers observe identical losses (replicated outputs agree);
* the losses match the same computation on a single-process 8-device mesh
  with a simulated 2-host partition — layout equivalence, not just liveness.

Skips with the worker's reason when the CPU backend refuses cross-process
collectives.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = Path(__file__).parent / "_mp_worker.py"
REPO = Path(__file__).parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(port: int, pid: int) -> subprocess.Popen:
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "FEWBIT_COORDINATOR": f"127.0.0.1:{port}",
        "FEWBIT_NUM_PROCESSES": "2",
        "FEWBIT_PROCESS_ID": str(pid),
        "PYTHONPATH": str(REPO),
    })
    return subprocess.Popen(
        [sys.executable, str(WORKER)], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_distributed_train_step():
    port = _free_port()
    procs = [_launch(port, pid) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process workers did not finish within 420s")

    for rc, out, err in outs:
        skip = next((l for l in out.splitlines() if l.startswith("SKIP:")),
                    None)
        if rc == 42 and skip:
            pytest.skip(skip[5:])
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"

    results = []
    for rc, out, err in outs:
        line = next(l for l in out.splitlines() if l.startswith("{"))
        results.append(json.loads(line))

    by_pid = {r["process_id"]: r for r in results}
    assert set(by_pid) == {0, 1}
    for r in results:
        assert r["num_processes"] == 2
        assert r["global_devices"] == 8
        assert r["local_devices"] == 4
        assert r["mesh_shape"] == {"dp": 8, "tp": 1}

    # Replicated metrics must agree bit-for-bit across the two processes.
    np.testing.assert_array_equal(by_pid[0]["losses"], by_pid[1]["losses"])

    # Layout equivalence: the same two steps on THIS process's 8 virtual
    # devices with a simulated 2-host partition (the mesh construction all
    # other tests use) must produce the same losses.
    import jax

    if jax.device_count() < 8 or jax.default_backend() != "cpu":
        pytest.skip("parent process lacks the 8-device CPU mesh")

    from fewbit_tpu.models import (RobertaConfig,
                                   RobertaForSequenceClassification)
    from fewbit_tpu.parallel import make_pod_mesh
    from fewbit_tpu.parallel.mesh import (data_parallel_step, replicate,
                                          shard_batch)
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_train_step, synthetic_glue)

    cfg = RobertaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                        num_heads=2, intermediate_size=64,
                        max_position_embeddings=66, num_labels=2,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        gelu_bits=3, proj_dim_ratio=0.5)
    model = RobertaForSequenceClassification(cfg)
    batch_np = next(synthetic_glue(16, seq_len=16, vocab_size=cfg.vocab_size))
    mesh = make_pod_mesh(tp=1, hosts=2)
    state = create_train_state(
        model, TrainConfig(total_steps=4, learning_rate=1e-4), batch_np)
    state = replicate(state, mesh)
    batch = shard_batch(batch_np, mesh)
    step = data_parallel_step(make_train_step(model, dp_axis="dp"), mesh,
                              donate_state=False)
    ref_losses = []
    for i in range(2):
        state, metrics = step(state, batch, jax.random.key(i))
        ref_losses.append(float(np.asarray(metrics["loss"])))

    np.testing.assert_allclose(by_pid[0]["losses"], ref_losses,
                               rtol=2e-5, atol=1e-6)
