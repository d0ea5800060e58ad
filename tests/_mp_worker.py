"""Worker process for the real 2-process ``jax.distributed`` smoke test.

Launched by ``tests/test_multiprocess.py`` with the ``FEWBIT_*`` launch
env vars (the recipe documented in ``fewbit_tpu/parallel/distributed.py``).
Each of the two processes exposes 4 virtual CPU devices, wires up via
``init_distributed()`` (which finally exercises the real
``jax.distributed.initialize`` path), builds the host-major pod mesh, and
runs two data-parallel fewbit train steps on the global 8-device mesh.
Prints one JSON line with the observed cluster shape and per-step losses.

Exits 42 with a ``SKIP:`` line when the CPU backend refuses cross-process
collectives (the parent test skips with that reason).
"""

import json
import os
import sys

# Env must be set before jax import; the parent passes XLA_FLAGS already,
# but be defensive when run by hand.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402


def main() -> int:
    from fewbit_tpu.parallel import init_distributed, make_pod_mesh

    try:
        pid, nproc = init_distributed()
    except Exception as exc:  # noqa: BLE001
        print(f"SKIP:init_distributed failed: {type(exc).__name__}: {exc}")
        return 42
    if nproc != 2:
        print(f"SKIP:expected 2 processes, initialize saw {nproc}")
        return 42

    n_global = jax.device_count()
    n_local = jax.local_device_count()

    import jax.numpy as jnp

    from fewbit_tpu.models import (RobertaConfig,
                                   RobertaForSequenceClassification)
    from fewbit_tpu.parallel.mesh import data_parallel_step
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_train_step, synthetic_glue)

    cfg = RobertaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                        num_heads=2, intermediate_size=64,
                        max_position_embeddings=66, num_labels=2,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        gelu_bits=3, proj_dim_ratio=0.5)
    model = RobertaForSequenceClassification(cfg)
    batch_np = next(synthetic_glue(16, seq_len=16, vocab_size=cfg.vocab_size))

    # Both processes hold the same deterministic global batch; each donates
    # its addressable shards via the callback (index into the global array).
    mesh = make_pod_mesh(tp=1)
    from jax.sharding import NamedSharding, PartitionSpec as P

    def globalize(np_arr, spec):
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            np_arr.shape, sharding, lambda idx: np.asarray(np_arr[idx]))

    batch = {k: globalize(np.asarray(v), P("dp"))
             for k, v in batch_np.items()}

    state = create_train_state(
        model, TrainConfig(total_steps=4, learning_rate=1e-4), batch_np)
    state = jax.tree.map(
        lambda a: globalize(np.asarray(a), P()), state)

    step = data_parallel_step(make_train_step(model, dp_axis="dp"), mesh,
                              donate_state=False)
    losses = []
    try:
        for i in range(2):
            state, metrics = step(state, batch, jax.random.key(i))
            # Replicated output: every process reads the same scalar.
            losses.append(float(np.asarray(
                jax.device_get(metrics["loss"]))))
    except Exception as exc:  # noqa: BLE001
        msg = f"{type(exc).__name__}: {exc}"
        if any(s in msg.lower() for s in ("collective", "not implemented",
                                          "unimplemented", "unsupported")):
            print(f"SKIP:cross-process CPU collectives unavailable: {msg}")
            return 42
        raise

    print(json.dumps({
        "process_id": pid,
        "num_processes": nproc,
        "global_devices": n_global,
        "local_devices": n_local,
        "mesh_shape": dict(mesh.shape),
        "losses": losses,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
