"""Multi-host bootstrap + pod-mesh layout (single-process, virtual devices).

The host-aware layout invariants are checked structurally (no multi-host
hardware needed): tp groups never span a simulated host, the dp axis is
host-major, and a dp x tp training step on the pod mesh matches the plain
mesh numerically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fewbit_tpu.parallel import (dp_tp_train_step, init_distributed,
                                 init_dp_tp_state, make_dp_tp_mesh,
                                 make_pod_mesh, pod_mesh_spec, shard_batch)
from fewbit_tpu.parallel.distributed import host_groups


def test_pod_mesh_spec_factorisation():
    assert pod_mesh_spec(8, tp=2, hosts=2) == (2, 2, 2)
    assert pod_mesh_spec(8, tp=1, hosts=4) == (4, 2, 1)
    assert pod_mesh_spec(8) == (1, 8, 1)
    assert pod_mesh_spec(16, tp=4, hosts=2) == (2, 2, 4)


def test_pod_mesh_spec_rejects_bad_partitions():
    with pytest.raises(ValueError):
        pod_mesh_spec(8, tp=2, hosts=3)  # hosts don't divide devices
    with pytest.raises(ValueError):
        pod_mesh_spec(8, tp=3, hosts=2)  # tp doesn't divide per-host count
    with pytest.raises(ValueError):
        pod_mesh_spec(8, tp=8, hosts=2)  # tp would cross a host boundary
    with pytest.raises(ValueError):
        pod_mesh_spec(8, tp=0)


def test_init_distributed_single_process_noop():
    assert init_distributed() == (0, 1)
    # Idempotent.
    assert init_distributed() == (0, 1)


def test_host_groups_single_process():
    groups = host_groups(jax.devices())
    assert len(groups) == 1
    assert len(groups[0]) == len(jax.devices())


def _simulated_host_of(device_order, device):
    """Index of the simulated host (= position in the original flat order
    divided by the group size) for layout assertions."""
    return device_order.index(device)


def test_pod_mesh_layout_host_major():
    devices = jax.devices()
    assert len(devices) >= 8, "conftest forces an 8-device CPU mesh"
    mesh = make_pod_mesh(tp=2, hosts=2, devices=devices[:8])
    assert mesh.shape == {"dp": 4, "tp": 2}

    order = list(devices[:8])
    arr = mesh.devices
    # Every tp group (row) must live inside one simulated host: with 8
    # devices over 2 hosts, host 0 = order[0:4], host 1 = order[4:8].
    for row in arr:
        hosts_in_row = {_simulated_host_of(order, d) // 4 for d in row}
        assert len(hosts_in_row) == 1
    # dp axis is host-major: first two rows from host 0, last two from host 1.
    row_hosts = [_simulated_host_of(order, arr[i, 0]) // 4 for i in range(4)]
    assert row_hosts == [0, 0, 1, 1]


def test_pod_mesh_rejects_incompatible_hosts():
    devices = jax.devices()[:6]
    with pytest.raises(ValueError):
        make_pod_mesh(tp=1, hosts=4, devices=devices)  # 6 % 4 != 0


def test_pod_mesh_step_matches_plain_mesh():
    """One dp x tp training step gives identical loss on the pod-layout mesh
    and the plain row-major mesh (device placement must not change math)."""
    from fewbit_tpu.models import RobertaConfig, \
        RobertaForSequenceClassification
    from fewbit_tpu.train import TrainConfig, make_train_step, synthetic_glue

    cfg = RobertaConfig(vocab_size=64, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32,
                        max_position_embeddings=34, num_labels=2,
                        gelu_bits=3, proj_dim_ratio=0.5,
                        tp_axis="tp", tp_size=2,
                        hidden_dropout=0.0, attention_dropout=0.0)
    model = RobertaForSequenceClassification(cfg)
    batch_np = next(synthetic_glue(8, seq_len=8, vocab_size=cfg.vocab_size))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tcfg = TrainConfig(total_steps=4, learning_rate=1e-4)

    losses = {}
    for name, mesh in (
        ("plain", make_dp_tp_mesh(4, 2, devices=jax.devices()[:8])),
        ("pod", make_pod_mesh(tp=2, hosts=2, devices=jax.devices()[:8])),
    ):
        state, specs = init_dp_tp_state(model, tcfg, batch, mesh)
        step = dp_tp_train_step(make_train_step(model, dp_axis="dp"), mesh,
                                specs)
        _, metrics = step(state, shard_batch(batch, mesh), jax.random.key(0))
        losses[name] = float(metrics["loss"])

    assert np.isfinite(losses["plain"])
    np.testing.assert_allclose(losses["plain"], losses["pod"], rtol=1e-5)


def test_collective_groups_parses_both_encodings():
    from fewbit_tpu.parallel import collective_groups

    list_form = ('  %ar = f32[4] all-reduce(%x), channel_id=1, '
                 'replica_groups={{0,2},{1,3}}, to_apply=%add')
    iota_form = ('  %ar2 = f32[4] all-reduce(%x), channel_id=2, '
                 'replica_groups=[2,2]<=[2,2]T(1,0), to_apply=%add')
    parsed = collective_groups(list_form + "\n" + iota_form)
    assert parsed[0] == ("all-reduce", ((0, 2), (1, 3)))
    # iota [2,2]<=[2,2]T(1,0): arange(4).reshape(2,2).T -> {{0,2},{1,3}}
    assert parsed[1] == ("all-reduce", ((0, 2), (1, 3)))


def test_pod_collective_layout_rejects_lopsided_groups():
    from fewbit_tpu.parallel import (assert_pod_collective_layout,
                                     make_pod_mesh)

    devices = jax.devices()[:8]
    mesh = make_pod_mesh(tp=2, hosts=2, devices=devices)
    pos = {id(d): i for i, d in enumerate(devices)}
    host_of = lambda d: pos[id(d)] // 4  # noqa: E731

    ok = "%ar = f32[2] all-reduce(%x), replica_groups={{0,2,4,6},{1,3,5,7}}"
    counts = assert_pod_collective_layout(ok, mesh, host_of)
    assert counts == {"intra_host": 0, "cross_host": 2}

    bad = "%ar = f32[2] all-reduce(%x), replica_groups={{0,1,2,4}}"
    with pytest.raises(AssertionError, match="unbalanced"):
        assert_pod_collective_layout(bad, mesh, host_of)

    with pytest.raises(AssertionError, match="no collectives"):
        assert_pod_collective_layout("%add = f32[] add(%a, %b)", mesh,
                                     host_of)


def test_pod_mesh_step_collectives_are_hierarchical():
    """The COMPILED dp x tp pod-mesh training step's collectives respect the
    host hierarchy: tp psums stay inside a simulated host, the dp
    gradient all-reduce touches both hosts with equal membership (the shape
    that decomposes into an intra-host reduction + one inter-host exchange)
    — the
    `parallel/distributed.py` layout claim, verified from the executable."""
    from fewbit_tpu.models import RobertaConfig, \
        RobertaForSequenceClassification
    from fewbit_tpu.parallel import assert_pod_collective_layout
    from fewbit_tpu.train import TrainConfig, make_train_step, synthetic_glue

    devices = jax.devices()[:8]
    mesh = make_pod_mesh(tp=2, hosts=2, devices=devices)
    cfg = RobertaConfig(vocab_size=64, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32,
                        max_position_embeddings=34, num_labels=2,
                        gelu_bits=3, proj_dim_ratio=0.5,
                        tp_axis="tp", tp_size=2,
                        hidden_dropout=0.0, attention_dropout=0.0)
    model = RobertaForSequenceClassification(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             next(synthetic_glue(8, seq_len=8,
                                 vocab_size=cfg.vocab_size)).items()}
    state, specs = init_dp_tp_state(
        model, TrainConfig(total_steps=4, learning_rate=1e-4), batch, mesh)
    step = dp_tp_train_step(make_train_step(model, dp_axis="dp"), mesh,
                            specs)
    hlo = step.lower(state, shard_batch(batch, mesh),
                     jax.random.key(0)).compile().as_text()

    pos = {id(d): i for i, d in enumerate(devices)}
    counts = assert_pod_collective_layout(
        hlo, mesh, host_of=lambda d: pos[id(d)] // 4)
    assert counts["intra_host"] > 0, "expected host-local tp psums"
    assert counts["cross_host"] > 0, "expected a cross-host dp all-reduce"


def test_overlap_assertion_logic():
    """Unit coverage of assert_collective_compute_overlap on synthetic
    scheduled modules (pass, trailing-collectives fail, unscheduled fail)."""
    from fewbit_tpu.parallel import assert_collective_compute_overlap

    def module(body):
        return ("HloModule m, is_scheduled=true\n\nENTRY %main () -> f32[] "
                "{\n" + body + "\n}\n")

    ok = module("  %f1 = f32[8] fusion(%a), kind=kLoop\n"
                "  %ar = f32[8] all-reduce(%f1), replica_groups={{0,1}}\n"
                "  %f2 = f32[8] fusion(%b), kind=kLoop\n"
                "  %f3 = f32[8] fusion(%f2), kind=kLoop\n")
    res = assert_collective_compute_overlap(ok)
    assert res["compute_after_first_collective"] == 2

    trailing = module("  %f1 = f32[8] fusion(%a), kind=kLoop\n"
                      "  %f2 = f32[8] fusion(%f1), kind=kLoop\n"
                      "  %ar = f32[8] all-reduce(%f2), "
                      "replica_groups={{0,1}}\n")
    with pytest.raises(AssertionError, match="trail the compute"):
        assert_collective_compute_overlap(trailing)

    with pytest.raises(AssertionError, match="not scheduled"):
        assert_collective_compute_overlap(
            ok.replace("is_scheduled=true", ""))

    async_ok = module(
        "  %s = f32[8] all-reduce-start(%a), replica_groups={{0,1}}\n"
        "  %f1 = f32[8] fusion(%b), kind=kLoop\n"
        "  %d = f32[8] all-reduce-done(%s)\n")
    res = assert_collective_compute_overlap(async_ok)
    assert res["compute_between_async"] == 1


def test_dp_allreduce_overlaps_backward_in_schedule():
    """The real dp train step, compiled for the virtual 8-device mesh (a
    scheduled executable like the GPU's): the gradient all-reduces are
    issued as their operands become ready, interleaved with compute."""
    from fewbit_tpu.models import RobertaConfig, \
        RobertaForSequenceClassification
    from fewbit_tpu.parallel import (assert_collective_compute_overlap,
                                     data_parallel_step, make_mesh)
    from fewbit_tpu.train import (TrainConfig, create_train_state,
                                  make_train_step, synthetic_glue)

    mesh = make_mesh()
    cfg = RobertaConfig(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, intermediate_size=512,
                        max_position_embeddings=66, num_labels=2,
                        gelu_bits=3, proj_dim_ratio=0.25,
                        sketch="countsketch")
    model = RobertaForSequenceClassification(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             next(synthetic_glue(16, seq_len=32,
                                 vocab_size=cfg.vocab_size)).items()}
    state = create_train_state(model, TrainConfig(total_steps=4), batch)
    step = data_parallel_step(make_train_step(model, dp_axis="dp"), mesh,
                              donate_state=False)
    hlo = step.lower(state, batch, jax.random.key(0)).compile().as_text()
    res = assert_collective_compute_overlap(hlo)
    assert res["n_all_reduce"] >= 2  # per-parameter ARs, not one tail blob
