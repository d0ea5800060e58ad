from fewbit_tpu.parallel.distributed import (  # noqa: F401
    assert_collective_compute_overlap, assert_pod_collective_layout,
    collective_groups, host_groups, init_distributed, make_pod_mesh,
    pod_mesh_spec)
from fewbit_tpu.parallel.mesh import (  # noqa: F401
    data_parallel_step, fold_shard_key, make_mesh, replicate, shard_batch)
from fewbit_tpu.parallel.tp import (  # noqa: F401
    dp_tp_train_step, init_dp_tp_state, make_dp_tp_mesh, state_specs,
    tp_copy, tp_param_spec, tp_sum)
