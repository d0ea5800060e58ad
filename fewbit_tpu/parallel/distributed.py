"""Multi-host bootstrap and host-aware mesh construction.

The reference library is strictly single-device/single-process (SURVEY.md
§2.3 — no ``torch.distributed`` import anywhere); scaling over several
hosts is a net-new capability of this framework.  The JAX multi-host model:
every host runs the *same* program, ``jax.distributed.initialize`` wires the
processes together, and ``jax.devices()`` then returns the global device
list.  Sharded computation code does not change — what changes is the mesh
layout.  Within one host the cards talk over NVLink, all to all at one rate;
across hosts the collectives go over the slower inter-host network (NCCL
over InfiniBand or Ethernet), so only the data-parallel axis should cross
it.

:func:`make_pod_mesh` builds a ``(dp, tp)`` mesh ordered **host-major**: the
``tp`` axis (heavy per-layer psums) never crosses a host boundary, and the
``dp`` gradient all-reduce decomposes into intra-host reductions plus a
single inter-host exchange — NCCL picks the hierarchical algorithm once the
device order encodes the topology.

Launch recipe (N >= 2 hosts), e.g. with two processes::

    # host 0                                   # host 1
    FEWBIT_COORDINATOR=host0:8476 \
    FEWBIT_NUM_PROCESSES=2 \
    FEWBIT_PROCESS_ID=0 python train.py        ... FEWBIT_PROCESS_ID=1 ...

and in ``train.py``::

    from fewbit_tpu.parallel import init_distributed, make_pod_mesh
    init_distributed()          # no-op when the env vars are absent
    mesh = make_pod_mesh(tp=1)  # dp spans hosts, host-major

JAX is told of a cluster only through these arguments or variables;
``init_distributed()`` with neither is a single-process no-op.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ("init_distributed", "make_pod_mesh", "pod_mesh_spec",
           "host_groups", "collective_groups",
           "assert_pod_collective_layout",
           "assert_collective_compute_overlap")

_ENV_COORD = ("FEWBIT_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
_ENV_NPROC = ("FEWBIT_NUM_PROCESSES",)
_ENV_PID = ("FEWBIT_PROCESS_ID",)


def _env_first(names: Sequence[str]) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> Tuple[int, int]:
    """Initialise the multi-host runtime; returns ``(process_id, n_processes)``.

    Thin, idempotent wrapper over ``jax.distributed.initialize``:

    * explicit arguments win;
    * otherwise ``FEWBIT_COORDINATOR`` / ``FEWBIT_NUM_PROCESSES`` /
      ``FEWBIT_PROCESS_ID`` (or ``JAX_COORDINATOR_ADDRESS``) configure the
      cluster — the launch recipe in the module docstring;
    * with neither, this is a **no-op** returning ``(0, 1)`` — single-process
      programs (including every test in this repo and the driver's
      ``dryrun_multichip``) pay nothing and need no special-casing.
    """
    if getattr(init_distributed, "_initialized", False):
        return jax.process_index(), jax.process_count()

    coordinator_address = coordinator_address or _env_first(_ENV_COORD)
    if num_processes is None:
        raw = _env_first(_ENV_NPROC)
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = _env_first(_ENV_PID)
        process_id = int(raw) if raw else None

    if coordinator_address is None and num_processes in (None, 1):
        return 0, 1  # single-process: nothing to wire up

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    init_distributed._initialized = True
    return jax.process_index(), jax.process_count()


def pod_mesh_spec(n_devices: int, tp: int = 1,
                  hosts: Optional[int] = None) -> Tuple[int, int, int]:
    """Factorise a device set into ``(hosts, dp_per_host, tp)``.

    Pure function (unit-testable without devices).  Invariants enforced:
    ``hosts * dp_per_host * tp == n_devices`` and ``tp`` divides the per-host
    device count — the tensor-parallel axis must never cross a host
    boundary, where its per-layer psums would serialise on host links.
    """
    hosts = hosts or 1
    if hosts <= 0 or tp <= 0:
        raise ValueError("hosts and tp must be positive")
    if n_devices % hosts:
        raise ValueError(
            f"{n_devices} devices do not split evenly over {hosts} hosts")
    per_host = n_devices // hosts
    if per_host % tp:
        raise ValueError(
            f"tp={tp} does not divide the {per_host} devices of one host; "
            "tensor parallelism must stay inside a host")
    return hosts, per_host // tp, tp


def host_groups(devices) -> list:
    """Group a device list by owning process (host), process-index order."""
    by_host = {}
    for d in devices:
        by_host.setdefault(getattr(d, "process_index", 0), []).append(d)
    return [by_host[k] for k in sorted(by_host)]


def make_pod_mesh(tp: int = 1,
                  hosts: Optional[int] = None,
                  devices=None) -> Mesh:
    """Host-major ``(dp, tp)`` mesh over the devices of one or more hosts.

    ``devices`` defaults to the global ``jax.devices()`` (all hosts after
    :func:`init_distributed`).  ``hosts`` defaults to the number of distinct
    owning processes; pass it explicitly to *simulate* a host partition on a
    single process (used by ``__graft_entry__.dryrun_multichip`` and the
    tests to exercise the host-axis layout without hardware).

    Layout: devices of one host are reshaped to ``(dp_local, tp)``, then
    hosts stack along the leading (dp) axis — so every tp group lives inside
    one host and the dp axis is contiguous per host, giving a hierarchical
    intra-host then inter-host gradient reduction.
    """
    devices = list(devices if devices is not None else jax.devices())
    groups = host_groups(devices)
    if hosts is None:
        hosts = len(groups)
    elif hosts % len(groups) == 0 and len(groups) < hosts:
        # Simulated finer host partition: split each real host group.
        split = hosts // len(groups)
        regrouped = []
        for g in groups:
            if len(g) % split:
                raise ValueError(
                    f"cannot split a host of {len(g)} devices into {split}")
            step = len(g) // split
            regrouped += [g[i * step:(i + 1) * step] for i in range(split)]
        groups = regrouped
    elif hosts != len(groups):
        raise ValueError(
            f"hosts={hosts} incompatible with {len(groups)} owning processes")

    n = sum(len(g) for g in groups)
    _, dp_local, tp = pod_mesh_spec(n, tp=tp, hosts=hosts)
    blocks = [np.asarray(g, dtype=object).reshape(dp_local, tp)
              for g in groups]
    arr = np.concatenate(blocks, axis=0)
    return Mesh(arr, axis_names=("dp", "tp"))


# ---------------------------------------------------------------------------
# Compiled-HLO verification of the hierarchical collective layout.
#
# ``make_pod_mesh``'s docstring claims that with the host-major device order,
# tp collectives stay inside one host and the dp gradient all-reduce
# decomposes hierarchically, intra-host then inter-host.  These helpers turn
# that claim into an assertion against the *compiled* executable: parse every
# collective's replica groups out of the HLO text and check them against the
# host partition.  Used by ``__graft_entry__.dryrun_multichip`` and
# ``tests/test_distributed.py``.
# ---------------------------------------------------------------------------

_RG_LIST = r"replica_groups=\{(\{[0-9,\}\{ ]*\})\}"
_RG_IOTA = (r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\]"
            r"(?:T\(([0-9,]+)\))?")


def collective_groups(hlo_text: str):
    """Parse ``(op_kind, groups)`` for every collective in compiled HLO text.

    Handles both replica-group encodings XLA emits: the explicit list form
    ``replica_groups={{0,2},{1,3}}`` and the iota form
    ``replica_groups=[2,2]<=[2,2]T(1,0)`` (reshape an iota of all ids to the
    source dims, transpose by the permutation, reshape to groups x size).
    Returns a list of ``(kind, tuple_of_group_tuples)``.
    """
    import re

    out = []
    kinds = ("all-reduce", "reduce-scatter", "all-gather",
             "collective-permute", "all-to-all")
    for line in hlo_text.splitlines():
        kind = next((k for k in kinds if k in line), None)
        if kind is None or "replica_groups=" not in line:
            continue
        m = re.search(_RG_LIST, line)
        if m:
            groups = tuple(
                tuple(int(x) for x in grp.split(",") if x.strip())
                for grp in re.findall(r"\{([0-9, ]*)\}", m.group(1)))
            out.append((kind, groups))
            continue
        m = re.search(_RG_IOTA, line)
        if m:
            n_groups, group_size = int(m.group(1)), int(m.group(2))
            dims = [int(x) for x in m.group(3).split(",")]
            ids = np.arange(int(np.prod(dims))).reshape(dims)
            if m.group(4):
                ids = ids.transpose([int(x) for x in m.group(4).split(",")])
            ids = ids.reshape(n_groups, group_size)
            out.append((kind, tuple(tuple(int(x) for x in row)
                                    for row in ids)))
    return out


def assert_pod_collective_layout(hlo_text: str, mesh: Mesh,
                                 host_of) -> dict:
    """Assert the compiled collectives respect the host hierarchy.

    ``host_of``: device -> host index (for real pods ``d.process_index``;
    for a simulated partition, position in the original device order divided
    by the per-host count).  Every multi-participant collective group must
    either (a) stay entirely inside one host — an intra-host collective (the
    tp psums), or (b) touch *every* host with the *same* number of members
    per host — the balanced shape that decomposes into an intra-host
    reduction plus one inter-host exchange.  A lopsided group (e.g. 3
    members on one host, 1 on another) would serialise on the inter-host
    links and fails.

    Returns ``{"intra_host": n, "cross_host": n}`` group counts so callers
    can additionally assert that both kinds exist where expected.
    """
    flat = list(mesh.devices.flat)
    n_hosts = len({host_of(d) for d in flat})
    counts = {"intra_host": 0, "cross_host": 0}
    parsed = collective_groups(hlo_text)
    if not parsed:
        raise AssertionError("no collectives found in compiled HLO")
    for kind, groups in parsed:
        for group in groups:
            if len(group) <= 1:
                continue
            hosts_hit = {}
            for pid in group:
                h = host_of(flat[pid])
                hosts_hit[h] = hosts_hit.get(h, 0) + 1
            if len(hosts_hit) == 1:
                counts["intra_host"] += 1
                continue
            counts["cross_host"] += 1
            if len(hosts_hit) != n_hosts:
                raise AssertionError(
                    f"{kind} group {group} spans {len(hosts_hit)} of "
                    f"{n_hosts} hosts — neither host-local nor a full "
                    "hierarchical reduction")
            per_host = set(hosts_hit.values())
            if len(per_host) != 1:
                raise AssertionError(
                    f"{kind} group {group} is unbalanced across hosts "
                    f"({hosts_hit}) — cannot decompose into a host-local "
                    "reduction + one inter-host exchange")
    return counts


# ---------------------------------------------------------------------------
# Collective/compute overlap, asserted from the *scheduled* executable.
#
# SURVEY §2.3 mandates the dp gradient all-reduce be overlapped against the
# backward compute.  A compiled executable's post-optimisation module is
# scheduled (``is_scheduled=true``: the printed instruction order of the
# entry computation IS the execution order), so overlap is checkable: the
# per-parameter gradient all-reduces must be issued as their operands become
# ready — interleaved with the remaining backward/optimizer compute — rather
# than serialised after the last compute op.  On the GPU, XLA emits async
# ``all-reduce-start``/``-done`` pairs that NCCL runs on their own stream;
# compute scheduled between a pair is overlapped with it.
# ---------------------------------------------------------------------------

_HEAVY_OPS = ("fusion(", " dot(", "convolution(", "custom-call(")


def _entry_instructions(hlo_text: str):
    lines, in_entry = [], False
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            in_entry = True
            continue
        if in_entry:
            if line.startswith("}"):
                break
            lines.append(line.strip())
    return lines


def _is_scalar_result(line: str) -> bool:
    """True when an HLO instruction's result carries no tensor data worth
    overlapping — a scalar (or tuple of scalars) like the loss/metric pmean.
    Shape syntax: ``name = f32[] all-reduce(...)`` or tuple
    ``(f32[], f32[])``; any non-empty dimension list means non-scalar."""
    import re

    head = line.split(" all-reduce", 1)[0]
    dims = re.findall(r"[a-z0-9]+\[([0-9,]*)\]", head)
    return bool(dims) and all(d == "" for d in dims)


def assert_collective_compute_overlap(hlo_text: str,
                                      min_compute_after: int = 2,
                                      min_overlap_frac: float = 0.5) -> dict:
    """Assert the scheduled module interleaves gradient collectives with
    compute.

    Requires a scheduled module (``compiled.as_text()`` of an executable).  Scalar all-reduces (the loss/metrics pmean — nothing to
    overlap) are excluded, so the assertion is about the *gradient* ARs.
    Passes when (a) async ``all-reduce-start``/``-done`` pairs exist with
    compute scheduled between them, or (b) for sync ARs, at least
    ``min_overlap_frac`` of the non-scalar all-reduces each have heavy
    compute (fusions/dots/custom-calls) scheduled after them AND at least
    ``min_compute_after`` heavy ops follow the first one — i.e. the
    collectives are issued as operands become ready rather than trailing
    the compute.  Returns counts for callers to record."""
    if "is_scheduled=true" not in hlo_text:
        raise AssertionError(
            "module is not scheduled — overlap cannot be asserted from it "
            "(pass the text of a compiled executable)")
    entry = _entry_instructions(hlo_text)
    starts = [i for i, l in enumerate(entry) if "all-reduce-start" in l
              and not _is_scalar_result(l)]
    # Filter dones symmetrically: a scalar pmean's done would otherwise
    # mis-pair with a gradient start in the zip below.
    dones = [i for i, l in enumerate(entry) if "all-reduce-done" in l
             and not _is_scalar_result(l)]
    ars = [i for i, l in enumerate(entry)
           if "all-reduce" in l and "-start" not in l and "-done" not in l
           and not _is_scalar_result(l)]
    heavy = [i for i, l in enumerate(entry)
             if any(op in l for op in _HEAVY_OPS)]
    result = {"n_all_reduce": len(ars) + len(starts),
              "async_pairs": len(starts),
              "compute_between_async": 0,
              "compute_after_first_collective": 0,
              "overlapped_frac": 0.0}
    if not (ars or starts):
        raise AssertionError(
            "no non-scalar all-reduce in the scheduled module")
    if starts and dones:
        between = sum(1 for h in heavy
                      if any(s < h < d for s, d in zip(starts, dones)))
        result["compute_between_async"] = between
        if between >= 1:
            return result
    first = min(ars + starts)
    after = sum(1 for h in heavy if h > first)
    result["compute_after_first_collective"] = after
    overlapped = sum(1 for a in (ars + starts)
                     if any(h > a for h in heavy))
    frac = overlapped / max(len(ars) + len(starts), 1)
    result["overlapped_frac"] = round(frac, 3)
    if after < min_compute_after or frac < min_overlap_frac:
        raise AssertionError(
            f"gradient all-reduces trail the compute: {after} heavy ops "
            f"after the first AR (index {first} of {len(entry)}), "
            f"{frac:.0%} of {len(ars) + len(starts)} ARs have compute "
            f"scheduled after them (need >= {min_overlap_frac:.0%})")
    return result
