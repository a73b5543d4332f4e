"""Multi-host initialization and mesh construction.

The reference has no distributed layer at all (SURVEY.md §2.3); this is the
scale-out story: within a host, devices communicate through the
collectives in :mod:`.sharded` (which XLA hands to NCCL on NVIDIA GPUs);
across hosts, ``jax.distributed`` bootstraps a process group, and the same
``Mesh`` + ``shard_map`` code runs unchanged — devices from all hosts
appear in ``jax.devices()``.

Usage on each host of a cluster:

    from approximatenn.parallel import multihost
    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=2, process_id=0)
    mesh = multihost.global_mesh()    # 1-D mesh over every device in the job
    sidx = build_sharded(points, k, mesh=mesh, ...)

Per-host data loading: each process should feed only its addressable shard;
:func:`host_shard_slice` gives the [lo, hi) row range of the global array
this host owns under the 1-D row sharding used by ``build_sharded``.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from .sharded import AXIS

def _cluster_env_hints() -> list[str]:
    """Env vars whose values imply this process is one of SEVERAL — if any
    is present and bootstrap still fails, degrading to a silent
    single-process run would mask a cluster misconfiguration, so we
    re-raise.  Presence alone is not enough for the size variables: SLURM
    sets job vars for 1-task jobs, so those must indicate >1 participant."""
    hints = []
    for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        if os.environ.get(v):
            hints.append(v)
    for v in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(os.environ.get(v, "")) > 1:
                hints.append(v)
        except ValueError:
            pass
    return hints


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bootstrap jax.distributed.  With no arguments, relies on what
    ``jax.distributed`` detects from the environment (SLURM, MPI, a
    coordinator address); explicit args support manual clusters.  Safe to
    call when already initialized (no-op).  Falls back to a local
    single-process run ONLY when nothing suggested a cluster: explicit args
    (even partial) or cluster env vars make failures loud."""
    # NOT jax.process_count(): that initializes the XLA backend, after
    # which jax.distributed.initialize refuses to run at all
    if jax.distributed.is_initialized():
        return  # already initialized
    explicit = not (
        coordinator_address is None and num_processes is None and process_id is None
    )
    env_hints = _cluster_env_hints()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError) as e:
        if explicit or env_hints:
            raise RuntimeError(
                "jax.distributed bootstrap failed in a cluster context "
                f"(explicit args: {explicit}, cluster env vars set: "
                f"{env_hints or 'none'}); refusing to degrade to a silent "
                "single-process run"
            ) from e
        # single-process run with no cluster env: stay local


def global_mesh(axis: str = AXIS) -> Mesh:
    """1-D mesh over every device in the job (all hosts), ordered as
    jax.devices() enumerates them."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_shard_slice(n: int, mesh: Mesh | None = None) -> tuple[int, int]:
    """[lo, hi) rows of the length-n globally row-sharded array owned by
    this process under `mesh` (defaults to the global mesh)."""
    mesh = mesh or global_mesh()
    devs = list(mesh.devices.flat)
    s = len(devs)
    if n % s:
        raise ValueError(f"n={n} not divisible by device count {s}")
    per = n // s
    mine = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    if not mine:
        return 0, 0
    lo = min(mine) * per
    hi = (max(mine) + 1) * per
    if mine != list(range(min(mine), max(mine) + 1)):
        raise ValueError("this host's devices are not contiguous in the mesh")
    return lo, hi


def process_local_array(global_shape, mesh: Mesh, per_host_data: np.ndarray):
    """Assemble a globally-sharded jax.Array from per-host shards
    (``jax.make_array_from_process_local_data`` under the row sharding
    build_sharded uses)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(AXIS, *([None] * (len(global_shape) - 1))))
    return jax.make_array_from_process_local_data(sharding, per_host_data, global_shape)
