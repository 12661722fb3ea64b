"""Multi-host runtime: process-group init and cross-host array feeding.

The reference is strictly single-process (SURVEY.md section 2.7: no
torch.distributed / NCCL / MPI anywhere); multi-host execution is a new,
first-class capability of this framework (SURVEY.md section 7, build step 8).

JAX's multi-controller model: every host runs THE SAME program under
``jax.distributed.initialize``; ``jax.devices()`` then spans all hosts, and
a ``Mesh`` over it makes shard_map/pjit collectives span hosts -- the
runtime picks the transport, code is unchanged.  Everything in
``parallel/`` (shard_filter, data_parallel_loss_fn) works on such a global
mesh as-is: the per-MVM ``psum`` of the lattice table
and the all_gather of vertex hashes are mesh-topology-agnostic.

Multi-process runs are opt-in: explicit arguments, the ``JAX_*`` env vars
below, or a SLURM/OpenMPI launcher (handled by jax.distributed itself).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "global_mesh",
    "host_local_batch",
]

_INITIALIZED = False


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
) -> bool:
    """Join the multi-host process group (idempotent).

    With no arguments, relies on jax.distributed's launcher autodetection
    (SLURM, OpenMPI) plus the standard env vars
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
    Returns True if a multi-process group was (or already is) active, False
    for plain single-process runs (no coordinator configured) -- callers can
    treat False as "single host" and proceed; every code path in this
    framework works identically either way.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1

    # Decide WITHOUT touching the backend: jax.distributed.initialize must
    # run before any jax.devices()/computation, so probing process_count
    # here would make init impossible.  Multi-process runs are explicit
    # opt-in: args, JAX_COORDINATOR_ADDRESS, or a SLURM/OpenMPI launcher.
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    in_managed_env = any(
        v in os.environ for v in ("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")
    )
    if coordinator_address is None and not in_managed_env:
        return False  # single-process run

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True
    return jax.process_count() > 1


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_name: str = "data") -> Mesh:
    """1-D mesh over ALL devices across ALL hosts, in default device order."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def host_local_batch(mesh: Mesh, *arrays, axis_name: str = "data"):
    """Build global data-sharded arrays from PER-HOST local rows.

    Each process passes only its own rows (e.g. its slice of the training
    set); the result is a global jax.Array sharded over ``axis_name`` whose
    addressable shards come from this host's data -- the multi-host analogue
    of parallel/mesh.py shard_batch (which assumes all rows are local).
    """
    out = []
    for a in arrays:
        a = np.asarray(a)
        spec = P(axis_name, *([None] * (a.ndim - 1)))
        out.append(
            jax.make_array_from_process_local_data(NamedSharding(mesh, spec), a)
        )
    return out[0] if len(out) == 1 else tuple(out)
