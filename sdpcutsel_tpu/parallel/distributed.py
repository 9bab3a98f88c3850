"""Multi-host bring-up and host coordination (P3, SURVEY.md sections 2.3, 5.8).

Layout: one process per host, each driving all of its host's GPUs.  The
collectives are XLA's (NCCL); the host-side machinery is (a)
`jax.distributed.initialize` so all processes join one runtime and see the
global device set, and (b) `multihost_utils` for host-side sync and for
building/fetching global arrays whose shards live on other hosts.

Mesh layout for N >= 2 hosts: parallel/mesh.make_mesh lays the 'data'
(instance) axis across hosts — no collectives cross it — and keeps each
'cand' group on one host, so the per-round top-k all_gather stays on that
host's NVLink.

Tested without a cluster: tests/test_multihost.py launches two local CPU
processes (gloo collectives) forming a 2 x 4 virtual mesh and runs the full
sharded production round step across them (scripts/run_multihost.py).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_count: Optional[int] = None) -> None:
    """Join the multi-process runtime (idempotent).

    Pass the coordinator address (``host:port`` of process 0), the process
    count and this process's id explicitly or via JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID; nothing is auto-detected.
    """
    # Idempotence guard that must NOT touch the backend (jax.process_count()
    # would initialize XLA, after which distributed init is rejected).
    from jax._src import distributed as _internal

    if getattr(_internal.global_state, "client", None) is not None:
        return  # already initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    kwargs = {}
    if local_device_count is not None:
        kwargs["local_device_count"] = local_device_count
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id, **kwargs)


def sync(tag: str = "sync") -> None:
    """Barrier across all hosts (multihost_utils.sync_global_devices)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(tag)


def put_global(arr, mesh: Mesh, spec: P):
    """Build a global array sharded per ``spec`` from a full host-replicated
    numpy value (every host holds the same full array; each device reads its
    own slice)."""
    arr = np.asarray(arr)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])


def put_global_tree(tree, mesh: Mesh, spec: P):
    """put_global over every leaf of a pytree (same spec for all leaves)."""
    return jax.tree.map(lambda a: put_global(a, mesh, spec), tree)


def fetch_tree(tree):
    """Fetch global (possibly non-fully-addressable) arrays to full numpy
    values on every host (tiled process_allgather)."""
    from jax.experimental import multihost_utils

    return jax.tree.map(
        lambda a: np.asarray(multihost_utils.process_allgather(a, tiled=True)),
        tree,
    )
