"""Device mesh construction: ('data', 'cand') axes.

Collectives are XLA's over the mesh (NCCL between GPUs) — no separate
communication layer (SURVEY.md section 2.3 P4).  Axes:

  'data' — instance batch axis (P2): independent BoxQP instances solved
           concurrently; no collectives cross this axis.
  'cand' — candidate-space axis (P1): the C(n,k) scoring domain is sharded;
           the only collective is the per-round global top-k all_gather.

GPUs of a host are joined all to all, so the mesh follows the algorithm
alone.  With several processes (parallel/distributed.py), devices are
ordered so the 'data' axis spans processes (no collectives cross it) and
each 'cand' group stays inside one process.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(data: int = 1, cand: int = 1, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = data * cand
    if need > len(devices):
        raise ValueError(f"mesh {data}x{cand} needs {need} devices, "
                         f"have {len(devices)}")
    if jax.process_count() > 1:
        devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    arr = np.asarray(devices[:need]).reshape(data, cand)
    return Mesh(arr, ("data", "cand"))


def default_mesh() -> Mesh:
    """All local devices on the candidate axis (single-instance solve)."""
    return make_mesh(data=1, cand=len(jax.devices()))
