"""Round-granular checkpoint/resume (SURVEY.md sections 5.3, 5.4).

The cutting-plane loop's full state is (cut pool, PDHG warm-start state,
bound history, RNG key) — a small pytree.  Snapshots make the loop trivially
restartable: multi-host failures restart from the last round snapshot (no
elastic scale-up is needed for this workload).  Format: one ``np.savez``
archive of the arrays (keys ``pool.<field>``, ``state.<field>``, ``key``)
plus a JSON sidecar of the history and metadata.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(path: str, pool, pdhg_state, key, history: list, meta: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {"key": np.asarray(key)}
    for prefix, tup in (("pool", pool), ("state", pdhg_state)):
        for field, a in tup._asdict().items():
            arrays[f"{prefix}.{field}"] = np.asarray(a)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    side = {"history": history, "meta": meta}
    with open(path + ".json", "w") as f:
        json.dump(side, f, default=float)


def load_checkpoint(path: str):
    """Returns (pool_dict, state_dict, key, history, meta) as numpy pytrees;
    callers rebuild CutPool/PDHGState namedtuples from the dicts."""
    pool, state = {}, {}
    with np.load(path) as z:
        for name in z.files:
            prefix, _, field = name.partition(".")
            if prefix == "pool":
                pool[field] = z[name]
            elif prefix == "state":
                state[field] = z[name]
        key = z["key"]
    with open(path + ".json") as f:
        side = json.load(f)
    return pool, state, key, side["history"], side["meta"]
