"""Certified-bounds registries (the suite drivers' fallback for
unregistered instances recomputed a LOOSE, never-persisted denominator).

Two jobs, shared by the suite drivers and the validator scripts:

* ``update_registry`` — locked read-merge-write of a ``bounds.json`` file:
  exclusive flock on a sidecar lock file, re-read under the lock, merge only
  the freshly computed keys, publish via ``os.replace`` (crash-safe and
  concurrent-run-safe; a missing registry starts from ``{}``).
* ``ensure_certified_bounds`` — get ``(mccormick, sdp)`` for an instance,
  computing a CERTIFIED sandwich on a miss with the validated settings
  (Burer-Monteiro primal lower bound anchoring the in-out eigencut upper
  bound — loop/sdp_bound.validate_sdp_bound) and persisting the result,
  including ``sdp_lower``/``sdp_rel_width``, so no run ever divides by an
  uncertified stall value and no value is computed twice.
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile


def load_registry(reg_path: str) -> dict:
    try:
        with open(reg_path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def update_registry(reg_path: str, name: str, fresh: dict) -> dict:
    os.makedirs(os.path.dirname(os.path.abspath(reg_path)), exist_ok=True)
    with open(reg_path + ".lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        merged = load_registry(reg_path)
        merged[name] = {**merged.get(name, {}), **fresh}
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(reg_path)), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as tf:
                json.dump(merged, tf, indent=1, sort_keys=True)
            os.replace(tmp, reg_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    return merged


def ensure_certified_bounds(inst, reg_path: str, lp_cfg=None,
                            max_rounds: int = 150, verbose: bool = True):
    """Return ``(mccormick, sdp)`` for ``inst``, certifying + persisting on a
    registry miss.  The expensive path runs once per instance ever."""
    reg = load_registry(reg_path)
    rec = reg.get(inst.name)
    if rec is not None:
        return rec["mccormick"], rec["sdp"]
    from ..loop.sdp_bound import sdp_relaxation_bound, validate_sdp_bound

    if verbose:
        print(f"[registry] {inst.name}: no certified bounds — computing "
              "(BM lower + in-out eigencut upper, one-time)", flush=True)
    ub, lb, rel = validate_sdp_bound(inst, lp_cfg, max_rounds=max_rounds)
    # The McCormick root bound is round 0 of a 1-round eigencut run.
    _, mc, _ = sdp_relaxation_bound(inst, lp_cfg, max_rounds=1)
    fresh = {"mccormick": mc, "sdp": ub, "sdp_lower": lb,
             "sdp_rel_width": rel, "sdp_ok": bool(lb <= ub + 1e-9)}
    update_registry(reg_path, inst.name, fresh)
    return mc, ub
