"""Experiment driver: run the BoxQP suite, aggregate % gap closed.

Counterpart of the reference's run_experiments script (SURVEY.md R4,
section 3.3): for each (instance, strategy) run the cutting-plane loop,
record per-round certified bounds, and report the % of the
(McCormick - SDP) gap closed per round.

SDP reference bounds are computed once per instance by the full-eigencut loop
(loop/sdp_bound.py) and cached in a JSON registry next to the instance data —
the replacement for the reference's shipped known-optima files.
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np

from ..config import RunConfig
from ..instances.boxqp import load_or_generate
from ..loop.sdp_bound import gap_closed
from ..loop.solver import CutSolver
from ..utils.logging import JSONLLogger


def bounds_registry(path: str):
    from ..utils.registry import load_registry

    return load_registry(path)


def ensure_bounds(name: str, data_dir: str, lp_cfg=None, max_rounds: int = 150):
    """Get (mccormick_bound, sdp_bound) for an instance.  On a registry miss
    the sandwich is CERTIFIED with the validated settings and persisted
    (the old fallback ran a loose, never-saved eigencut stall)."""
    from ..utils.registry import ensure_certified_bounds

    inst = load_or_generate(name, data_dir=data_dir)
    return ensure_certified_bounds(
        inst, os.path.join(data_dir, "bounds.json"), lp_cfg, max_rounds)


def instance_gap_closed(name: str, cfg: RunConfig, data_dir: str,
                        rounds: int | None = None, logger: JSONLLogger | None = None,
                        sdp_max_rounds: int = 120):
    """Run one (instance, strategy); returns dict with per-round gap closed.

    Accepts both families: spar* names run the dense BoxQP CutSolver;
    qcqp*/qcqpband* names run CutSolverQCQP with the clique candidate table
    and the constraint rows in the relaxation (the QCQP registry at
    data/qcqp/bounds.json supplies the gap denominators)."""
    t0 = time.perf_counter()
    if name.startswith("qcqp"):
        from ..instances.qcqp import load_or_generate_qcqp
        from ..qcqp.solver import CutSolverQCQP

        from ..utils.registry import ensure_certified_bounds

        inst = load_or_generate_qcqp(name)
        qdir = os.path.join(os.path.dirname(data_dir.rstrip("/")), "qcqp") \
            if "qcqp" not in data_dir else data_dir
        mc, sdp = ensure_certified_bounds(
            inst, os.path.join(qdir, "bounds.json"), cfg.lp, sdp_max_rounds)
        solver = CutSolverQCQP(inst, cfg)
        hist = solver.run(rounds)
    else:
        inst = load_or_generate(name, data_dir=data_dir)
        mc, sdp = ensure_bounds(name, data_dir, cfg.lp, sdp_max_rounds)
        solver = CutSolver(inst, cfg)
        hist = solver.run(rounds)
    gaps = gap_closed(mc, sdp, [h.bound for h in hist])
    rec = {
        "instance": name,
        "strategy": cfg.scorer.strategy,
        "k": cfg.cuts.k,
        "sel_size": cfg.cuts.sel_size,
        "rounds_run": len(hist),
        "polish_iters": cfg.loop.polish_iters,
        "mccormick": mc,
        "sdp": sdp,
        "bounds": [h.bound for h in hist],
        "round_times_s": [h.wall_time_s for h in hist],
        "gap_closed": gaps.tolist(),
        "final_gap_closed": float(gaps[-1]) if len(gaps) else 0.0,
        "cuts_total": hist[-1].cuts_active if hist else 0,
        "wall_time_s": time.perf_counter() - t0,
        # gap_closed is platform-independent (same f32 jit program); the
        # timing columns are only comparable within one platform, so tag it.
        "platform": jax.default_backend(),
    }
    if logger:
        logger.log(rec)
    return rec


def run_suite(names, strategies, cfg: RunConfig, data_dir: str,
              out_path: str | None = None, rounds: int | None = None,
              verbose: bool = True):
    """Run the suite grid; returns list of per-run records + summary."""
    import dataclasses

    logger = JSONLLogger(out_path) if out_path else None
    records = []
    for name in names:
        for strat in strategies:
            c = dataclasses.replace(
                cfg, scorer=dataclasses.replace(cfg.scorer, strategy=strat)
            )
            rec = instance_gap_closed(name, c, data_dir, rounds, logger)
            records.append(rec)
            if verbose:
                print(f"[suite] {name} {strat}: gap_closed="
                      f"{rec['final_gap_closed']:.3f} "
                      f"t={rec['wall_time_s']:.1f}s", flush=True)
    summary = summarize(records)
    if logger:
        logger.log({"summary": summary})
        logger.close()
    return records, summary


def summarize(records):
    out = {}
    for r in records:
        out.setdefault(r["strategy"], []).append(r["final_gap_closed"])
    return {
        s: {"mean_gap_closed": float(np.mean(v)), "n": len(v)}
        for s, v in out.items()
    }
