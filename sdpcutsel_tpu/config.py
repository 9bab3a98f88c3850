"""Configuration tree for the whole framework.

The reference exposes its knobs as function kwargs on ``cut_select_algo``
(instance, k, sel_size, strategy, round count, tolerances — SURVEY.md section 5.6).
Here every knob lives in one frozen dataclass tree so a run is fully described
by a single ``RunConfig`` value; the CLI maps repeated
``--set section.field=value`` overrides onto it via ``apply_overrides``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LPConfig:
    """Restarted-PDHG LP solver knobs (lp/pdhg.py)."""

    max_iters: int = 20_000          # hard cap on PDHG iterations per solve
    check_every: int = 100           # convergence check / restart cadence
    restart_period: int = 500        # fixed fallback restart period (iters)
    tol: float = 1e-6                # relative primal-dual gap target
    feas_tol: float = 1e-6           # relative primal infeasibility target
    omega0: float = 1.0              # initial primal weight
    step_scale: float = 0.95         # eta = step_scale / ||K||
    power_iters: int = 30            # power-method iterations for ||K||
    dtype: str = "float32"


@dataclass(frozen=True)
class CutConfig:
    """Candidate cut family and pool management."""

    k: int = 3                       # submatrix dimension (2/3 dense; up to 5 QCQP)
    sel_size: int = 20               # cuts (candidates) selected per round
    capacity: int = 1024             # fixed cut-pool capacity (masked buffer);
                                     # purge keeps typical runs well under
                                     # (rounds x sel_size <= ~400)
    viol_tol: float = 1e-4           # -lambda_min threshold to emit a cut
    purge_slack_tol: float = 1e-3    # purge cuts with slack above this and
                                     # ~0 dual.  Round 4: raised from 1e-5 —
                                     # the aggressive default purged rows a
                                     # PDHG-accuracy-limited re-solve still
                                     # needed, costing up to 25pp of suite-
                                     # config parity vs the never-purging
                                     # replica
    purge: bool = True
    sel_gate: str = "residual"       # sparse-path re-selection gate.  PDHG
                                     # re-solves are inexact, so last round's
                                     # selections can still read as violated
                                     # and an unmasked ranking re-picks them —
                                     # duplicate cuts pile up while the bound
                                     # plateaus (qcqp/solver.py do_round).
                                     # "residual" (default): mask a candidate
                                     # while its current violation is still
                                     # >= gate_eta x its violation when last
                                     # selected — i.e. the LP has not yet
                                     # enforced its cut, so re-picking is a
                                     # duplicate; once the violation drops
                                     # below that fraction, what remains is a
                                     # new eigendirection and re-selection is
                                     # productive.  Per-candidate and
                                     # self-timing: no per-cell knob (the
                                     # round-counted cooldown's 0.92-vs-0.98
                                     # k=5 sensitivity).
                                     # "cooldown": round-counted mask below.
                                     # "none": no gate.
    gate_eta: float = 0.5            # "residual" gate threshold fraction
    sel_cooldown: int = 2            # "cooldown" gate: a selected candidate
                                     # is masked for this many rounds
    cooldown_kkt_tol: float = 1e-3   # the cooldown mask only applies while
                                     # the solve's KKT error exceeds this —
                                     # once the LP re-solve is converged,
                                     # re-selection is productive (new LP
                                     # point), exactly like the replica's
    diversity_alpha: float = 1e-4    # >0: greedy support-diverse selection
                                     # (ops/topk.py diverse_topk) — penalize
                                     # candidates whose indices were already
                                     # used this round by alpha per use;
                                     # breaks the massive score ties at LP
                                     # vertices toward low-overlap supports.
                                     # Round 4: default ON (1e-4) — the
                                     # tie-clustering parity dips it fixes
                                     # (ARCHITECTURE.md) hit the production
                                     # suite config, not just bespoke cells


@dataclass(frozen=True)
class ScorerConfig:
    """Cut-selection strategy (SURVEY.md section 0.4).

    strategy:
      "feasibility"  — score by -lambda_min(Z(rho))
      "optimality"   — exact small-SDP subproblem improvement (slow; oracle)
      "neural"       — trained MLP estimate of the optimality score (headline)
      "random"       — uniform random scores (experimental control)
      "combined"     — neural score with feasibility tie-breaking
      "triangle"     — RLT triangle (QPB) inequalities by violation, the
                       paper's comparison baseline (k=3 only; cuts/triangle.py)
    """

    strategy: str = "neural"
    weights_path: Optional[str] = None   # default: bundled artifact for this k
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0


@dataclass(frozen=True)
class LoopConfig:
    """Cutting-plane round controller."""

    rounds: int = 20
    use_scan: bool = False           # run ALL rounds in ONE jit dispatch
                                     # (lax.scan over rounds; loop/solver.py
                                     # run_scan) — removes the per-round
                                     # dispatch floor; no early stop or
                                     # per-round checkpointing in this mode
    improvement_tol: float = 1e-5    # stop when relative bound improvement below
    polish_iters: int = 0            # >0: final tighter LP re-solve (no new
                                     # cuts) with this iteration budget, to
                                     # recover bound accuracy lost to
                                     # per-round LP iteration limits
    checkpoint_every: int = 0        # 0 = disabled; else rounds between snapshots
    checkpoint_dir: Optional[str] = None
    steer_eps: float = 0.0           # >0: vertex steering — score/cut-generate
                                     # at the optimum of a tiny-perturbed LP
                                     # (tie-breaking toward a vertex of the
                                     # optimal face, like a simplex backend;
                                     # lp/pdhg.py steer_to_vertex). Relative
                                     # perturbation magnitude.
    steer_iters: int = 4000          # warm-started PDHG iters for steering


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: ('data' = instance axis, 'cand' = candidate axis)."""

    data: int = 1
    cand: int = 1


@dataclass(frozen=True)
class RunConfig:
    lp: LPConfig = field(default_factory=LPConfig)
    cuts: CutConfig = field(default_factory=CutConfig)
    scorer: ScorerConfig = field(default_factory=ScorerConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0
    debug: bool = False   # jax NaN-checking + per-round chex state asserts
                          # (utils/debug.py, SURVEY.md section 5.2)


def override(cfg, **kwargs):
    """Functional update helper: override(cfg, lp=override(cfg.lp, tol=1e-7))."""
    return dataclasses.replace(cfg, **kwargs)


def _coerce(value: str, current):
    """Parse a CLI string to the type of the field it replaces."""
    if isinstance(current, bool):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"expected a boolean, got {value!r}")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(int(v) for v in value.split(",") if v)
    return value  # str / Optional[str]


def apply_overrides(cfg: RunConfig, assignments) -> RunConfig:
    """Apply ``section.field=value`` strings (e.g. from repeated CLI --set
    flags) to a RunConfig: apply_overrides(cfg, ["lp.check_every=50",
    "cuts.purge=false", "scorer.hidden=32,32", "seed=7"])."""
    for a in assignments or ():
        try:
            path, value = a.split("=", 1)
        except ValueError:
            raise ValueError(f"override {a!r} is not of form key=value")
        parts = path.split(".")
        if len(parts) == 1:
            (field,) = parts
            cur = getattr(cfg, field)  # raises AttributeError on bad name
            cfg = dataclasses.replace(cfg, **{field: _coerce(value, cur)})
        elif len(parts) == 2:
            section, field = parts
            sec = getattr(cfg, section)
            cur = getattr(sec, field)
            cfg = dataclasses.replace(
                cfg, **{section: dataclasses.replace(
                    sec, **{field: _coerce(value, cur)})})
        else:
            raise ValueError(f"override path too deep: {path!r}")
    return cfg
