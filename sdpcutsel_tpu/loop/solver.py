"""The cutting-plane round controller — the equivalent of the reference's
``CutSolver.cut_select_algo`` entry point (SURVEY.md sections 0.5, 3.1).

Per round, entirely on device inside three jit regions:
  1. re-solve the relaxation (warm-started restarted PDHG, lp/pdhg.py),
  2. score ALL candidates under the configured strategy, take the top
     ``sel_size``, eigendecompose only the selected Z(rho), emit violated
     cut rows,
  3. purge slack cuts and append the new rows to the fixed-capacity pool.

The host loop only orchestrates rounds, fetches O(1) scalars for logging
(SURVEY.md section 3.5), computes the certified f64 bound from the duals, and
checkpoints.

Strategies (SURVEY.md section 0.4): "feasibility", "optimality" (exact
subproblem oracle), "neural" (trained MLP estimate — the headline method),
"random", "combined", plus "triangle" (RLT-3 comparison baseline,
cuts/triangle.py).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RunConfig
from ..cuts.assemble import assemble_Z
from ..cuts.eigen import batched_eigh_small, feasibility_scores_from_point
from ..cuts.enumerate import combinations_table
from ..cuts.generate import cuts_from_selected
from ..instances.boxqp import BoxQPInstance
from ..lp.pdhg import PDHGState, dual_bound_f64, init_state, solve_lp
from ..ops.topk import diverse_topk, masked_topk
from ..relax.cutbuffer import (
    CutPool, append_cuts, cut_residuals, empty_pool, purge_pool,
)


@dataclasses.dataclass
class RoundStats:
    round: int
    bound: float          # certified f64 upper bound after this round's solve
    lp_iters: int
    lp_kkt_error: float
    cuts_added: int
    cuts_active: int
    wall_time_s: float


@functools.partial(
    jax.jit, static_argnames=("sel_size", "viol_tol", "diversity_alpha")
)
def _select_and_generate(x, X, table, scores, sel_size: int, viol_tol: float,
                         diversity_alpha: float = 0.0):
    """Top-sel_size candidates by score -> eigh(Z) -> violated cut rows.

    diversity_alpha > 0 switches to greedy support-diverse selection
    (ops/topk.py diverse_topk) — same scores, tie-broken toward low-overlap
    index subsets instead of lax.top_k's lexicographic clustering."""
    if diversity_alpha > 0.0:
        _, sel, valid = diverse_topk(scores, table, sel_size, x.shape[0],
                                     diversity_alpha)
    else:
        _, sel, valid = masked_topk(scores, sel_size)
    idx_sel = table[sel]                       # (S, k)
    Z = assemble_Z(x, X, idx_sel)              # (S, k+1, k+1)
    w, V = batched_eigh_small(Z)
    rows = cuts_from_selected(idx_sel, w, V, viol_tol, sel_valid=valid)
    # sel: selected table positions (S,); valid: selection-level mask (S,)
    return rows + (sel, valid)


@jax.jit
def _feasibility_all(x, X, table):
    return feasibility_scores_from_point(x, X, table)


class CheckpointableSolver:
    """Round-granular checkpoint/resume shared by the BoxQP and QCQP solvers
    (SURVEY.md section 5.4): snapshot = (cut pool, PDHG warm-start state, RNG
    key, history).  Subclasses provide .inst, .cfg, .pool, .state, .key,
    .history."""

    def _checkpoint_path(self) -> Optional[str]:
        lc = self.cfg.loop
        if not lc.checkpoint_every or not lc.checkpoint_dir:
            return None
        import os

        return os.path.join(lc.checkpoint_dir, f"{self.inst.name}.ck")

    def _maybe_checkpoint(self):
        path = self._checkpoint_path()
        if path is None:
            return
        if len(self.history) % self.cfg.loop.checkpoint_every == 0:
            self.checkpoint(path)

    def _extra_meta(self) -> dict:
        """Subclass hook: extra JSON-serializable state to snapshot (the
        QCQP solver stores its selection-cooldown vector here)."""
        return {}

    def _restore_extra(self, meta: dict):
        pass

    def checkpoint(self, path: str):
        from ..utils.checkpoint import save_checkpoint

        save_checkpoint(
            path, self.pool, self.state, self.key,
            [dataclasses.asdict(h) for h in self.history],
            {"instance": self.inst.name, "strategy": self.cfg.scorer.strategy,
             **self._extra_meta()},
        )

    def restore(self, path: str):
        """Resume from a snapshot written by checkpoint() — the loop is
        round-granular restartable (cut pool + PDHG warm start + RNG key +
        history)."""
        from ..utils.checkpoint import load_checkpoint

        pd, sd, key, hist, meta = load_checkpoint(path)
        if meta.get("instance") != self.inst.name:
            raise ValueError(
                f"checkpoint is for {meta.get('instance')}, "
                f"not {self.inst.name}"
            )
        self.pool = CutPool(**{f: jnp.asarray(v) for f, v in pd.items()})
        self.state = PDHGState(**{f: jnp.asarray(v) for f, v in sd.items()})
        self.key = jnp.asarray(key)
        self.history = [RoundStats(**h) for h in hist]
        self._restore_extra(meta)
        return self


class CutSolver(CheckpointableSolver):
    """One BoxQP instance; dense candidate set of all C(n, k) subsets."""

    def __init__(
        self,
        inst: BoxQPInstance,
        cfg: RunConfig,
        score_fn: Optional[Callable] = None,
        dtype=jnp.float32,
    ):
        self.inst = inst
        self.cfg = cfg
        self.dtype = dtype
        n = inst.n
        self.Q = jnp.asarray(inst.Q, dtype)
        self.c = jnp.asarray(inst.c, dtype)
        self.table = jnp.asarray(combinations_table(n, cfg.cuts.k))
        self.table_valid = jnp.ones((self.table.shape[0],), bool)
        self.pool: CutPool = empty_pool(cfg.cuts.capacity, cfg.cuts.k, dtype)
        self.state: PDHGState = init_state(n, cfg.cuts.capacity, 0, dtype)
        self.key = jax.random.PRNGKey(cfg.seed)
        self.history: list[RoundStats] = []
        self._custom_score = score_fn is not None
        if score_fn is not None:
            # custom score hook: gets the base consts (table + mask);
            # strategy-specific consts belong to the default strategies only
            self._score_consts = {"table": self.table,
                                  "valid": self.table_valid}
            self._score_fn = score_fn
        else:
            self._score_fn = self._default_score_fn()
        if cfg.debug:
            from ..utils.debug import enable_debug_mode

            enable_debug_mode()

    # -- scoring strategies -------------------------------------------------
    # Score functions take (x, X, key, consts) where ``consts`` is a pytree
    # of per-instance arrays (table, triQ, scale, MLP weights, ...) that is
    # passed THROUGH the jit as arguments: baking them as closure constants
    # would force a fresh compile for every instance.
    def _default_score_fn(self) -> Callable:
        strat = self.cfg.scorer.strategy
        neg = jnp.asarray(-jnp.inf, self.dtype)

        def masked(s, consts):
            return jnp.where(consts["valid"], s, neg)

        self._score_consts = {"table": self.table, "valid": self.table_valid}
        if strat == "feasibility":
            return lambda x, X, key, consts: masked(
                _feasibility_all(x, X, consts["table"]), consts)
        if strat == "random":
            return lambda x, X, key, consts: masked(jax.random.uniform(
                key, (consts["table"].shape[0],), dtype=self.dtype), consts)
        if strat in ("neural", "combined"):
            from ..models.scorer import neural_score_fn

            fn = neural_score_fn(
                self.Q, self.table, self.cfg.scorer,
                combined=(strat == "combined"),
            )
            return lambda x, X, key, consts: masked(fn(x, X, key), consts)
        if strat == "triangle":
            if self.cfg.cuts.k != 3:
                raise ValueError(
                    "triangle strategy requires k=3 (RLT-3 inequalities are "
                    f"defined on triples); got k={self.cfg.cuts.k}")
            from ..cuts.triangle import triangle_scores

            return lambda x, X, key, consts: masked(
                triangle_scores(x, X, consts["table"]), consts)
        if strat == "optimality":
            from ..models.labels import exact_score_fn

            fn = exact_score_fn(self.Q, self.table)
            return lambda x, X, key, consts: masked(fn(x, X, key), consts)
        raise ValueError(f"unknown strategy: {strat}")

    # -- one round ----------------------------------------------------------
    def _post_lp(self, x, X, pool, yC, key, consts):
        """Fused post-solve stage: score ALL candidates -> top-k -> eigh of
        selected -> cut rows -> purge -> append, in ONE jit dispatch
        (SURVEY.md section 3.5)."""
        cfg = self.cfg
        if cfg.scorer.strategy == "triangle":
            from ..cuts.triangle import triangle_select_and_generate

            idx_r, lin_r, quad_r, rhs_r, valid_r = triangle_select_and_generate(
                x, X, consts["table"], cfg.cuts.sel_size, cfg.cuts.viol_tol,
                table_mask=consts["valid"],
            )
        else:
            scores = self._score_fn(x, X, key, consts)
            idx_r, lin_r, quad_r, rhs_r, valid_r, _sel, _selv = _select_and_generate(
                x, X, consts["table"], scores, cfg.cuts.sel_size,
                cfg.cuts.viol_tol, cfg.cuts.diversity_alpha,
            )
        if cfg.cuts.purge:
            slack = cut_residuals(x, X, pool)
            pool, yC = purge_pool(pool, yC, slack, cfg.cuts.purge_slack_tol)
        kept = pool.count
        pool = append_cuts(pool, idx_r, lin_r, quad_r, rhs_r, valid_r)
        return pool, yC, kept

    def do_round(self) -> RoundStats:
        t0 = time.perf_counter()
        cfg = self.cfg
        self.state, info = solve_lp(self.Q, self.c, self.pool, self.state, cfg.lp)
        bound = dual_bound_f64(self.inst.Q, self.inst.c, self.pool, self.state)
        # every certificate is valid, so the running minimum is too — report
        # it to keep the bound sequence monotone even when a later, harder LP
        # stops at max_iters with less-converged duals
        if self.history:
            bound = min(bound, self.history[-1].bound)

        self.key, sub = jax.random.split(self.key)
        score_x, score_X = self.state.x, self.state.X
        if cfg.loop.steer_eps > 0.0:
            # tie-breaking toward a vertex of the optimal face; scoring-only
            # (the certified bound above is from the UNperturbed duals)
            from ..lp.pdhg import steer_to_vertex

            self.key, skey = jax.random.split(self.key)
            score_x, score_X = steer_to_vertex(
                self.Q, self.c, self.pool, self.state, cfg.lp, skey,
                cfg.loop.steer_eps, cfg.loop.steer_iters,
            )
        if not hasattr(self, "_post_lp_jit"):
            self._post_lp_jit = jax.jit(self._post_lp)
        self.pool, yC, kept = self._post_lp_jit(
            score_x, score_X, self.pool, self.state.yC, sub,
            self._score_consts,
        )
        self.state = self.state._replace(yC=yC)
        added = int(self.pool.count) - int(kept)

        if cfg.debug:
            from ..utils.debug import check_round_state

            check_round_state(self.state.x, self.state.X, self.pool, bound)

        stats = RoundStats(
            round=len(self.history),
            bound=bound,
            lp_iters=int(info["iters"]),
            lp_kkt_error=float(info["kkt_error"]),
            cuts_added=added,
            cuts_active=int(self.pool.count),
            wall_time_s=time.perf_counter() - t0,
        )
        self.history.append(stats)
        return stats

    # -- all rounds in one dispatch ------------------------------------------
    def _scan_impl(self, Q, c, pool, st, key, consts, rounds: int):
        """lax.scan over rounds: (solve -> steer -> score/select/cutgen ->
        purge/append) x R entirely on device.  Per-round outputs stack the
        PRE-mutation pool and the solve's duals so the host can recertify
        every round's bound in f64 afterwards (lp/pdhg.dual_bound_f64) —
        identical certificates to the per-round path, one dispatch total."""
        from ..lp.pdhg import _solve_impl, _steer_impl, estimate_norm
        from ..relax.denserows import empty_dense

        lp = self.cfg.lp
        lc = self.cfg.loop
        n = c.shape[0]
        cx, cX = -c, -0.5 * Q

        def body(carry, _):
            pool, st, key = carry
            normK = estimate_norm(pool, n, lp.power_iters, cx.dtype)
            st, info = _solve_impl(
                cx, cX, pool, empty_dense(n, cx.dtype), st, normK, lp.omega0,
                lp.tol, lp.feas_tol, lp.step_scale, lp.max_iters,
                lp.check_every, lp.restart_period,
            )
            key, sub = jax.random.split(key)
            sx, sX = st.x, st.X
            if lc.steer_eps > 0.0:
                key, skey = jax.random.split(key)
                sx, sX = _steer_impl(
                    cx, cX, pool, empty_dense(n, cx.dtype), st, normK,
                    jnp.asarray(lp.omega0, cx.dtype), lp.step_scale,
                    jnp.asarray(lc.steer_eps, cx.dtype), skey, lc.steer_iters,
                )
            new_pool, yC, kept = self._post_lp(sx, sX, pool, st.yC, sub,
                                               consts)
            out = (pool, (st.yA, st.yB, st.yC),
                   info["iters"], info["kkt_error"], kept, new_pool.count)
            return (new_pool, st._replace(yC=yC), key), out

        (pool, st, key), outs = jax.lax.scan(
            body, (pool, st, key), None, length=rounds)
        return (pool, st, key), outs

    # Shared jitted-scan cache across solver INSTANCES: the scan program
    # depends only on (cfg, n, dtype, backend) — all per-instance data (Q,
    # c, pool, state, scorer consts) flows through as arguments — but
    # jax.jit keys on the bound method's identity, so a fresh solver per
    # instance would re-TRACE the whole multi-round program.  Suite runs
    # create one solver per instance, so this cache converts the re-trace
    # into a dict hit.  Solvers with a CUSTOM score_fn bypass it (their
    # closure behavior is not captured by the key).
    _scan_cache: dict = {}

    def run_scan(self, rounds: Optional[int] = None) -> list[RoundStats]:
        """Run ALL rounds in one jit dispatch (LoopConfig.use_scan).

        Same machinery per round as do_round (certified f64 bounds included,
        recomputed on host from the stacked duals); trades away per-round
        early stopping and checkpointing for zero per-round dispatch/transfer
        overhead — the right mode for benchmarked suite runs through a
        high-latency link."""
        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        t0 = time.perf_counter()
        if not hasattr(self, "_scan_jit"):
            if self._custom_score:
                self._scan_jit = jax.jit(self._scan_impl,
                                         static_argnames=("rounds",))
            else:
                key_ = (type(self), self.cfg, self.inst.n, str(self.dtype),
                        jax.default_backend())
                cached = CutSolver._scan_cache.get(key_)
                if cached is None:
                    cached = jax.jit(self._scan_impl,
                                     static_argnames=("rounds",))
                    CutSolver._scan_cache[key_] = cached
                self._scan_jit = cached
        (self.pool, self.state, self.key), outs = jax.block_until_ready(
            self._scan_jit(self.Q, self.c, self.pool, self.state, self.key,
                           self._score_consts, rounds=rounds))
        total = time.perf_counter() - t0

        pools, duals, iters, kkt, kept, count = outs
        pools_np = jax.tree.map(np.asarray, pools)
        yA, yB, yC = (np.asarray(a) for a in duals)
        iters, kkt = np.asarray(iters), np.asarray(kkt)
        kept, count = np.asarray(kept), np.asarray(count)
        prev_bound = self.history[-1].bound if self.history else np.inf
        base = len(self.history)
        for r in range(rounds):
            pool_r = CutPool(*(leaf[r] for leaf in pools_np))
            st_r = PDHGState(
                x=np.zeros(self.inst.n, np.float64),
                X=np.zeros((self.inst.n, self.inst.n), np.float64),
                yA=yA[r], yB=yB[r], yC=yC[r], yD=np.zeros((0,), np.float64),
            )
            b = dual_bound_f64(self.inst.Q, self.inst.c, pool_r, st_r)
            b = min(b, prev_bound)
            prev_bound = b
            self.history.append(RoundStats(
                round=base + r, bound=b, lp_iters=int(iters[r]),
                lp_kkt_error=float(kkt[r]),
                cuts_added=int(count[r]) - int(kept[r]),
                cuts_active=int(count[r]),
                wall_time_s=total / rounds,
            ))
        if self.cfg.loop.polish_iters > 0 and self.history:
            self.polish()
        return self.history

    def run(self, rounds: Optional[int] = None) -> list[RoundStats]:
        if self.cfg.loop.use_scan:
            return self.run_scan(rounds)
        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        prev = None
        for _ in range(rounds):
            s = self.do_round()
            self._maybe_checkpoint()
            if prev is not None:
                rel = abs(prev - s.bound) / (1.0 + abs(prev))
                if rel < self.cfg.loop.improvement_tol and s.cuts_added == 0:
                    break
            prev = s.bound
        if self.cfg.loop.polish_iters > 0 and self.history:
            self.polish()
        return self.history

    def polish(self) -> float:
        """Final tighter LP re-solve over the existing cut pool (no new cuts)
        — recovers certified-bound accuracy when per-round LP solves stopped
        at max_iters.  Updates the last round's recorded bound (the running
        minimum of valid certificates stays valid)."""
        tight = dataclasses.replace(
            self.cfg.lp,
            max_iters=self.cfg.loop.polish_iters,
            tol=self.cfg.lp.tol * 1e-2,
        )
        self.state, _ = solve_lp(self.Q, self.c, self.pool, self.state, tight)
        b = dual_bound_f64(self.inst.Q, self.inst.c, self.pool, self.state)
        if self.history:
            b = min(b, self.history[-1].bound)
            self.history[-1].bound = b
        return b

    @property
    def bounds(self) -> np.ndarray:
        return np.asarray([s.bound for s in self.history])
