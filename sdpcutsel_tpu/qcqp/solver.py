"""QCQP cutting-plane solver — reference's ``CutSolverQCQP`` equivalent
(SURVEY.md sections 0.7, 3.4).

Same round loop as loop/solver.CutSolver, with three differences:
  * the relaxation carries the linearized quadratic constraint rows
    1/2 <Qi, X> + ci'x <= bi as a DenseRows block inside the PDHG solve;
  * the candidate table is NOT all C(n,k) subsets but the <=kmax subsets of
    the maximal cliques of the chordal extension of the sparsity graph
    (qcqp/chordal.py), padded to width kmax by repeating the last index
    (duplicated indices keep Z(rho) PSD-valid: dup(Z) = S'ZS for a
    selection-with-repetition S, so cuts remain valid and violation carries
    over);
  * submatrix dimension kmax goes up to 5 (6x6 eigh — the Jacobi is
    generic in m).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..config import RunConfig
from ..cuts.assemble import assemble_Z
from ..cuts.eigen import batched_eigh_small, feasibility_scores_from_point
from ..cuts.generate import cuts_from_selected
from ..instances.qcqp import QCQPInstance
from ..loop.solver import CheckpointableSolver, RoundStats, _select_and_generate
from ..lp.pdhg import PDHGState, dual_bound_f64, init_state, solve_lp
from ..relax.cutbuffer import (
    CutPool, append_cuts, cut_residuals, empty_pool, purge_pool,
)
from ..relax.denserows import dense_from_qcqp, empty_dense
from .chordal import chordal_decomposition, clique_candidates


class CutSolverQCQP(CheckpointableSolver):
    def __init__(self, inst: QCQPInstance, cfg: RunConfig,
                 score_fn: Optional[Callable] = None, dtype=jnp.float32):
        self.inst = inst
        self.cfg = cfg
        self.dtype = dtype
        n = inst.n
        self.Q = jnp.asarray(inst.Q0, dtype)
        self.c = jnp.asarray(inst.c0, dtype)
        self.dense = (
            dense_from_qcqp(inst.Qs, inst.cs, inst.bs, dtype)
            if inst.m > 0 else empty_dense(n, dtype)
        )
        cliques, _ = chordal_decomposition(n, inst.sparsity_graph())
        self.cliques = cliques
        table_np = clique_candidates(cliques, cfg.cuts.k)
        if table_np.shape[0] == 0:
            raise ValueError("no candidate subsets: sparsity graph is empty")
        self.table = jnp.asarray(table_np)
        self.table_valid = jnp.ones((table_np.shape[0],), dtype=bool)
        self.pool: CutPool = empty_pool(cfg.cuts.capacity, cfg.cuts.k, dtype)
        self.state: PDHGState = init_state(n, cfg.cuts.capacity, inst.m, dtype)
        self.key = jax.random.PRNGKey(cfg.seed)
        # cross-round re-selection gate state (CutConfig.sel_gate; see
        # do_round): "cooldown" counts rounds remaining before a selected
        # candidate may be re-picked; "residual" remembers each candidate's
        # violation when last selected (+inf = never selected) and re-admits
        # it only once the LP has actually enforced its cut
        self._cooldown = jnp.zeros((self.table.shape[0],), jnp.int32)
        self._last_viol = jnp.full((self.table.shape[0],), jnp.inf, dtype)
        self.history: list[RoundStats] = []
        self._score_fn = score_fn or self._default_score_fn()
        if cfg.debug:
            from ..utils.debug import enable_debug_mode

            enable_debug_mode()

    def _extra_meta(self) -> dict:
        """Cross-round re-selection gate state rides the snapshot metadata
        (resuming without it silently reset the gate and
        diverged from a continuous run at the default config)."""
        import numpy as np

        return {"cooldown": np.asarray(self._cooldown).tolist(),
                "last_viol": np.asarray(self._last_viol).tolist()}

    def _restore_extra(self, meta: dict):
        cd = meta.get("cooldown")
        if cd is not None and len(cd) == self.table.shape[0]:
            self._cooldown = jnp.asarray(cd, jnp.int32)
        lv = meta.get("last_viol")
        if lv is not None and len(lv) == self.table.shape[0]:
            self._last_viol = jnp.asarray(lv, self.dtype)

    # -- cross-round re-selection gate (CutConfig.sel_gate) -----------------
    def _gate_scores(self, scores, x, X, kkt_error, cooldown, last_viol):
        """Mask scores before selection.  "residual": a candidate stays
        masked while its CURRENT violation is >= gate_eta x the violation it
        was last selected at — the LP has not yet enforced that cut, so a
        re-pick would duplicate it; the signal is per-candidate and
        self-timing (no round-count knob — the 0.92/0.98
        k=5 cooldown sensitivity).  "cooldown": round-counted mask, applied
        only while the solve is under-converged (KKT gate).  Returns
        (gated_scores, feas) where feas is the violation vector the residual
        gate computed (None otherwise)."""
        cfg = self.cfg
        feas = None
        if cfg.cuts.sel_gate == "residual":
            feas = feasibility_scores_from_point(x, X, self.table)
            blocked = feas > cfg.cuts.gate_eta * last_viol
            scores = jnp.where(blocked, -jnp.inf, scores)
        elif cfg.cuts.sel_gate == "cooldown" and cfg.cuts.sel_cooldown > 0:
            lag = kkt_error > cfg.cuts.cooldown_kkt_tol
            scores = jnp.where((cooldown > 0) & lag, -jnp.inf, scores)
        return scores, feas

    def _gate_update(self, sel_r, selv_r, feas, cooldown, last_viol):
        """Post-selection state update for the active gate."""
        cfg = self.cfg
        if cfg.cuts.sel_gate == "residual":
            # floor at viol_tol: selections are violated by > viol_tol, and
            # the floor keeps eta*last_viol meaningfully positive
            new = jnp.where(selv_r,
                            jnp.maximum(feas[sel_r], cfg.cuts.viol_tol),
                            last_viol[sel_r])
            last_viol = last_viol.at[sel_r].set(new)
        elif cfg.cuts.sel_gate == "cooldown" and cfg.cuts.sel_cooldown > 0:
            cd = jnp.maximum(cooldown - 1, 0)
            cooldown = cd.at[sel_r].set(
                jnp.where(selv_r, cfg.cuts.sel_cooldown, cd[sel_r]))
        return cooldown, last_viol

    def _default_score_fn(self) -> Callable:
        strat = self.cfg.scorer.strategy
        neg = jnp.asarray(-jnp.inf, self.dtype)
        valid = self.table_valid

        def masked(s):
            return jnp.where(valid, s, neg)

        if strat == "feasibility":
            return jax.jit(
                lambda x, X, key: masked(
                    feasibility_scores_from_point(x, X, self.table))
            )
        if strat == "random":
            return lambda x, X, key: masked(jax.random.uniform(
                key, (self.table.shape[0],), dtype=self.dtype
            ))
        if strat in ("neural", "combined"):
            from ..models.scorer import neural_score_fn

            # rank VIOLATED candidates by the NN estimate.  A candidate below
            # viol_tol cannot emit a cut (cuts/generate.py uses the same
            # threshold), so an ungated NN ranking stalls the loop as soon as
            # its top sel_size candidates all have their cuts in the pool:
            # nothing new is ever added and the bound freezes (observed on
            # qcqp020-25-4-1, flat from round 3 of 8).  The clique candidate
            # table is small enough that this happens within a few rounds,
            # unlike the dense C(n,3) BoxQP table.
            fn = neural_score_fn(self.Q, self.table, self.cfg.scorer,
                                 combined=True,
                                 gate_tol=self.cfg.cuts.viol_tol)
            return lambda x, X, key: masked(fn(x, X, key))
        if strat == "optimality":
            from ..models.labels import exact_score_fn

            fn = exact_score_fn(self.Q, self.table)
            return lambda x, X, key: masked(fn(x, X, key))
        if strat == "triangle":
            # handled structurally in do_round (RLT-3 rows need no eigh);
            # scoring-only callers still get the violation ranking
            if self.cfg.cuts.k != 3:
                raise ValueError(
                    "triangle strategy requires k=3 (RLT-3 inequalities are "
                    f"defined on triples); got k={self.cfg.cuts.k}")
            from ..cuts.triangle import triangle_scores

            return jax.jit(
                lambda x, X, key: masked(triangle_scores(x, X, self.table)))
        raise ValueError(f"unknown strategy: {strat}")

    def do_round(self) -> RoundStats:
        t0 = time.perf_counter()
        cfg = self.cfg
        self.state, info = solve_lp(
            self.Q, self.c, self.pool, self.state, cfg.lp, dense=self.dense
        )
        bound = dual_bound_f64(self.inst.Q0, self.inst.c0, self.pool,
                               self.state, dense=self.dense)
        if self.history:
            bound = min(bound, self.history[-1].bound)

        x, X = self.state.x, self.state.X
        self.key, sub = jax.random.split(self.key)
        if cfg.loop.steer_eps > 0.0:
            # vertex steering for the SCORING point only (see
            # lp/pdhg.steer_to_vertex): a simplex backend scores at a vertex
            # of the optimal face; PDHG's interior-face point spreads clique
            # violations differently, which on the SMALL clique tables of
            # the sparse path can plateau the bound while the replica's
            # vertex-hopping grinds on (observed qcqp030-25-6-1, round 4).
            # The certified bound above stays the unperturbed one.
            from ..lp.pdhg import steer_to_vertex

            self.key, skey = jax.random.split(self.key)
            x, X = steer_to_vertex(
                self.Q, self.c, self.pool, self.state, cfg.lp, skey,
                cfg.loop.steer_eps, cfg.loop.steer_iters, dense=self.dense,
            )
        if cfg.scorer.strategy == "triangle":
            from ..cuts.triangle import triangle_select_and_generate

            idx_r, lin_r, quad_r, rhs_r, valid_r = triangle_select_and_generate(
                x, X, self.table, cfg.cuts.sel_size, cfg.cuts.viol_tol,
                table_mask=self.table_valid,
            )
        else:
            scores = self._score_fn(x, X, sub)
            # cross-round re-selection gate (sparse-path PDHG artifact): an
            # under-converged re-solve leaves last round's selections still
            # "violated", so an unmasked ranking re-picks them and fills the
            # pool with duplicates while the bound plateaus (observed
            # qcqp030-25-6-1: 208 cuts, 55 unique supports).  A simplex
            # replica never needs this — its exact re-solve kills selected
            # violations in one round.  See _gate_scores for the two modes.
            scores, feas_g = self._gate_scores(
                scores, x, X, info["kkt_error"],
                self._cooldown, self._last_viol)
            (idx_r, lin_r, quad_r, rhs_r, valid_r, sel_r,
             selv_r) = _select_and_generate(
                x, X, self.table, scores, cfg.cuts.sel_size,
                cfg.cuts.viol_tol, cfg.cuts.diversity_alpha,
            )
            self._cooldown, self._last_viol = self._gate_update(
                sel_r, selv_r, feas_g, self._cooldown, self._last_viol)

        if cfg.cuts.purge:
            slack = cut_residuals(x, X, self.pool)
            self.pool, yC = purge_pool(
                self.pool, self.state.yC, slack, cfg.cuts.purge_slack_tol
            )
            self.state = self.state._replace(yC=yC)

        before = int(self.pool.count)
        self.pool = append_cuts(self.pool, idx_r, lin_r, quad_r, rhs_r, valid_r)
        added = int(self.pool.count) - before

        if cfg.debug:
            from ..utils.debug import check_round_state

            check_round_state(self.state.x, self.state.X, self.pool, bound)

        stats = RoundStats(
            round=len(self.history), bound=bound,
            lp_iters=int(info["iters"]),
            lp_kkt_error=float(info["kkt_error"]),
            cuts_added=added, cuts_active=int(self.pool.count),
            wall_time_s=time.perf_counter() - t0,
        )
        self.history.append(stats)
        return stats

    # -- all rounds in one dispatch ------------------------------------------
    def _scan_impl(self, Q, c, pool, st, key, rounds: int):
        """lax.scan over rounds for the QCQP path:
        same per-round machinery as do_round — PDHG solve WITH the dense
        constraint block, score (clique table), select, purge, append — in
        ONE dispatch.  Stacks each round's solve-time pool + full dual set
        (incl. yD for the dense rows) so the host recertifies every bound in
        f64 afterwards, exactly like loop/solver.CutSolver._scan_impl."""
        from ..lp.pdhg import _solve_impl, _steer_impl, estimate_norm

        lp = self.cfg.lp
        lc = self.cfg.loop
        cfg = self.cfg
        n = c.shape[0]
        cx, cX = -c, -0.5 * Q
        dense = self.dense

        def body(carry, _):
            pool, st, key, cooldown, last_viol = carry
            normK = estimate_norm(pool, n, lp.power_iters, cx.dtype,
                                  dense=dense)
            st, info = _solve_impl(
                cx, cX, pool, dense, st, normK, lp.omega0, lp.tol,
                lp.feas_tol, lp.step_scale, lp.max_iters, lp.check_every,
                lp.restart_period,
            )
            key, sub = jax.random.split(key)
            x, X = st.x, st.X
            if lc.steer_eps > 0.0:
                key, skey = jax.random.split(key)
                x, X = _steer_impl(
                    cx, cX, pool, dense, st, normK,
                    jnp.asarray(lp.omega0, cx.dtype), lp.step_scale,
                    jnp.asarray(lc.steer_eps, cx.dtype), skey,
                    lc.steer_iters)
            if cfg.scorer.strategy == "triangle":
                from ..cuts.triangle import triangle_select_and_generate

                idx_r, lin_r, quad_r, rhs_r, valid_r = (
                    triangle_select_and_generate(
                        x, X, self.table, cfg.cuts.sel_size,
                        cfg.cuts.viol_tol, table_mask=self.table_valid))
            else:
                scores = self._score_fn(x, X, sub)
                scores, feas_g = self._gate_scores(
                    scores, x, X, info["kkt_error"], cooldown, last_viol)
                (idx_r, lin_r, quad_r, rhs_r, valid_r, sel_r,
                 selv_r) = _select_and_generate(
                    x, X, self.table, scores, cfg.cuts.sel_size,
                    cfg.cuts.viol_tol, cfg.cuts.diversity_alpha,
                )
                cooldown, last_viol = self._gate_update(
                    sel_r, selv_r, feas_g, cooldown, last_viol)
            solve_pool, yC = pool, st.yC   # round-r certificate pairs these
            if cfg.cuts.purge:
                slack = cut_residuals(x, X, pool)
                pool, yC = purge_pool(pool, yC, slack,
                                      cfg.cuts.purge_slack_tol)
            kept = pool.count
            new_pool = append_cuts(pool, idx_r, lin_r, quad_r, rhs_r, valid_r)
            out = (solve_pool, (st.yA, st.yB, st.yC, st.yD),
                   info["iters"], info["kkt_error"], kept, new_pool.count)
            return (new_pool, st._replace(yC=yC), key, cooldown,
                    last_viol), out

        (pool, st, key, cd, lv), outs = jax.lax.scan(
            body, (pool, st, key, self._cooldown, self._last_viol),
            None, length=rounds)
        return (pool, st, key, cd, lv), outs

    def run_scan(self, rounds: Optional[int] = None) -> list[RoundStats]:
        """All rounds in one jit dispatch; certified f64 bounds recomputed
        on host from the stacked duals (see CutSolver.run_scan)."""
        import numpy as np

        rounds = rounds if rounds is not None else self.cfg.loop.rounds
        t0 = time.perf_counter()
        if not hasattr(self, "_scan_jit"):
            self._scan_jit = jax.jit(self._scan_impl,
                                     static_argnames=("rounds",))
        (self.pool, self.state, self.key, self._cooldown,
         self._last_viol), outs = \
            jax.block_until_ready(
                self._scan_jit(self.Q, self.c, self.pool, self.state,
                               self.key, rounds=rounds))
        total = time.perf_counter() - t0

        pools, duals, iters, kkt, kept, count = outs
        pools_np = jax.tree.map(np.asarray, pools)
        yA, yB, yC, yD = (np.asarray(a) for a in duals)
        iters, kkt = np.asarray(iters), np.asarray(kkt)
        kept, count = np.asarray(kept), np.asarray(count)
        prev_bound = self.history[-1].bound if self.history else np.inf
        base = len(self.history)
        n = self.inst.n
        for r in range(rounds):
            pool_r = CutPool(*(leaf[r] for leaf in pools_np))
            st_r = PDHGState(
                x=np.zeros(n, np.float64),
                X=np.zeros((n, n), np.float64),
                yA=yA[r], yB=yB[r], yC=yC[r], yD=yD[r],
            )
            b = dual_bound_f64(self.inst.Q0, self.inst.c0, pool_r, st_r,
                               dense=self.dense)
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
        """Final tighter LP re-solve (no new cuts); see CutSolver.polish."""
        import dataclasses

        tight = dataclasses.replace(
            self.cfg.lp,
            max_iters=self.cfg.loop.polish_iters,
            tol=self.cfg.lp.tol * 1e-2,
        )
        self.state, _ = solve_lp(self.Q, self.c, self.pool, self.state,
                                 tight, dense=self.dense)
        b = dual_bound_f64(self.inst.Q0, self.inst.c0, self.pool, self.state,
                           dense=self.dense)
        if self.history:
            b = min(b, self.history[-1].bound)
            self.history[-1].bound = b
        return b
