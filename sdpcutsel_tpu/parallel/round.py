"""Fully sharded cutting-plane round step: P1 (candidate axis) x P2 (instance
axis) on one mesh (SURVEY.md section 2.3) at production parity with the
single-chip loop (loop/solver.py).

One jitted shard_map over mesh ('data', 'cand'):
  * each 'data' row holds a shard of the instance batch (independent BoxQP /
    QCQP problems, padded to a common n) — no collectives cross 'data';
  * within a row, the candidate table is sharded over 'cand'; the LP state is
    replicated over 'cand' (every chip re-solves its instances' LPs — the LP
    is tiny next to scoring, so replication beats communication);
  * the only collective: per-round all_gather of each shard's local top-k cut
    candidates over 'cand' (P5 consensus), after which every chip appends the
    IDENTICAL cut rows, keeping the replicated pool/LP state consistent by
    construction.

Production parity means the step runs the SAME machinery as the single-chip
loop, not a toy: warm-started restarted averaged PDHG (lp/pdhg._solve_impl —
restarts, ergodic averaging, omega rebalancing, KKT-based stopping), every
scoring strategy (feasibility / neural / combined / random), slack-based cut
purging, and a certified dual bound (the f32 on-device Lagrangian certificate
each round; use certify_batched_f64 for the final f64 host recertification —
both are valid for ANY dual y >= 0, see lp/pdhg.py).

This is the step `__graft_entry__.dryrun_multichip` compiles over an
N-virtual-device mesh, and the scale-out path for the instance-batched suite
benchmark (BASELINE.json configs 4-5).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CutConfig, LPConfig, RunConfig, ScorerConfig
from ..cuts.assemble import assemble_Z
from ..cuts.eigen import batched_eigh_small, feasibility_scores_from_point
from ..cuts.generate import cuts_from_selected
from ..lp.pdhg import PDHGState, _dual_bound, _solve_impl, estimate_norm
from ..relax.cutbuffer import (
    CutPool, append_cuts, cut_residuals, empty_pool, purge_pool,
)
from ..relax.denserows import DenseRows


class BatchedRoundState(NamedTuple):
    """Instance-batched solver state; leading axis = instance batch B."""

    Q: jnp.ndarray        # (B, n, n)
    c: jnp.ndarray        # (B, n)
    pool: CutPool         # leaves with leading (B, ...)
    pdhg: PDHGState       # leaves with leading (B, ...)
    key: jnp.ndarray      # (B, 2) per-instance PRNG keys (random strategy)
    bound: jnp.ndarray    # (B,) this round's certified f32 dual bound (max form)
    best_bound: jnp.ndarray  # (B,) running min of certified bounds (monotone)


def _state_specs() -> BatchedRoundState:
    """Every state leaf is sharded over the instance axis."""
    return BatchedRoundState(
        Q=P("data"), c=P("data"),
        pool=CutPool(*(P("data"),) * 6),
        pdhg=PDHGState(*(P("data"),) * 6),
        key=P("data"), bound=P("data"), best_bound=P("data"),
    )


def empty_batched_dense(B: int, n: int, m: int = 0, dtype=jnp.float32) -> DenseRows:
    """Batched dense-row block: (B, m, n, n) etc. m=0 for BoxQP."""
    return DenseRows(
        G=jnp.zeros((B, m, n, n), dtype=dtype),
        g=jnp.zeros((B, m, n), dtype=dtype),
        h=jnp.zeros((B, m), dtype=dtype),
    )


def init_batched_state(Qb, cb, capacity: int, kmax: int, dtype=jnp.float32,
                       m_dense: int = 0, seed: int = 0) -> BatchedRoundState:
    from ..lp.pdhg import init_state

    B, n = cb.shape
    pool = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), empty_pool(capacity, kmax, dtype)
    )
    st = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        init_state(n, capacity, m_dense, dtype)
    )
    inf = jnp.full((B,), jnp.inf, dtype)
    return BatchedRoundState(
        Q=jnp.asarray(Qb, dtype), c=jnp.asarray(cb, dtype),
        pool=CutPool(*pool), pdhg=PDHGState(*st),
        key=jax.random.split(jax.random.PRNGKey(seed), B),
        bound=inf, best_bound=inf,
    )


def _make_local_scorer(scorer: ScorerConfig, k: int):
    """Local-shard scorer: fn(x, X, key, Q, table_shard) -> (Tshard,) scores.

    Runs independently per ('data' instance, 'cand' shard) — x, X are
    replicated over 'cand', the table rows are the shard's slice.  Strategies
    mirror loop/solver.py's (SURVEY.md section 0.4); "neural" computes the
    per-candidate Q features (models/features.py) on the fly from the
    replicated Q, so nothing instance-specific needs pre-sharding.
    """
    strat = scorer.strategy

    if strat == "feasibility":
        def score(x, X, key, Q, table):
            return feasibility_scores_from_point(x, X, table)
        return score

    if strat == "random":
        def score(x, X, key, Q, table):
            key = jax.random.fold_in(key, jax.lax.axis_index("cand"))
            return jax.random.uniform(key, (table.shape[0],), dtype=x.dtype)
        return score

    if strat in ("neural", "combined"):
        from ..models.features import candidate_q_features
        from ..models.scorer import generic_scores, load_params

        params, _ = load_params(k, tuple(scorer.hidden), scorer.weights_path,
                                scorer.seed)
        neg = -jnp.inf

        def score(x, X, key, Q, table):
            triQ, scale = candidate_q_features(Q, table)
            nn, viol = generic_scores(x, X, table, triQ, scale, params)
            if strat == "combined":
                return jnp.where(viol > 0.0, nn, neg)
            return nn
        return score

    raise ValueError(f"unsupported sharded strategy: {strat}")


def _instance_round(Q, c, pool, st, key, best, table_shard, valid_shard,
                    dense, score_local, lp: LPConfig, cuts: CutConfig):
    """One instance's full production round on one device's candidate shard
    (inside shard_map, inside vmap over the row's local instances)."""
    n = c.shape[0]
    dtype = c.dtype
    cx, cX = -c, -0.5 * Q

    # 1. warm-started restarted averaged PDHG (same solver as single-chip)
    normK = estimate_norm(pool, n, lp.power_iters, dtype, dense)
    st, info = _solve_impl(
        cx, cX, pool, dense, st, normK, lp.omega0, lp.tol, lp.feas_tol,
        lp.step_scale, lp.max_iters, min(lp.check_every, lp.max_iters),
        lp.restart_period,
    )
    # certified dual bound (valid for any y >= 0; f32 on-device evaluation —
    # recertify in f64 on host via certify_batched_f64 for reported numbers)
    d = _dual_bound(cx, cX, pool, dense, st.yA, st.yB, st.yC, st.yD, n)
    bound = -d
    best = jnp.minimum(best, bound)

    # 2. score the local candidate shard -> local top-k
    key, sub = jax.random.split(key)
    scores = score_local(st.x, st.X, sub, Q, table_shard)
    neg = jnp.asarray(-jnp.inf, dtype)
    scores = jnp.where(valid_shard, scores, neg)
    lv, li = jax.lax.top_k(scores, cuts.sel_size)
    rows = table_shard[li]

    # 3. P5 consensus: all_gather local winners over 'cand', global top-k.
    # With diversity_alpha > 0 the global merge is the greedy support-diverse
    # rule (ops/topk.diverse_topk) over the gathered winners — the same
    # tie-clustering fix as the single-chip loop; the gathered set is
    # identical on every shard, so the consensus selection still is too.
    gv = jax.lax.all_gather(lv, "cand", tiled=True)
    gr = jax.lax.all_gather(rows, "cand", tiled=True)
    if cuts.diversity_alpha > 0.0:
        from ..ops.topk import diverse_topk

        v, i, sel_valid = diverse_topk(gv, gr, cuts.sel_size, n,
                                       cuts.diversity_alpha)
        idx_sel = gr[i]
    else:
        v, i = jax.lax.top_k(gv, cuts.sel_size)
        idx_sel = gr[i]
        sel_valid = jnp.isfinite(v)

    # 4. eigh of selected Z(rho) -> violated cut rows
    w, V = batched_eigh_small(assemble_Z(st.x, st.X, idx_sel))
    idx_r, lin_r, quad_r, rhs_r, valid_r = cuts_from_selected(
        idx_sel, w, V, cuts.viol_tol, sel_valid=sel_valid
    )

    # 5. purge slack cuts, then append (same order as loop/solver._post_lp)
    yC = st.yC
    # solve-time cut duals, pre-purge: these pair with the pool the LP was
    # solved against — the scan path stacks them for host f64
    # recertification of every round's bound
    info = {**info, "yC_solve": st.yC}
    if cuts.purge:
        slack = cut_residuals(st.x, st.X, pool)
        pool, yC = purge_pool(pool, yC, slack, cuts.purge_slack_tol)
    pool = append_cuts(pool, idx_r, lin_r, quad_r, rhs_r, valid_r)
    st = st._replace(yC=yC)
    return pool, st, key, bound, best, info


def make_sharded_round_step(
    mesh: Mesh,
    cfg: Optional[RunConfig] = None,
    *,
    lp_iters: Optional[int] = None,
    sel_size: Optional[int] = None,
    viol_tol: Optional[float] = None,
    strategy: Optional[str] = None,
    m_dense: int = 0,
    kmax: int = 3,
):
    """Build the jitted sharded production round step over the given mesh.

    Knobs come from ``cfg`` (defaults to RunConfig()); the keyword overrides
    are conveniences for benches/tests.

    Returns step(state: BatchedRoundState, table, valid, dense=None)
    -> (state, info) with shardings: state leaves over 'data', table over
    'cand'; info = per-instance {'lp_iters', 'kkt_error'} arrays.
    """
    import dataclasses

    cfg = cfg or RunConfig()
    lp = cfg.lp
    if lp_iters is not None:
        lp = dataclasses.replace(lp, max_iters=lp_iters)
    cuts = cfg.cuts
    if sel_size is not None:
        cuts = dataclasses.replace(cuts, sel_size=sel_size)
    if viol_tol is not None:
        cuts = dataclasses.replace(cuts, viol_tol=viol_tol)
    scorer = cfg.scorer
    if strategy is not None:
        scorer = dataclasses.replace(scorer, strategy=strategy)
    score_local = _make_local_scorer(scorer, kmax)

    dense_spec = DenseRows(G=P("data"), g=P("data"), h=P("data"))

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(_state_specs(), P("cand", None), P("cand"), dense_spec),
        out_specs=(_state_specs(), {"lp_iters": P("data"),
                                    "kkt_error": P("data")}),
        check_vma=False,
    )
    def step(state: BatchedRoundState, table_shard, valid_shard, dense):
        def per_instance(Q, c, pool, st, key, best, dn):
            return _instance_round(
                Q, c, pool, st, key, best, table_shard, valid_shard, dn,
                score_local, lp, cuts,
            )

        pool, st, key, bound, best, info = jax.vmap(per_instance)(
            state.Q, state.c, state.pool, state.pdhg, state.key,
            state.best_bound, dense,
        )
        out = BatchedRoundState(state.Q, state.c, pool, st, key, bound, best)
        return out, {"lp_iters": info["iters"], "kkt_error": info["kkt_error"]}

    jstep = jax.jit(step)

    def apply(state: BatchedRoundState, table, valid,
              dense: Optional[DenseRows] = None):
        if dense is None:
            B, n = state.c.shape
            dense = empty_batched_dense(B, n, m_dense, state.c.dtype)
            dense = jax.tree.map(
                lambda a: jax.device_put(a, NamedSharding(mesh, P("data"))),
                dense,
            )
        return jstep(state, table, valid, dense)

    return apply


def make_sharded_scan_step(
    mesh: Mesh,
    cfg: Optional[RunConfig] = None,
    *,
    rounds: int,
    lp_iters: Optional[int] = None,
    sel_size: Optional[int] = None,
    viol_tol: Optional[float] = None,
    strategy: Optional[str] = None,
    m_dense: int = 0,
    kmax: int = 3,
):
    """Scan-over-rounds variant of make_sharded_round_step: lax.scan over
    ``rounds`` INSIDE the shard_map, so the whole batched multi-round solve
    is ONE dispatch — the per-round host crossing that remains in the
    step-per-dispatch path (SURVEY.md section 3.5) disappears.

    Per round the scan stacks each instance's solve-time pool + full dual
    set, exactly like loop/solver.CutSolver._scan_impl, so
    ``certify_scan_f64`` can recertify every round's bound in f64 on host
    afterwards — identical certificates to the per-round path.

    Returns apply(state, table, valid, dense=None) -> (state, outs) where
    outs leaves have a leading round axis (rounds, B, ...).
    """
    import dataclasses

    cfg = cfg or RunConfig()
    lp = cfg.lp
    if lp_iters is not None:
        lp = dataclasses.replace(lp, max_iters=lp_iters)
    cuts = cfg.cuts
    if sel_size is not None:
        cuts = dataclasses.replace(cuts, sel_size=sel_size)
    if viol_tol is not None:
        cuts = dataclasses.replace(cuts, viol_tol=viol_tol)
    scorer = cfg.scorer
    if strategy is not None:
        scorer = dataclasses.replace(scorer, strategy=strategy)
    score_local = _make_local_scorer(scorer, kmax)

    dense_spec = DenseRows(G=P("data"), g=P("data"), h=P("data"))
    rb = P(None, "data")                    # (rounds, B, ...) leaves
    outs_spec = {
        "pool": CutPool(*(rb,) * len(CutPool._fields)),
        "yA": rb, "yB": rb, "yC": rb, "yD": rb,
        "lp_iters": rb, "kkt_error": rb, "count": rb,
    }

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(_state_specs(), P("cand", None), P("cand"), dense_spec),
        out_specs=(_state_specs(), outs_spec),
        check_vma=False,
    )
    def scan_step(state: BatchedRoundState, table_shard, valid_shard, dense):
        def per_instance(Q, c, pool, st, key, best, dn):
            return _instance_round(
                Q, c, pool, st, key, best, table_shard, valid_shard, dn,
                score_local, lp, cuts,
            )

        def body(state, _):
            prev_pool = state.pool          # the pool each LP was solved on
            pool, st, key, bound, best, info = jax.vmap(per_instance)(
                state.Q, state.c, state.pool, state.pdhg, state.key,
                state.best_bound, dense,
            )
            out = {
                "pool": prev_pool,
                "yA": st.yA, "yB": st.yB, "yC": info["yC_solve"],
                "yD": st.yD,
                "lp_iters": info["iters"], "kkt_error": info["kkt_error"],
                "count": pool.count,
            }
            new = BatchedRoundState(state.Q, state.c, pool, st, key, bound,
                                    best)
            return new, out

        return jax.lax.scan(body, state, None, length=rounds)

    jstep = jax.jit(scan_step)

    def apply(state: BatchedRoundState, table, valid,
              dense: Optional[DenseRows] = None):
        if dense is None:
            B, n = state.c.shape
            dense = empty_batched_dense(B, n, m_dense, state.c.dtype)
            dense = jax.tree.map(
                lambda a: jax.device_put(a, NamedSharding(mesh, P("data"))),
                dense,
            )
        return jstep(state, table, valid, dense)

    return apply


def certify_scan_f64(Q, c, outs, dense: Optional[DenseRows] = None,
                     prev_best: Optional[np.ndarray] = None) -> np.ndarray:
    """Host f64 recertification of every (round, instance) bound from a
    make_sharded_scan_step run.  Returns (rounds, B) certified max-form
    upper bounds, cummin over rounds (every certificate is independently
    valid, so the running min is too — mirrors CutSolver.run_scan)."""
    from ..lp.pdhg import dual_bound_f64

    Q = np.asarray(Q)
    c = np.asarray(c)
    pool_np = jax.tree.map(np.asarray, outs["pool"])
    yA, yB, yC, yD = (np.asarray(outs[k]) for k in ("yA", "yB", "yC", "yD"))
    dense_np = jax.tree.map(np.asarray, dense) if dense is not None else None
    R, B = yA.shape[0], yA.shape[1]
    n = c.shape[1]
    bounds = np.empty((R, B), np.float64)
    best = (np.asarray(prev_best, np.float64).copy()
            if prev_best is not None else np.full((B,), np.inf))
    for r in range(R):
        for i in range(B):
            pool_ri = CutPool(*(leaf[r, i] for leaf in pool_np))
            st_ri = PDHGState(
                x=np.zeros(n, np.float64), X=np.zeros((n, n), np.float64),
                yA=yA[r, i], yB=yB[r, i], yC=yC[r, i], yD=yD[r, i],
            )
            dn_i = (DenseRows(*(leaf[i] for leaf in dense_np))
                    if dense_np is not None and dense_np.h.shape[1] > 0
                    else None)
            best[i] = min(best[i], dual_bound_f64(Q[i], c[i], pool_ri, st_ri,
                                                  dense=dn_i))
            bounds[r, i] = best[i]
    return bounds


def certify_batched_f64(state: BatchedRoundState,
                        dense: Optional[DenseRows] = None) -> np.ndarray:
    """Host-side f64 recertification of every instance's bound (lp/pdhg.
    dual_bound_f64, incl. the per-block dual polish).  Returns (B,) certified
    max-form upper bounds — use these for reported/benchmarked numbers; the
    on-device state.bound is the same certificate evaluated in f32."""
    from ..lp.pdhg import dual_bound_f64

    B = int(state.c.shape[0])
    pool_np = jax.tree.map(np.asarray, state.pool)
    st_np = jax.tree.map(np.asarray, state.pdhg)
    Q = np.asarray(state.Q)
    c = np.asarray(state.c)
    dense_np = jax.tree.map(np.asarray, dense) if dense is not None else None
    out = np.empty((B,), np.float64)
    for i in range(B):
        pool_i = CutPool(*(leaf[i] for leaf in pool_np))
        st_i = PDHGState(*(leaf[i] for leaf in st_np))
        dn_i = (DenseRows(*(leaf[i] for leaf in dense_np))
                if dense_np is not None and dense_np.h.shape[1] > 0 else None)
        out[i] = dual_bound_f64(Q[i], c[i], pool_i, st_i, dense=dn_i)
    return out


def bucket_instances(instances):
    """Group instances by n for batched solving (SURVEY.md section 7:
    instance batching is per-size-bucket — XLA needs one static n per
    compiled program; padding across n would waste quadratic work).
    Returns {n: [instances]} with deterministic ordering."""
    buckets: dict[int, list] = {}
    for inst in instances:
        buckets.setdefault(inst.n, []).append(inst)
    return dict(sorted(buckets.items()))


def shard_batched_state(state: BatchedRoundState, mesh: Mesh):
    """Place a batched state with instance leaves sharded over 'data'."""
    sh = NamedSharding(mesh, P("data"))
    return jax.tree.map(lambda a: jax.device_put(a, sh), state)
