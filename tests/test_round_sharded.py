"""Sharded instance-batched PRODUCTION round step on the 8-device virtual mesh.

The sharded step must run the same machinery
as the single-chip loop — neural scorer, restarted PDHG, purge, certified
dual bounds — with mesh-layout-independent selection.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sdpcutsel_tpu.cuts.enumerate import combinations_table
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.parallel.mesh import make_mesh
from sdpcutsel_tpu.parallel.round import (
    certify_batched_f64, init_batched_state, make_sharded_round_step,
    shard_batched_state,
)
from sdpcutsel_tpu.parallel.sharding import shard_candidates


def _batch(n, B):
    insts = [generate_spar(n, 100, s + 1) for s in range(B)]
    Qb = jnp.asarray(np.stack([i.Q for i in insts]), jnp.float32)
    cb = jnp.asarray(np.stack([i.c for i in insts]), jnp.float32)
    return Qb, cb


@pytest.mark.parametrize("data,cand", [(2, 4), (4, 2), (1, 8)])
def test_sharded_round_runs_and_bounds_monotone(data, cand):
    n, B = 12, 4
    mesh = make_mesh(data=data, cand=cand)
    Qb, cb = _batch(n, B)

    state = init_batched_state(Qb, cb, capacity=64, kmax=3)
    state = shard_batched_state(state, mesh)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)
    step = make_sharded_round_step(mesh, lp_iters=400, sel_size=4)

    state, info = step(state, table, valid)
    b1 = np.asarray(state.best_bound).copy()
    for _ in range(2):
        state, info = step(state, table, valid)
    b3 = np.asarray(state.best_bound)

    assert b1.shape == (B,)
    # best_bound is a running min of CERTIFIED dual bounds -> exactly monotone
    assert (b3 <= b1 + 1e-6).all()
    counts = np.asarray(state.pool.count)
    assert (counts > 0).any()
    assert np.asarray(info["lp_iters"]).shape == (B,)


@pytest.mark.parametrize("strategy", ["neural", "feasibility"])
def test_mesh_layouts_agree(strategy):
    """Same batched solve on different mesh layouts gives identical cuts
    (deterministic global top-k regardless of sharding) — for the headline
    neural strategy too, not just feasibility."""
    n, B = 12, 2
    Qb, cb = _batch(n, B)

    results = []
    for data, cand in [(1, 2), (2, 4), (1, 8)]:
        mesh = make_mesh(data=data, cand=cand)
        state = init_batched_state(Qb, cb, capacity=64, kmax=3)
        state = shard_batched_state(state, mesh)
        table, valid = shard_candidates(combinations_table(n, 3), mesh)
        step = make_sharded_round_step(mesh, lp_iters=300, sel_size=4,
                                       strategy=strategy)
        state, _ = step(state, table, valid)
        results.append((np.asarray(state.pool.idx), np.asarray(state.pool.count)))

    for idx, cnt in results[1:]:
        np.testing.assert_array_equal(cnt, results[0][1])
        np.testing.assert_array_equal(idx, results[0][0])


def test_sharded_matches_single_chip_loop():
    """The sharded production round reproduces the single-chip CutSolver:
    same selected cut supports and matching certified bounds on round 1,
    bounds within solver noise after 3 rounds."""
    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.loop.solver import CutSolver

    n = 12
    inst = generate_spar(n, 100, 3)
    lp = LPConfig(max_iters=3000, tol=1e-6)
    cuts = CutConfig(k=3, sel_size=6, capacity=64)
    cfg = RunConfig(lp=lp, cuts=cuts, scorer=ScorerConfig(strategy="neural"))

    single = CutSolver(inst, cfg)
    hist = single.run(rounds=3)

    mesh = make_mesh(data=1, cand=8)
    Qb = jnp.asarray(inst.Q, jnp.float32)[None]
    cb = jnp.asarray(inst.c, jnp.float32)[None]
    state = init_batched_state(Qb, cb, capacity=64, kmax=3)
    state = shard_batched_state(state, mesh)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)
    step = make_sharded_round_step(mesh, cfg)
    for _ in range(3):
        state, _ = step(state, table, valid)

    cert = certify_batched_f64(state)
    single_bound = hist[-1].bound
    # both are certified upper bounds on the same instance solved with the
    # same budgets; agree to small relative tolerance (f32 LP path noise)
    assert abs(cert[0] - single_bound) <= 2e-3 * (1.0 + abs(single_bound))
    # f32 on-device certificate close to the f64 host one
    assert abs(float(state.best_bound[0]) - cert[0]) <= 1e-2 * (1 + abs(cert[0]))


def test_certify_batched_f64_valid_vs_oracle():
    """The batched certified bound must be >= the true LP optimum (validity)
    — checked against the HiGHS oracle on a small instance."""
    from sdpcutsel_tpu.lp.oracle import solve_mccormick_highs

    n, B = 10, 2
    Qb, cb = _batch(n, B)
    mesh = make_mesh(data=1, cand=4)
    state = init_batched_state(Qb, cb, capacity=32, kmax=3)
    state = shard_batched_state(state, mesh)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)
    step = make_sharded_round_step(mesh, lp_iters=2000, sel_size=4,
                                   strategy="feasibility")
    state, _ = step(state, table, valid)
    cert = certify_batched_f64(state)
    for i in range(B):
        # McCormick-only LP optimum (no cuts were in the pool during round 1)
        opt, _, _ = solve_mccormick_highs(np.asarray(Qb[i]), np.asarray(cb[i]))
        assert cert[i] >= opt - 1e-6
        assert cert[i] <= opt + 0.05 * (1 + abs(opt))  # and reasonably tight


def test_sharded_diverse_selection_runs_and_layout_invariant():
    """With cuts.diversity_alpha > 0 the consensus merge is the greedy
    support-diverse rule.  On an unconverged LP point scores are untied and
    the rule must coincide with plain top_k (diversity only re-orders ties —
    the spread-on-ties property itself is unit-tested in
    test_cuts.test_diverse_topk_spreads_tied_supports); and the selection
    must stay identical across mesh layouts (the gathered winner set is
    replicated, so the greedy pass is too)."""
    from sdpcutsel_tpu.config import CutConfig, RunConfig

    n, B = 12, 2
    Qb, cb = _batch(n, B)

    def run(alpha, data, cand):
        mesh = make_mesh(data=data, cand=cand)
        table, valid = shard_candidates(combinations_table(n, 3), mesh)
        cfg = RunConfig(cuts=CutConfig(sel_size=6, capacity=64,
                                       diversity_alpha=alpha))
        state = init_batched_state(Qb, cb, capacity=64, kmax=3)
        state = shard_batched_state(state, mesh)
        step = make_sharded_round_step(mesh, cfg, lp_iters=400,
                                       strategy="feasibility")
        for _ in range(2):
            state, _ = step(state, table, valid)
        return state

    s_div = run(1e-4, 2, 4)
    # end-to-end: monotone certified bounds, cuts present
    assert (np.asarray(s_div.best_bound)
            <= np.asarray(s_div.bound) + 1e-5).all()
    assert (np.asarray(s_div.pool.count) > 0).all()

    # untied scores -> same pool as plain top_k
    s_plain = run(0.0, 2, 4)
    np.testing.assert_array_equal(np.asarray(s_div.pool.idx),
                                  np.asarray(s_plain.pool.idx))

    # layout invariance of the diverse merge
    s_div2 = run(1e-4, 1, 8)
    np.testing.assert_array_equal(np.asarray(s_div.pool.idx),
                                  np.asarray(s_div2.pool.idx))
    np.testing.assert_allclose(np.asarray(s_div.best_bound),
                               np.asarray(s_div2.best_bound), rtol=2e-5)


def test_scan_step_matches_per_round_steps():
    """make_sharded_scan_step (all rounds in one dispatch) reproduces the
    step-per-dispatch path: same pools, same per-round certified f64 bounds
   ."""
    from sdpcutsel_tpu.parallel.round import (
        certify_scan_f64, make_sharded_scan_step,
    )

    n, B, R = 12, 4, 3
    mesh = make_mesh(data=2, cand=4)
    Qb, cb = _batch(n, B)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)

    # per-round path, recertifying after every step
    state_a = shard_batched_state(
        init_batched_state(Qb, cb, capacity=64, kmax=3), mesh)
    step = make_sharded_round_step(mesh, lp_iters=400, sel_size=4)
    per_round_bounds = []
    for _ in range(R):
        state_a, _ = step(state_a, table, valid)
        per_round_bounds.append(certify_batched_f64(state_a))
    per_round = np.minimum.accumulate(np.stack(per_round_bounds), axis=0)

    # scan path, one dispatch
    state_b = shard_batched_state(
        init_batched_state(Qb, cb, capacity=64, kmax=3), mesh)
    scan = make_sharded_scan_step(mesh, rounds=R, lp_iters=400, sel_size=4)
    state_b, outs = scan(state_b, table, valid)
    scan_bounds = certify_scan_f64(state_b.Q, state_b.c, outs)

    assert scan_bounds.shape == (R, B)
    np.testing.assert_array_equal(np.asarray(state_b.pool.count),
                                  np.asarray(state_a.pool.count))
    np.testing.assert_array_equal(np.asarray(state_b.pool.idx),
                                  np.asarray(state_a.pool.idx))
    # certificates: scan round r pairs solve-time pool with solve duals;
    # per-round path certifies AFTER the append, so compare the final-round
    # running-min bounds (identical dual trajectories up to f32 dispatch
    # noise) plus monotonicity of the scan sequence
    np.testing.assert_allclose(scan_bounds[-1], per_round[-1],
                               rtol=1e-4, atol=1e-5)
    assert (np.diff(scan_bounds, axis=0) <= 1e-9).all()


def test_scan_step_with_purge_and_neural():
    from sdpcutsel_tpu.parallel.round import (
        certify_scan_f64, make_sharded_scan_step,
    )
    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, RunConfig, ScorerConfig,
    )

    n, B, R = 12, 2, 3
    mesh = make_mesh(data=1, cand=8)
    Qb, cb = _batch(n, B)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)
    cfg = RunConfig(
        lp=LPConfig(max_iters=300),
        cuts=CutConfig(k=3, sel_size=4, capacity=64, purge=True),
        scorer=ScorerConfig(strategy="neural"),
    )
    state = shard_batched_state(
        init_batched_state(Qb, cb, capacity=64, kmax=3), mesh)
    scan = make_sharded_scan_step(mesh, cfg, rounds=R)
    state, outs = scan(state, table, valid)
    bounds = certify_scan_f64(state.Q, state.c, outs)
    assert np.isfinite(bounds).all()
    assert (np.diff(bounds, axis=0) <= 1e-9).all()
    assert (np.asarray(state.pool.count) > 0).any()
