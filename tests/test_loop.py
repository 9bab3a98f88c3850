"""End-to-end cutting-plane loop tests on a small instance (CPU, f32)."""

import numpy as np
import pytest

from sdpcutsel_tpu.baseline import cpu_cut_select
from sdpcutsel_tpu.config import CutConfig, LPConfig, RunConfig, ScorerConfig, override
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.loop import CutSolver


def small_cfg(strategy="feasibility", sel=10, rounds=4):
    return RunConfig(
        lp=LPConfig(max_iters=15_000, tol=2e-6),
        cuts=CutConfig(k=3, sel_size=sel, capacity=256),
        scorer=ScorerConfig(strategy=strategy),
    )


@pytest.fixture(scope="module")
def inst10():
    return generate_spar(12, 100, 3)


def test_loop_bound_monotone_and_dominates_cpu(inst10):
    cfg = small_cfg()
    solver = CutSolver(inst10, cfg)
    hist = solver.run(rounds=4)
    bounds = np.asarray([h.bound for h in hist])
    # adding cuts never worsens the bound (up to solver tolerance)
    assert (np.diff(bounds) <= 1e-3 * (1 + np.abs(bounds[:-1]))).all()
    # cuts were actually added
    assert hist[0].cuts_added > 0

    # CPU replica with the same strategy/selection
    cpu_hist, _ = cpu_cut_select(
        inst10, k=3, sel_size=10, rounds=4, strategy="feasibility"
    )
    cpu_bounds = np.asarray([h.bound for h in cpu_hist])
    # round 0 is the plain McCormick bound on both paths
    np.testing.assert_allclose(bounds[0], cpu_bounds[0], rtol=2e-3)
    # final JAX-loop bound should close a comparable amount of gap
    drop_jax = bounds[0] - bounds[-1]
    drop_cpu = cpu_bounds[0] - cpu_bounds[-1]
    assert drop_jax >= 0.8 * drop_cpu - 1e-3


def test_random_strategy_runs(inst10):
    solver = CutSolver(inst10, small_cfg("random"))
    hist = solver.run(rounds=2)
    assert len(hist) == 2
    assert hist[-1].bound <= hist[0].bound + 1e-3


def test_final_polish_tightens_bound():
    """polish_iters > 0 re-solves the final LP tighter and can only improve
    (never worsen) the certified final bound."""
    import dataclasses

    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.loop import CutSolver

    inst = generate_spar(12, 100, 3)
    base = RunConfig(
        lp=LPConfig(max_iters=1500, tol=1e-7),   # deliberately starved
        cuts=CutConfig(k=3, sel_size=10, capacity=128),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    s1 = CutSolver(inst, base)
    h1 = s1.run(rounds=3)
    b_plain = h1[-1].bound

    s2 = CutSolver(inst, dataclasses.replace(
        base, loop=dataclasses.replace(base.loop, polish_iters=20000)))
    h2 = s2.run(rounds=3)
    b_polished = h2[-1].bound

    assert b_polished <= b_plain + 1e-9
    assert b_polished < b_plain - 1e-4   # starved LP leaves real slack


def test_loop_with_vertex_steering_runs_and_stays_valid():
    """End-to-end rounds with LoopConfig.steer_eps > 0: the steered point is
    scoring-only, so bounds remain certified and monotone, and cuts are
    still generated.  (Mechanism unit test: test_pdhg vertex steering.)"""
    import dataclasses

    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.loop import CutSolver

    inst = generate_spar(12, 100, 3)
    cfg = RunConfig(
        lp=LPConfig(max_iters=6000, tol=1e-6),
        cuts=CutConfig(k=3, sel_size=10, capacity=128),
        scorer=ScorerConfig(strategy="feasibility"),
        loop=LoopConfig(rounds=3, steer_eps=1e-3, steer_iters=1500),
    )
    sol = CutSolver(inst, cfg)
    hist = sol.run(rounds=3)
    bounds = [h.bound for h in hist]
    assert all(b2 <= b1 + 1e-9 for b1, b2 in zip(bounds, bounds[1:]))
    assert bounds[-1] < bounds[0] - 1e-3
    assert sum(h.cuts_added for h in hist) > 0
