"""QCQP cutting-plane loop end-to-end on CPU vs HiGHS oracle."""

import numpy as np
import pytest

from sdpcutsel_tpu.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu.instances.qcqp import generate_qcqp
from sdpcutsel_tpu.lp.oracle import solve_mccormick_highs
from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP


@pytest.fixture(scope="module")
def inst():
    return generate_qcqp(12, 40, 3, 2)


def test_qcqp_relaxation_matches_highs(inst):
    """Round-0 bound (no cuts) must match the HiGHS lifted-LP optimum."""
    cfg = RunConfig(
        lp=LPConfig(max_iters=30_000, tol=1e-6),
        cuts=CutConfig(k=4, sel_size=8, capacity=128),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    solver = CutSolverQCQP(inst, cfg)
    s0 = solver.do_round()

    ref, _, _ = solve_mccormick_highs(
        inst.Q0, inst.c0,
        qcons=list(zip(inst.Qs, inst.cs, inst.bs)),
    )
    assert s0.bound >= ref - 1e-4 * (1 + abs(ref))
    assert abs(s0.bound - ref) <= 5e-3 * (1 + abs(ref))


def test_qcqp_loop_improves(inst):
    cfg = RunConfig(
        lp=LPConfig(max_iters=20_000, tol=2e-6),
        cuts=CutConfig(k=4, sel_size=8, capacity=128),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    solver = CutSolverQCQP(inst, cfg)
    hist = solver.run(rounds=3)
    bounds = np.asarray([h.bound for h in hist])
    assert (np.diff(bounds) <= 1e-3 * (1 + np.abs(bounds[:-1]))).all()
    # candidate set came from cliques only
    assert solver.table.shape[1] == 4


def test_qcqp_triangle_strategy():
    """Triangle (RLT-3) baseline runs on the QCQP clique candidates (k=3)
    and keeps the certified bound monotone."""
    from sdpcutsel_tpu.instances.qcqp import generate_qcqp

    inst3 = generate_qcqp(12, 40, 2, 2)
    cfg = RunConfig(
        lp=LPConfig(max_iters=8_000, tol=2e-6),
        cuts=CutConfig(k=3, sel_size=6, capacity=128),
        scorer=ScorerConfig(strategy="triangle"),
    )
    solver = CutSolverQCQP(inst3, cfg)
    hist = solver.run(rounds=3)
    bounds = np.asarray([h.bound for h in hist])
    assert (np.diff(bounds) <= 1e-6).all()  # running-min certified bounds
    assert hist[0].cuts_added >= 0 and solver.table.shape[1] == 3
