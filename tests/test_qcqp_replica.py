"""QCQP CPU replica (baseline/cpu_reference_qcqp.py) and its parity with the
JAX-build CutSolverQCQP — the sparse-path analogue of test_loop.py's
replica-dominance checks (SURVEY.md sections 0.7, 6)."""

import numpy as np

from sdpcutsel_tpu.baseline.cpu_reference_qcqp import cpu_cut_select_qcqp
from sdpcutsel_tpu.config import (
    CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig,
)
from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp
from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP

NAME = "qcqp020-25-4-1"
K, SEL, ROUNDS = 4, 12, 4


def test_replica_monotone_and_cuts():
    inst = load_or_generate_qcqp(NAME)
    hist, rate = cpu_cut_select_qcqp(inst, k=K, sel_size=SEL, rounds=ROUNDS)
    bounds = [h.bound for h in hist]
    assert len(bounds) >= 2
    assert all(b2 <= b1 + 1e-7 for b1, b2 in zip(bounds, bounds[1:]))
    assert hist[0].cuts_added > 0
    assert rate > 0


def test_jax_build_matches_replica():
    inst = load_or_generate_qcqp(NAME)
    hist, _ = cpu_cut_select_qcqp(inst, k=K, sel_size=SEL, rounds=ROUNDS)
    rep = [h.bound for h in hist]

    cfg = RunConfig(
        lp=LPConfig(max_iters=20000, tol=2e-6),
        cuts=CutConfig(k=K, sel_size=SEL, capacity=512, purge=False),
        scorer=ScorerConfig(strategy="feasibility"),
        loop=LoopConfig(rounds=ROUNDS, polish_iters=60000),
    )
    out = CutSolverQCQP(inst, cfg).run(ROUNDS)
    got = [h.bound for h in out]

    # identical relaxation: round-0 bound is the same McCormick+constraints LP
    assert abs(got[0] - rep[0]) / (1.0 + abs(rep[0])) < 1e-3
    # >=95% of the replica's bound improvement (north-star parity bar)
    rep_impr = rep[0] - rep[-1]
    jax_impr = got[0] - got[-1]
    assert rep_impr > 0
    assert jax_impr >= 0.95 * rep_impr


def test_constraint_rows_bind():
    """The linearized quadratic rows must actually constrain the LP: solving
    WITHOUT them (BoxQP-style McCormick only) can only give a looser-or-equal
    round-0 bound, and for this instance strictly looser."""
    from sdpcutsel_tpu.baseline.cpu_reference import cpu_cut_select
    from sdpcutsel_tpu.instances.boxqp import BoxQPInstance

    inst = load_or_generate_qcqp(NAME)
    hist_q, _ = cpu_cut_select_qcqp(inst, k=K, sel_size=SEL, rounds=1)
    relaxed = BoxQPInstance(inst.name, np.asarray(inst.Q0),
                            np.asarray(inst.c0))
    hist_b, _ = cpu_cut_select(relaxed, k=3, sel_size=SEL, rounds=1)
    assert hist_q[0].bound <= hist_b[0].bound + 1e-7
