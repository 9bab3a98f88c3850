"""Checkpoint/resume of the cutting-plane loop: interrupted == uninterrupted."""

import numpy as np

from sdpcutsel_tpu.config import CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.loop import CutSolver


def _cfg(tmp=None):
    return RunConfig(
        lp=LPConfig(max_iters=8000, tol=2e-6),
        cuts=CutConfig(k=3, sel_size=8, capacity=128),
        scorer=ScorerConfig(strategy="feasibility"),
        loop=LoopConfig(rounds=4, checkpoint_every=1,
                        checkpoint_dir=str(tmp) if tmp else None),
    )


def test_resume_matches_uninterrupted(tmp_path):
    inst = generate_spar(12, 100, 3)

    # uninterrupted: 4 rounds
    ref = CutSolver(inst, _cfg())
    ref.run(rounds=4)
    ref_bounds = np.asarray([h.bound for h in ref.history])

    # interrupted after 2 rounds, resumed in a fresh solver
    a = CutSolver(inst, _cfg(tmp_path))
    a.run(rounds=2)
    ck = a._checkpoint_path()

    b = CutSolver(inst, _cfg(tmp_path)).restore(ck)
    assert len(b.history) == 2
    b.run(rounds=2)
    b_bounds = np.asarray([h.bound for h in b.history])

    assert len(b_bounds) == 4
    np.testing.assert_allclose(b_bounds, ref_bounds, rtol=1e-5)


def test_qcqp_resume_matches_uninterrupted(tmp_path):
    """QCQP solver has the same round-granular checkpoint/resume as BoxQP
   : resumed run == uninterrupted run."""
    from sdpcutsel_tpu.instances.qcqp import generate_qcqp
    from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP

    inst = generate_qcqp(12, 40, 2, 1)

    def cfg(tmp=None):
        return RunConfig(
            lp=LPConfig(max_iters=4000, tol=2e-6),
            cuts=CutConfig(k=3, sel_size=6, capacity=128),
            scorer=ScorerConfig(strategy="feasibility"),
            loop=LoopConfig(rounds=4, checkpoint_every=1,
                            checkpoint_dir=str(tmp) if tmp else None),
        )

    ref = CutSolverQCQP(inst, cfg())
    ref.run(rounds=4)
    ref_bounds = np.asarray([h.bound for h in ref.history])

    a = CutSolverQCQP(inst, cfg(tmp_path))
    a.run(rounds=2)
    b = CutSolverQCQP(inst, cfg(tmp_path)).restore(a._checkpoint_path())
    assert len(b.history) == 2
    b.run(rounds=2)
    b_bounds = np.asarray([h.bound for h in b.history])

    assert len(b_bounds) == 4
    np.testing.assert_allclose(b_bounds, ref_bounds, rtol=1e-5)


def test_qcqp_resume_preserves_cooldown(tmp_path):
    """The cross-round selection cooldown must survive a
    checkpoint-resume, or the resumed run silently diverges from a
    continuous one at the default sel_cooldown."""
    from sdpcutsel_tpu.instances.qcqp import generate_qcqp
    from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP

    inst = generate_qcqp(12, 40, 2, 1)

    def cfg(gate):
        return RunConfig(
            lp=LPConfig(max_iters=4000, tol=2e-6),
            cuts=CutConfig(k=3, sel_size=6, capacity=128, sel_gate=gate,
                           sel_cooldown=3),
            scorer=ScorerConfig(strategy="feasibility"),
            loop=LoopConfig(rounds=3, checkpoint_every=1,
                            checkpoint_dir=str(tmp_path)),
        )

    a = CutSolverQCQP(inst, cfg("cooldown"))
    a.run(rounds=3)
    cd = np.asarray(a._cooldown)
    assert cd.max() > 0, "test needs a non-trivial cooldown state"
    b = CutSolverQCQP(inst, cfg("cooldown")).restore(a._checkpoint_path())
    np.testing.assert_array_equal(np.asarray(b._cooldown), cd)

    # residual gate (the default): last_viol state must survive resume too
    a = CutSolverQCQP(inst, cfg("residual"))
    a.run(rounds=3)
    lv = np.asarray(a._last_viol)
    assert np.isfinite(lv).any(), "test needs a non-trivial last_viol state"
    b = CutSolverQCQP(inst, cfg("residual")).restore(a._checkpoint_path())
    np.testing.assert_array_equal(np.asarray(b._last_viol), lv)


def test_restore_rejects_wrong_instance(tmp_path):
    import pytest

    inst = generate_spar(12, 100, 3)
    a = CutSolver(inst, _cfg(tmp_path))
    a.run(rounds=1)
    other = generate_spar(12, 100, 4)
    with pytest.raises(ValueError, match="checkpoint is for"):
        CutSolver(other, _cfg(tmp_path)).restore(a._checkpoint_path())
