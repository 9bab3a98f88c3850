"""SDP-bound denominator validation: the eigencut
upper bound is sandwiched by an independent f64 feasible-point lower bound."""

import numpy as np

from sdpcutsel_tpu.config import LPConfig
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.loop.sdp_bound import (
    sdp_lower_bound, sdp_relaxation_bound, validate_sdp_bound,
)


def test_sdp_lower_bound_valid_on_psd_point():
    """On an already-PSD McCormick point the lower bound equals its
    objective (alpha = 0, no shrinkage)."""
    n = 8
    inst = generate_spar(n, 100, 1)
    x = np.full(n, 0.3)
    X = np.outer(x, x)  # Z = [[1,x'],[x,xx']] is PSD (rank-1 + Schur)
    lb = sdp_lower_bound(inst.Q, inst.c, x, X)
    want = 0.5 * np.sum(inst.Q * X) + inst.c @ x
    # lambda_min evaluates to ~-1e-16 on an exactly-PSD matrix, so the
    # bisection may add an O(1e-9) shrink toward the anchor — allow it
    assert abs(lb - want) <= 1e-6 * (1 + abs(want))


def test_sdp_bound_sandwich_small():
    """Upper (eigencut loop incl. stall-stop) and lower (feasible point)
    agree to ~1e-3 relative — the stall-stop does not materially inflate
    gap-closed denominators.  One small cell here (CPU time); the full
    registry is validated by scripts/validate_sdp_bounds.py, whose rel_width
    per instance is recorded in data/boxqp/bounds.json."""
    inst = generate_spar(12, 100, 3)
    ub, lb, rel = validate_sdp_bound(
        inst, LPConfig(max_iters=8000, tol=2e-6), max_rounds=40)
    assert lb <= ub + 1e-9
    assert rel <= 1e-3, f"ub={ub} lb={lb} rel={rel}"


def test_validate_qcqp_sandwich():
    """QCQP sandwich (round 4): the BM lower bound joins the lifted
    constraint rows into the augmented Lagrangian and the certificate blend
    must satisfy them (row-feasible anchor) — so lb <= ub holds with the
    constraint rows active on both sides."""
    from sdpcutsel_tpu.instances.qcqp import generate_qcqp

    inst = generate_qcqp(10, 40, 2, 1)
    ub, lb, rel = validate_sdp_bound(
        inst, LPConfig(max_iters=6000, tol=2e-6), max_rounds=40)
    assert lb <= ub + 1e-9
    assert rel <= 5e-3, f"ub={ub} lb={lb} rel={rel}"


def test_qcqp_lower_bound_respects_rows():
    """The rows-aware blend must return a point satisfying every QCQP row:
    feed a deliberately row-violating point and check the certified value
    equals the objective at a feasible blend (and asserts fire on a
    row-infeasible anchor)."""
    import pytest

    from sdpcutsel_tpu.instances.qcqp import generate_qcqp
    from sdpcutsel_tpu.loop.sdp_bound import (
        qcqp_interior_anchor, qcqp_rows,
    )

    inst = generate_qcqp(8, 50, 2, 3)
    rows = qcqp_rows(inst)
    anchor = qcqp_interior_anchor(inst)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.4, 0.9, inst.n)          # far from the anchor
    X = np.minimum(x[:, None], x[None, :])     # McCormick face, not PSD
    lb = sdp_lower_bound(inst.Q0, inst.c0, x, X, repair_iters=0,
                         rows=rows, anchor=anchor)
    assert np.isfinite(lb)
    # rows without an anchor must be rejected loudly
    with pytest.raises(ValueError, match="row-feasible anchor"):
        sdp_lower_bound(inst.Q0, inst.c0, x, X, rows=rows)


def test_lower_bound_repair_dominates_raw_blend():
    """Alternating-projection repair must certify at least as tight a lower
    bound as the raw anchor blend, and strictly tighter on a point far from
    the PSD cone (the antitone McCormick face)."""
    import numpy as np

    from sdpcutsel_tpu.instances import load_or_generate

    inst = load_or_generate("spar020-100-1", data_dir="data/boxqp")
    rng = np.random.default_rng(0)
    x = rng.uniform(0.3, 0.7, inst.n)
    X = np.maximum(0.0, x[:, None] + x[None, :] - 1.0)
    np.fill_diagonal(X, x)
    lb_raw = sdp_lower_bound(inst.Q, inst.c, x, X, repair_iters=0)
    lb_rep = sdp_lower_bound(inst.Q, inst.c, x, X)
    assert lb_rep >= lb_raw - 1e-9
    assert lb_rep > lb_raw + 1.0  # strict win on this constructed point


def test_dual_upper_bound_validity():
    """loop/sdp_dual.py: the closed-form Lagrangian dual certificate is a
    true upper bound on the SDP value for ANY multipliers — check it
    sandwiches above the certified BM lower bound and above the (tight at
    this n) eigencut upper bound minus tolerance, from both a cold start
    and a garbage warm start."""
    import numpy as np

    from sdpcutsel_tpu.loop.sdp_dual import dual_upper_bound
    from sdpcutsel_tpu.loop.sdp_primal import bm_feasible_point

    inst = generate_spar(12, 100, 3)
    _, _, lb = bm_feasible_point(inst.Q, inst.c)
    ub, lams = dual_upper_bound(inst.Q, inst.c, maxiter=60)
    assert np.isfinite(ub) and ub >= lb - 1e-6
    # garbage warm start must still yield a VALID (if loose) bound
    rng = np.random.default_rng(0)
    bad = {k: np.abs(rng.standard_normal(v.shape)) for k, v in lams.items()}
    ub2, _ = dual_upper_bound(inst.Q, inst.c, lams=bad,
                              barrier_ts=(1e2,), maxiter=5)
    assert np.isfinite(ub2) and ub2 >= lb - 1e-6
