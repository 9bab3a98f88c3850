"""Triangle (RLT-3) cut family: validity, violation math, end-to-end."""

import jax
import jax.numpy as jnp
import numpy as np

from sdpcutsel_tpu.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu.cuts.enumerate import combinations_table
from sdpcutsel_tpu.cuts.triangle import (
    triangle_select_and_generate, triangle_violations,
)
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.loop import CutSolver
from sdpcutsel_tpu.relax.cutbuffer import append_cuts, cut_residuals, empty_pool


def test_triangle_valid_on_lifted_points():
    """All 4 inequalities hold at X = x x^T for x in [0,1]^n (QPB validity)."""
    rng = np.random.default_rng(0)
    n = 8
    table = jnp.asarray(combinations_table(n, 3))
    for _ in range(20):
        x = jnp.asarray(rng.random(n), jnp.float32)
        X = jnp.outer(x, x)
        v = triangle_violations(x, X, table)
        assert float(jnp.max(v)) <= 1e-5


def test_triangle_tight_at_vertices():
    """At binary x, T0 is tight for all-ones triples and T1 for (1,0,0)."""
    n = 3
    table = jnp.asarray(combinations_table(n, 3))
    x = jnp.asarray([1.0, 1.0, 0.0])
    v = triangle_violations(x, jnp.outer(x, x), table)
    assert abs(float(v[0, 0])) < 1e-6          # T0 tight at two-ones vertex
    x = jnp.asarray([1.0, 0.0, 1.0])
    v = triangle_violations(x, jnp.outer(x, x), table)
    assert abs(float(v[0, 1])) < 1e-6          # T1 tight at (1,0,1)


def test_triangle_detects_violation():
    """A point with X under-estimating pair products violates T0."""
    n = 3
    table = jnp.asarray(combinations_table(n, 3))
    x = jnp.asarray([0.9, 0.9, 0.9])
    X = jnp.zeros((n, n))                      # far below x x^T off-diagonal
    v = triangle_violations(x, X, table)
    assert float(v[0, 0]) > 0.5                # 2.7 - 0 - 1 = 1.7


def test_triangle_rows_match_violations():
    """Emitted rows' residuals equal the (normalized) negated violations."""
    rng = np.random.default_rng(1)
    n = 6
    table = jnp.asarray(combinations_table(n, 3))
    x = jnp.asarray(rng.random(n), jnp.float32)
    X = jnp.asarray(
        np.clip(np.outer(x, x) + 0.3 * rng.standard_normal((n, n)), 0, 1),
        jnp.float32,
    )
    X = 0.5 * (X + X.T)
    sel = 8
    idx, lin, quad, rhs, valid = triangle_select_and_generate(
        x, X, table, sel, 1e-6
    )
    pool = empty_pool(16, 3)
    pool = append_cuts(pool, idx, lin, quad, rhs, valid)
    m = int(pool.count)
    assert m > 0
    res = np.asarray(cut_residuals(x, X, pool))[:m]
    # every emitted row is violated at the point (residual = -viol/norm < 0)
    assert (res < 0).all()
    # recover each row's type from its lin pattern to undo the normalization
    lin_np = np.asarray(pool.lin)[:m]
    # row norm: T0 has lin (-1,-1,-1) and 6 quad entries of 0.5 -> sqrt(4.5);
    # T1-3 have one unit lin entry -> sqrt(2.5)
    norms = np.where(lin_np.sum(1) < -1.0, np.sqrt(4.5), np.sqrt(2.5))
    viol_rows = -res * norms
    viol_all = np.sort(np.asarray(triangle_violations(x, X, table)).ravel())
    top = viol_all[::-1][:m]
    np.testing.assert_allclose(np.sort(viol_rows)[::-1], top, atol=1e-5)


def test_triangle_strategy_end_to_end():
    """The triangle strategy runs and improves the McCormick bound on an
    instance with a real SDP gap."""
    inst = generate_spar(12, 100, 3)
    cfg = RunConfig(
        lp=LPConfig(max_iters=8000, tol=5e-6),
        cuts=CutConfig(k=3, sel_size=12, capacity=256),
        scorer=ScorerConfig(strategy="triangle"),
    )
    s = CutSolver(inst, cfg)
    hist = s.run(rounds=3)
    assert hist[0].cuts_added > 0
    bounds = [h.bound for h in hist]
    assert bounds[-1] < bounds[0] - 1e-3
    # monotone certified bound sequence
    assert all(b2 <= b1 + 1e-9 for b1, b2 in zip(bounds, bounds[1:]))


def test_triangle_replica_matches_jax_rule():
    """The CPU replica's new triangle branch and cuts/triangle.py implement
    the same rows and the same violation scores.  Trajectories are compared
    at a COMMON LP point: at an LP optimum the top violations are massively
    tied (many triples violated by exactly 0.5), so a vertex solver (HiGHS)
    and a first-order solver (PDHG) legitimately select different-but-equal
    candidates and the bound sequences diverge — rule parity is what is
    checkable deterministically."""
    import numpy as np

    from sdpcutsel_tpu.baseline import cpu_cut_select
    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.lp.oracle import solve_mccormick_highs, tri_to_full

    inst = generate_spar(12, 100, 3)
    _, x, Xtri = solve_mccormick_highs(inst.Q, inst.c)
    X = tri_to_full(Xtri, inst.n)
    table_np = combinations_table(inst.n, 3)
    table = jnp.asarray(table_np)

    viol = np.asarray(triangle_violations(
        jnp.asarray(x, jnp.float32), jnp.asarray(X, jnp.float32), table))

    # replica-side violations, same point
    xr = x[table_np]
    Xr = X[table_np[:, :, None], table_np[:, None, :]]
    xi, xj, xl = xr[:, 0], xr[:, 1], xr[:, 2]
    Xij, Xil, Xjl = Xr[:, 0, 1], Xr[:, 0, 2], Xr[:, 1, 2]
    cv = np.stack([
        xi + xj + xl - Xij - Xil - Xjl - 1.0,
        Xij + Xil - Xjl - xi,
        Xij + Xjl - Xil - xj,
        Xil + Xjl - Xij - xl,
    ], axis=1)
    np.testing.assert_allclose(viol, cv, atol=1e-5)

    # and the replica's triangle LOOP runs end-to-end with monotone bounds
    hist, _ = cpu_cut_select(inst, k=3, sel_size=8, rounds=3,
                             strategy="triangle")
    bounds = np.asarray([h.bound for h in hist])
    assert (np.diff(bounds) <= 1e-6 * (1 + np.abs(bounds[:-1]))).all()
    assert hist[0].cuts_added > 0
