import jax.numpy as jnp
import numpy as np
import pytest

from sdpcutsel_tpu.config import LPConfig
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.lp import (
    init_state, solve_lp, dual_bound_f64,
)
from sdpcutsel_tpu.lp.oracle import solve_mccormick_highs, tri_to_full
from sdpcutsel_tpu.relax import (
    empty_pool, append_cuts, mccormick_residuals, project_primal,
)


def test_mccormick_residuals_feasible_point():
    x = jnp.array([0.3, 0.8])
    X = jnp.outer(x, x)
    rA, rB = mccormick_residuals(x, X)
    assert (rA >= -1e-6).all() and (rB >= -1e-6).all()


def test_project_primal_symmetry():
    X = jnp.array([[0.5, 2.0], [-1.0, 0.2]])
    x, Xp = project_primal(jnp.array([1.5, -0.2]), X)
    np.testing.assert_allclose(np.asarray(Xp), np.asarray(Xp).T)
    assert (np.asarray(Xp) >= 0).all() and (np.asarray(Xp) <= 1).all()
    np.testing.assert_allclose(np.asarray(x), [1.0, 0.0])


@pytest.mark.parametrize("n,density,seed", [(10, 100, 1), (20, 100, 1), (20, 50, 2)])
def test_pdhg_matches_highs(n, density, seed):
    inst = generate_spar(n, density, seed)
    ref, _, _ = solve_mccormick_highs(inst.Q, inst.c)

    pool = empty_pool(capacity=8, kmax=3)
    st = init_state(n, capacity=8)
    cfg = LPConfig(max_iters=40_000, tol=1e-6)
    st, info = solve_lp(inst.Q, inst.c, pool, st, cfg)

    bound = dual_bound_f64(inst.Q, inst.c, pool, st)
    # dual bound is always a valid upper bound on the LP optimum:
    assert bound >= ref - 1e-4 * (1 + abs(ref))
    # and after convergence it is tight:
    assert abs(bound - ref) <= 2e-3 * (1 + abs(ref))
    # primal objective (max form) close to LP optimum too
    pmax = -float(info["primal_obj"])
    assert abs(pmax - ref) <= 2e-3 * (1 + abs(ref))


def test_pdhg_with_cut_rows_matches_highs():
    n = 10
    inst = generate_spar(n, 100, 3)
    rng = np.random.default_rng(0)
    cuts = []
    k = 3
    for _ in range(5):
        idx = np.sort(rng.choice(n, size=k, replace=False))
        v = rng.normal(size=k + 1)
        v /= np.linalg.norm(v)
        v0, u = v[0], v[1:]
        lin, quad, rhs = 2.0 * v0 * u, np.outer(u, u), -v0 * v0
        nrm = np.sqrt((lin**2).sum() + (quad**2).sum())
        cuts.append((idx, lin / nrm, quad / nrm, rhs / nrm))

    ref, _, _ = solve_mccormick_highs(inst.Q, inst.c, cuts=cuts)

    pool = empty_pool(capacity=8, kmax=3)
    idx = jnp.asarray(np.stack([c[0] for c in cuts]))
    lin = jnp.asarray(np.stack([c[1] for c in cuts]), jnp.float32)
    quad = jnp.asarray(np.stack([c[2] for c in cuts]), jnp.float32)
    rhs = jnp.asarray(np.asarray([c[3] for c in cuts]), jnp.float32)
    pool = append_cuts(pool, idx, lin, quad, rhs, jnp.ones(5))
    assert int(pool.count) == 5

    st = init_state(n, capacity=8)
    cfg = LPConfig(max_iters=40_000, tol=1e-6)
    st, info = solve_lp(inst.Q, inst.c, pool, st, cfg)
    bound = dual_bound_f64(inst.Q, inst.c, pool, st)
    assert bound >= ref - 1e-4 * (1 + abs(ref))
    assert abs(bound - ref) <= 2e-3 * (1 + abs(ref))


def test_highs_oracle_bound_above_true_optimum():
    inst = generate_spar(10, 100, 1)
    ref, x, Xtri = solve_mccormick_highs(inst.Q, inst.c)
    # LP bound must dominate the QP value of its own x (feasible point)
    assert ref >= inst.objective(np.clip(x, 0, 1)) - 1e-8
    X = tri_to_full(Xtri, 10)
    np.testing.assert_allclose(X, X.T)


def test_vertex_steering_stays_optimal_and_sharpens():
    """steer_to_vertex returns a point (a) still on/near the optimal face —
    objective within O(eps) of the LP optimum and still (near-)feasible —
    and (b) more vertex-like on a problem with a genuinely fat optimal face.

    Construction: c has zero entries, Q = 0, so every x_i with c_i = 0 is
    objective-free — the optimal face contains the whole [0,1] segment for
    those coordinates.  PDHG (initialized at 0.5) has no gradient there and
    stays interior; a simplex backend would land on a vertex.  Steering must
    push those free coordinates to their bounds without moving the tied-down
    ones or degrading the objective."""
    import jax

    from sdpcutsel_tpu.lp.pdhg import steer_to_vertex
    from sdpcutsel_tpu.relax import mccormick_residuals

    n = 6
    Q = np.zeros((n, n))
    c = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    ref = 3.0  # LP optimum: x0..2 = 1, x3..5 anywhere in [0, 1]

    pool = empty_pool(capacity=8, kmax=3)
    st = init_state(n, capacity=8)
    cfg = LPConfig(max_iters=20_000, tol=1e-6)
    st, _ = solve_lp(Q, c, pool, st, cfg)
    # PDHG leaves the objective-free coordinates strictly interior
    x0 = np.asarray(st.x)
    assert ((x0[3:] > 0.05) & (x0[3:] < 0.95)).all()

    sx, sX = steer_to_vertex(
        jnp.asarray(Q, jnp.float32), jnp.asarray(c, jnp.float32),
        pool, st, cfg, jax.random.PRNGKey(0), eps=1e-3, iters=8000,
    )

    # (a) objective at steered point ~ LP optimum (still on optimal face)
    obj = float(c @ np.asarray(sx, np.float64))
    assert abs(obj - ref) <= 5e-3 * (1 + abs(ref))
    rA, rB = mccormick_residuals(sx, sX)
    assert float(jnp.minimum(rA, 0.0).min()) > -5e-3
    assert float(jnp.minimum(rB, 0.0).min()) > -5e-3

    # (b) the free coordinates moved to a bound; the tied-down ones stayed
    xs = np.asarray(sx)
    assert ((xs[3:] < 0.05) | (xs[3:] > 0.95)).all()
    assert (xs[:3] > 0.95).all()


def _dot_precisions(fn, *args):
    import jax

    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return out


def test_lp_operator_products_use_highest_precision():
    """Every f32 product of the LP operator — the one-hot support-embedding
    products of the cut block and the dense QCQP rows — asks for
    Precision.HIGHEST, so no backend runs them in TF32 or bf16."""
    import jax

    from sdpcutsel_tpu.relax.cutbuffer import (
        append_cuts, cut_adjoint_emb, cut_residuals_emb, empty_pool,
        support_embedding,
    )
    from sdpcutsel_tpu.relax.denserows import (
        DenseRows, dense_adjoint, dense_residuals,
    )

    n, M, k, m = 9, 16, 3, 2
    rng = np.random.default_rng(0)
    pool = append_cuts(
        empty_pool(M, k),
        jnp.asarray(rng.integers(0, n, (4, k)), jnp.int32),
        jnp.asarray(rng.standard_normal((4, k)), jnp.float32),
        jnp.asarray(rng.standard_normal((4, k, k)), jnp.float32),
        jnp.zeros((4,)), jnp.ones((4,)))
    E3 = support_embedding(pool, n)
    x = jnp.asarray(rng.random(n), jnp.float32)
    X = jnp.asarray(rng.random((n, n)), jnp.float32)
    dense = DenseRows(G=jnp.ones((m, n, n)), g=jnp.ones((m, n)),
                      h=jnp.ones((m,)))
    yC = jnp.ones((M,))
    precs = (
        _dot_precisions(lambda x, X: cut_residuals_emb(x, X, pool, E3), x, X)
        + _dot_precisions(lambda y: cut_adjoint_emb(y, pool, E3), yC)
        + _dot_precisions(lambda x, X: dense_residuals(x, X, dense), x, X)
        + _dot_precisions(lambda y: dense_adjoint(y, dense), jnp.ones((m,))))
    assert len(precs) == 8
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precs), precs
