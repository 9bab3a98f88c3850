"""LP solver: restarted, averaged PDHG (PDLP-style).

This replaces the reference's CPLEX dual-simplex backend (SURVEY.md section
2.1, R5).  A simplex method is a serial, data-dependent pivot process — the
opposite of what an accelerator wants — so the design is a first-order
primal-dual method whose every iteration is a handful of fused dense (n, n)
elementwise maps plus small cut-row products, all inside one jit region:

    min  cobj' z   s.t.  K z >= h,  z in Z
    Z = {x in [0,1]^n} x {X symmetric, entries in [0,1]}
    K  = scaled McCormick rows (relax/mccormick.py) + unit-norm cut rows
    cobj = (-c, -Q/2)       (min-form of  max 1/2 <Q,X> + c'x)

PDHG with:
  * analytic row scaling (SA/SB/unit cut rows) as diagonal preconditioning,
  * power-iteration estimate of ||K|| for the step size,
  * running ergodic average + restart-to-average when the average's KKT error
    beats the current iterate's (PDLP's adaptive restart, simplified),
  * primal-weight (omega) rebalancing between restarts,
  * warm start across cutting-plane rounds (new cut rows enter with zero dual).

Bound validity: for ANY dual y >= 0 the box-form Lagrangian gives a rigorous
lower bound on the min-form LP value, hence a rigorous upper bound on the BoxQP
maximum.  ``dual_bound_f64`` recomputes that certificate in float64 on host, so
reported bounds never depend on f32 convergence being exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LPConfig
from ..relax.cutbuffer import PRECISION, CutPool, support_embedding
from ..relax.denserows import DenseRows, empty_dense
from ..relax.mccormick import SA, SB, apply_K, apply_KT, project_primal


class PDHGState(NamedTuple):
    x: jnp.ndarray    # (n,)
    X: jnp.ndarray    # (n, n)
    yA: jnp.ndarray   # (n, n)
    yB: jnp.ndarray   # (n, n)
    yC: jnp.ndarray   # (M,) cut-row duals
    yD: jnp.ndarray   # (m,) dense-row duals (QCQP; m = 0 for BoxQP)


def init_state(n: int, capacity: int, m_dense: int = 0,
               dtype=jnp.float32) -> PDHGState:
    return PDHGState(
        x=jnp.full((n,), 0.5, dtype=dtype),
        X=jnp.full((n, n), 0.25, dtype=dtype),
        yA=jnp.zeros((n, n), dtype=dtype),
        yB=jnp.zeros((n, n), dtype=dtype),
        yC=jnp.zeros((capacity,), dtype=dtype),
        yD=jnp.zeros((m_dense,), dtype=dtype),
    )


def _sym(X):
    return 0.5 * (X + X.T)


@functools.partial(jax.jit, static_argnames=("n", "iters", "dtype"))
def estimate_norm(pool: CutPool, n: int, iters: int = 30, dtype=jnp.float32,
                  dense: DenseRows | None = None):
    """Power iteration for ||K|| on the symmetric-X primal subspace."""
    if dense is None:
        dense = empty_dense(n, dtype)
    E3 = support_embedding(pool, n, dtype)  # loop-invariant (see cutbuffer)
    key = jax.random.PRNGKey(0)
    kx, kX = jax.random.split(key)
    x = jax.random.normal(kx, (n,), dtype=dtype)
    X = _sym(jax.random.normal(kX, (n, n), dtype=dtype))

    def body(_, carry):
        x, X = carry
        kA, kB, kC, kD = apply_K(x, X, pool, dense, E3)
        gx, gX = apply_KT(kA, kB, kC * pool.active, pool, n, kD, dense, E3)
        gX = _sym(gX)
        nrm = jnp.sqrt(jnp.sum(gx * gx) + jnp.sum(gX * gX)) + 1e-30
        return gx / nrm, gX / nrm

    x, X = jax.lax.fori_loop(0, iters, body, (x, X))
    kA, kB, kC, kD = apply_K(x, X, pool, dense, E3)
    # v is (approximately) the unit top singular vector, so ||K v|| ~ ||K||.
    lam = jnp.sqrt(
        jnp.sum(kA * kA) + jnp.sum(kB * kB)
        + jnp.sum((kC * pool.active) ** 2) + jnp.sum(kD * kD)
    )
    return lam * 1.02 + 1e-12


def _objective(cx, cX, x, X):
    return jnp.dot(cx, x, precision=PRECISION) + jnp.sum(cX * X)


def _dual_bound(cx, cX, pool, dense, yA, yB, yC, yD, n, E3=None):
    """Box-form Lagrangian lower bound on the min LP; valid for any y >= 0."""
    gx, gX = apply_KT(yA, yB, yC, pool, n, yD, dense, E3)
    hy = (-SB * jnp.sum(yB) + jnp.sum(pool.rhs * pool.active * yC)
          + jnp.sum(dense.h * yD))
    rx = cx - gx
    S = (cX - gX) + (cX - gX).T  # paired coefficient for symmetric X entries
    return (
        hy
        + jnp.sum(jnp.minimum(rx, 0.0))
        + 0.5 * jnp.sum(jnp.minimum(S, 0.0))
    )


def _infeas(x, X, pool, dense, E3=None):
    kA, kB, kC, kD = apply_K(x, X, pool, dense, E3)
    vA = jnp.maximum(-kA, 0.0)                       # hA = 0
    vB = jnp.maximum(-SB - kB, 0.0)
    vC = jnp.maximum(pool.rhs * pool.active - kC, 0.0) * pool.active
    vD = jnp.maximum(dense.h - kD, 0.0)
    return jnp.sqrt(jnp.sum(vA**2) + jnp.sum(vB**2) + jnp.sum(vC**2)
                    + jnp.sum(vD**2))


def _kkt_error(cx, cX, pool, dense, st: PDHGState, n, E3=None):
    p = _objective(cx, cX, st.x, st.X)
    d = _dual_bound(cx, cX, pool, dense, st.yA, st.yB, st.yC, st.yD, n, E3)
    gap = jnp.maximum(p - d, 0.0)
    return _infeas(st.x, st.X, pool, dense, E3) + gap, p, d


def _one_iter(cx, cX, pool, dense, n, st: PDHGState, tau, sigma, E3=None):
    gx, gX = apply_KT(st.yA, st.yB, st.yC, pool, n, st.yD, dense, E3)
    xn, Xn = project_primal(st.x - tau * (cx - gx), st.X - tau * (cX - gX))
    xb, Xb = 2.0 * xn - st.x, 2.0 * Xn - st.X
    kA, kB, kC, kD = apply_K(xb, Xb, pool, dense, E3)
    yA = jnp.maximum(st.yA - sigma * kA, 0.0)
    yB = jnp.maximum(st.yB + sigma * (-SB - kB), 0.0)
    yC = jnp.maximum(st.yC + sigma * (pool.rhs * pool.active - kC), 0.0) * pool.active
    yD = jnp.maximum(st.yD + sigma * (dense.h - kD), 0.0)
    return PDHGState(xn, Xn, yA, yB, yC, yD)


def _zeros_like_state(st: PDHGState) -> PDHGState:
    return jax.tree.map(jnp.zeros_like, st)


def _axpy(a: PDHGState, b: PDHGState, s=1.0) -> PDHGState:
    return jax.tree.map(lambda u, v: u + s * v, a, b)


def _scale(a: PDHGState, s) -> PDHGState:
    return jax.tree.map(lambda u: u * s, a)


def _dist2(a: PDHGState, b: PDHGState, primal: bool):
    if primal:
        return jnp.sum((a.x - b.x) ** 2) + jnp.sum((a.X - b.X) ** 2)
    return (
        jnp.sum((a.yA - b.yA) ** 2)
        + jnp.sum((a.yB - b.yB) ** 2)
        + jnp.sum((a.yC - b.yC) ** 2)
        + jnp.sum((a.yD - b.yD) ** 2)
    )


@functools.partial(
    jax.jit, static_argnames=("max_iters", "check_every", "restart_period")
)
def _solve_impl(cx, cX, pool, dense, st0, normK, omega0, tol, feas_tol,
                step_scale, max_iters, check_every, restart_period):
    n = cx.shape[0]
    eta = step_scale / normK
    E3 = support_embedding(pool, n, cx.dtype)  # loop-invariant; built once

    def run_block(st, acc, tau, sigma):
        def inner(_, c):
            s, a = c
            s2 = _one_iter(cx, cX, pool, dense, n, s, tau, sigma, E3)
            return s2, _axpy(a, s2)

        return jax.lax.fori_loop(0, check_every, inner, (st, acc))

    def checked_block(carry):
        st, acc, wlen, anchor, omega, it, _, _, _ = carry
        tau = eta / omega
        sigma = eta * omega

        st, acc = run_block(st, acc, tau, sigma)
        wlen = wlen + check_every
        avg = _scale(acc, 1.0 / wlen)

        err_cur, p_cur, d_cur = _kkt_error(cx, cX, pool, dense, st, n, E3)
        err_avg, p_avg, d_avg = _kkt_error(cx, cX, pool, dense, avg, n, E3)

        use_avg = err_avg < err_cur
        cand = jax.tree.map(lambda u, v: jnp.where(use_avg, u, v), avg, st)
        err = jnp.where(use_avg, err_avg, err_cur)
        p = jnp.where(use_avg, p_avg, p_cur)
        d = jnp.where(use_avg, d_avg, d_cur)

        do_restart = use_avg | (wlen >= restart_period)
        # primal-weight rebalancing between restarts (PDLP eq. (26), theta=0.5)
        dp = jnp.sqrt(_dist2(cand, anchor, True)) + 1e-12
        dd = jnp.sqrt(_dist2(cand, anchor, False)) + 1e-12
        new_omega = jnp.exp(0.5 * jnp.log(dd / dp) + 0.5 * jnp.log(omega))
        new_omega = jnp.clip(new_omega, 1e-4, 1e4)

        st = jax.tree.map(lambda u, v: jnp.where(do_restart, u, v), cand, st)
        omega = jnp.where(do_restart, new_omega, omega)
        anchor = jax.tree.map(lambda u, v: jnp.where(do_restart, u, v), st, anchor)
        acc = jax.tree.map(
            lambda u: jnp.where(do_restart, jnp.zeros_like(u), u), acc
        )
        wlen = jnp.where(do_restart, 0, wlen)
        return st, acc, wlen, anchor, omega, it + check_every, err, p, d

    def cond(carry):
        _, _, _, _, _, it, err, p, d = carry
        rel = err / (1.0 + jnp.abs(p) + jnp.abs(d))
        return (it < max_iters) & (rel > tol)

    init = (
        st0, _zeros_like_state(st0), jnp.int32(0), st0,
        jnp.asarray(omega0, cx.dtype), jnp.int32(0),
        jnp.asarray(jnp.inf, cx.dtype), jnp.asarray(0.0, cx.dtype),
        jnp.asarray(0.0, cx.dtype),
    )
    st, _, _, _, omega, it, err, p, d = jax.lax.while_loop(
        cond, checked_block, init
    )
    return st, {
        "iters": it, "kkt_error": err, "primal_obj": p, "dual_obj": d,
        "omega": omega,
    }


def solve_lp(Q, c, pool: CutPool, state: PDHGState, cfg: LPConfig,
             dense: DenseRows | None = None):
    """Solve the current relaxation; returns (state, info dict of scalars).

    Max-form LP bound estimate = -info['dual_obj'] (rigorous up to f32 eval
    error; use dual_bound_f64 for the certified value).
    """
    dtype = state.x.dtype
    n = int(c.shape[0])
    if dense is None:
        dense = empty_dense(n, dtype)
    cx = (-c).astype(dtype)
    cX = (-0.5 * Q).astype(dtype)
    normK = estimate_norm(pool, n, cfg.power_iters, dtype, dense)
    return _solve_impl(
        cx, cX, pool, dense, state, normK, cfg.omega0, cfg.tol, cfg.feas_tol,
        cfg.step_scale, cfg.max_iters, cfg.check_every, cfg.restart_period,
    )


@functools.partial(jax.jit, static_argnames=("iters",))
def pdhg_run_fixed(cx, cX, pool, dense, st, normK, omega, step_scale,
                   iters: int):
    """Fixed-iteration PDHG block (no checks) — for benchmarking and for fully
    on-device scan-over-rounds pipelines."""
    n = cx.shape[0]
    eta = step_scale / normK
    tau, sigma = eta / omega, eta * omega
    E3 = support_embedding(pool, n, cx.dtype)

    def inner(_, s):
        return _one_iter(cx, cX, pool, dense, n, s, tau, sigma, E3)

    return jax.lax.fori_loop(0, iters, inner, st)


@functools.partial(jax.jit, static_argnames=("iters",))
def _steer_impl(cx, cX, pool, dense, st, normK, omega, step_scale, eps,
                key, iters: int):
    kx, kX = jax.random.split(key)
    # Rademacher signs: every perturbation component has the SAME magnitude,
    # so no coefficient is accidentally perturbed by ~0 and left tied.
    sx = (2.0 * jax.random.bernoulli(kx, 0.5, cx.shape) - 1.0).astype(cx.dtype)
    SX = (2.0 * jax.random.bernoulli(kX, 0.5, cX.shape) - 1.0).astype(cX.dtype)
    scale = eps * (jnp.mean(jnp.abs(cX)) + jnp.mean(jnp.abs(cx)))
    cx_p = cx + scale * sx
    cX_p = cX + scale * _sym(SX)
    n = cx.shape[0]
    eta = step_scale / normK
    tau, sigma = eta / omega, eta * omega
    E3 = support_embedding(pool, n, cx.dtype)

    def inner(_, s):
        return _one_iter(cx_p, cX_p, pool, dense, n, s, tau, sigma, E3)

    st = jax.lax.fori_loop(0, iters, inner, st)
    return st.x, st.X


def steer_to_vertex(Q, c, pool: CutPool, state: PDHGState, cfg: LPConfig,
                    key, eps: float, iters: int,
                    dense: DenseRows | None = None):
    """Vertex steering: a scoring-only re-solve with a tiny deterministic
    random objective perturbation, warm-started from the converged state.

    Why: at a McCormick LP optimum the optimal face is typically
    high-dimensional and candidate violations are massively tied (many
    Z(rho) share -lambda_min = 0.5 exactly).  A simplex backend — the
    reference's CPLEX dual simplex (SURVEY.md section 2.1 R5) or the CPU
    replica's HiGHS — always lands on a VERTEX of that face, whereas PDHG
    converges to an interior point of it, which scores and cuts differently
    (observed as feasibility-strategy parity dips against the replica).
    Perturbing the objective by a tiny deterministic Rademacher vector makes
    the optimum (generically) a unique vertex of the ORIGINAL optimal face
    (standard LP perturbation argument), so a short warm-started PDHG run on
    the perturbed objective drives the iterate toward vertex-like structure.

    The steered point is used ONLY for scoring / cut generation; the
    reported bound remains the UNperturbed f64 dual certificate
    (dual_bound_f64), so bound validity is untouched.  Returns (x, X).
    """
    dtype = state.x.dtype
    n = int(c.shape[0])
    if dense is None:
        dense = empty_dense(n, dtype)
    cx = (-c).astype(dtype)
    cX = (-0.5 * Q).astype(dtype)
    normK = estimate_norm(pool, n, cfg.power_iters, dtype, dense)
    return _steer_impl(cx, cX, pool, dense, state, normK,
                       jnp.asarray(cfg.omega0, dtype), cfg.step_scale,
                       jnp.asarray(eps, dtype), key, iters)


def dual_bound_f64(Q, c, pool: CutPool, state: PDHGState,
                   dense: DenseRows | None = None,
                   dense_np=None) -> float:
    """Certified max-form upper bound from the current duals, in float64 numpy.

    Mirrors _dual_bound exactly but on host at f64: any y >= 0 yields a valid
    bound, so f32 solver noise cannot invalidate the reported number.

    ``dense_np=(G, g, h)``: host copies of the dense rows.  The eigencut
    certifier holds (capacity, n, n) dense rows, so callers that certify
    every round keep an incremental host mirror and pass it here instead of
    copying the device buffer each call; values are bit-identical to the
    device rows (f32 embeds exactly into f64).
    """
    n = int(c.shape[0])
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    yA = np.maximum(np.asarray(state.yA, np.float64), 0.0)
    yB = np.maximum(np.asarray(state.yB, np.float64), 0.0)
    act = np.asarray(pool.active, np.float64)
    yC = np.maximum(np.asarray(state.yC, np.float64), 0.0) * act
    idx = np.asarray(pool.idx)
    lin = np.asarray(pool.lin, np.float64)
    quad = np.asarray(pool.quad, np.float64)
    rhs = np.asarray(pool.rhs, np.float64)

    cx = -c
    cX = -0.5 * Q

    # per-block adjoint parts (A = McCormick upper rows, B = lower rows,
    # C = sparse cuts, D = dense rows): the certificate is separately
    # 1-homogeneous in each block's dual, so block scalings are free knobs
    gxA = SA * yA.sum(1)
    gXA = -SA * yA
    hyA = 0.0
    gxB = -SB * (yB.sum(1) + yB.sum(0))
    gXB = SB * yB
    hyB = -SB * yB.sum()
    gxC = np.zeros(n)
    np.add.at(gxC, idx.ravel(), (yC[:, None] * lin).ravel())
    flat = np.zeros(n * n)
    np.add.at(
        flat,
        (idx[:, :, None] * n + idx[:, None, :]).ravel(),
        (yC[:, None, None] * quad).ravel(),
    )
    gXC = flat.reshape(n, n)
    hyC = float((rhs * act) @ yC)
    blocks = [(hyA, gxA, gXA), (hyB, gxB, gXB), (hyC, gxC, gXC)]
    if dense_np is not None:
        G, g, hD = (np.asarray(a, np.float64) for a in dense_np)
        yD = np.maximum(np.asarray(state.yD, np.float64), 0.0)[: hD.shape[0]]
        blocks.append((float(hD @ yD), g.T @ yD,
                       np.einsum("m,mij->ij", yD, G)))
    elif dense is not None and dense.h.shape[0] > 0:
        yD = np.maximum(np.asarray(state.yD, np.float64), 0.0)
        G = np.asarray(dense.G, np.float64)
        g = np.asarray(dense.g, np.float64)
        hD = np.asarray(dense.h, np.float64)
        blocks.append((float(hD @ yD), g.T @ yD,
                       np.einsum("m,mij->ij", yD, G)))

    # Dual polish: D(t1*yA, t2*yB, ...) is jointly concave in the per-block
    # scalings (linear + min of affines), and when PDHG is not fully
    # converged the best certificate sits away from t = 1.  ANY t >= 0 gives
    # a VALID bound, so coordinate-ascent over a grid only tightens the
    # reported number, never risks it.
    Ssym = cX + cX.T
    hys = np.array([b[0] for b in blocks])
    gxs = np.stack([b[1] for b in blocks])
    gSs = np.stack([b[2] + b[2].T for b in blocks])

    def D(ts):
        rx_t = cx - np.tensordot(ts, gxs, axes=1)
        S_t = Ssym - np.tensordot(ts, gSs, axes=1)
        return (float(ts @ hys) + np.minimum(rx_t, 0.0).sum()
                + 0.5 * np.minimum(S_t, 0.0).sum())

    nb = len(blocks)
    ts = np.ones(nb)
    best = D(ts)
    grid = np.concatenate([[1.0], np.geomspace(0.5, 2.0, 7)])
    for _ in range(2):  # coordinate-ascent passes
        for b in range(nb):
            for t in grid:
                cand = ts.copy()
                cand[b] = ts[b] * t
                v = D(cand)
                if v > best:
                    best, ts = v, cand
    return float(-best)  # max-form upper bound
