"""Exact optimality-based scoring: the small-SDP subproblem oracle.

This is strategy (2) of SURVEY.md section 0.4 AND the label generator for NN
training (section 0.6).  Definition used throughout this framework (fixed and
self-consistent; the reference mount was empty so the published paper's
qualitative definition is instantiated as):

    improvement(rho) = 1/2 <Q_rho, X*_rho>  -  s(Q_rho; x*_rho)
    s(Q; x) = max { 1/2 <Q, X> :  L(x) <= X <= U(x),  X - x x^T >= 0 }

where [L(x), U(x)] are the McCormick interval bounds at fixed x
(max(0, x_i + x_j - 1) <= X_ij <= min(x_i, x_j)), and X - xx^T >= 0 is the
Schur complement of Z(rho) >= 0 at fixed x.  improvement >= 0 measures how
much this block's objective contribution must drop to become PSD-consistent
at the current point — the per-block bound improvement the cut can deliver.

The subproblem is a k x k SDP (k <= 5).  Solver here: batched ADMM over
the splitting  box-cap intersect (xx^T + PSD), each iteration one clip and one
batched small eigh — thousands of subproblems solve in parallel on device
(this replaces the reference's per-candidate CPU SDP calls).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _mccormick_box(x):
    """Interval bounds on X at fixed x: (L, U), each (..., k, k)."""
    lo = jnp.maximum(x[..., :, None] + x[..., None, :] - 1.0, 0.0)
    hi = jnp.minimum(x[..., :, None], x[..., None, :])
    return lo, jnp.maximum(hi, lo)  # guard degenerate interval


def _proj_psd(S):
    """Projection onto the PSD cone (batched small eigh)."""
    w, V = jnp.linalg.eigh(S)
    wp = jnp.maximum(w, 0.0)
    return jnp.einsum("...ij,...j,...kj->...ik", V, wp, V)


@functools.partial(jax.jit, static_argnames=("iters",))
def solve_subproblem_admm(Q, x, iters: int = 300, rho: float = 1.0):
    """Batched solve of s(Q; x) = max 1/2<Q,X> over box intersect (xx^T + PSD).

    Q: (B, k, k) symmetric, x: (B, k).  Returns (value: (B,), X: (B, k, k)).

    ADMM on  min -1/2<Q,X> + I_box(X) + I_cone(Y),  X = Y:
        X <- clip(Y - Udual + Q/(2 rho), L, U)
        Y <- xx^T + proj_psd(X + Udual - xx^T)
        Udual <- Udual + X - Y
    The returned value is evaluated at the cone-feasible iterate Y projected
    into the box gap-safe way: we report 1/2<Q, Y_clipped_to_box> which for a
    converged run equals the optimum to well below label noise.
    """
    lo, hi = _mccormick_box(x)
    xxT = x[..., :, None] * x[..., None, :]
    Y = jnp.clip(xxT, lo, hi)
    U = jnp.zeros_like(Y)
    Qh = Q / (2.0 * rho)

    def body(_, carry):
        Y, U = carry
        X = jnp.clip(Y - U + Qh, lo, hi)
        Y = xxT + _proj_psd(X + U - xxT)
        U = U + X - Y
        return Y, U

    Y, U = jax.lax.fori_loop(0, iters, body, (Y, U))
    Xfin = jnp.clip(Y, lo, hi)
    val = 0.5 * jnp.sum(Q * Xfin, axis=(-2, -1))
    return val, Xfin


def exact_improvement(Q_sub, x_sub, X_sub, iters: int = 300):
    """improvement(rho) for a batch of candidate blocks (see module doc)."""
    current = 0.5 * jnp.sum(Q_sub * X_sub, axis=(-2, -1))
    s, _ = solve_subproblem_admm(Q_sub, x_sub, iters=iters)
    return jnp.maximum(current - s, 0.0)


def exact_score_fn(Q, table, iters: int = 300):
    """Strategy 'optimality': exact subproblem scores for ALL candidates."""
    Qr = Q[table[:, :, None], table[:, None, :]]   # (T, k, k)

    @jax.jit
    def score(x, X, key):
        xr = x[table]
        Xr = X[table[:, :, None], table[:, None, :]]
        return exact_improvement(Qr, xr, Xr, iters=iters)

    return score
