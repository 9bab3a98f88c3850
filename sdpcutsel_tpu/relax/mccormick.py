"""McCormick/RLT relaxation as structured dense operators.

The reference builds the McCormick LP as explicit CPLEX rows (SURVEY.md
sections 0.2, 1: 3-4 rows per (i,j) pair).  This design stores no sparse
constraint matrix at all: the primal point is ``(x: (n,), X: (n,n))`` with X
kept symmetric, and the McCormick rows become two *uniform* dense residual
arrays evaluated elementwise:

    for ALL ordered pairs (i,j) in n x n (diagonal included):
        rA[i,j] = x_i - X_ij                >= 0      (X_ij <= x_i; via (j,i)
                                                       also X_ij <= x_j)
        rB[i,j] = X_ij - x_i - x_j + 1      >= 0      (X_ij >= x_i + x_j - 1;
                                                       j==i gives X_ii >= 2x_i-1)
    bounds:  x in [0,1]^n,  X in [0,1]^{n x n},  X symmetric.

With symmetric X this is exactly the McCormick LP over (x, upper-tri X): each
logical off-diagonal constraint appears twice (harmless duplication that keeps
the operator branch-free), and the diagonal rows are the j==i specialization of
the same formulas — no special-casing anywhere, so XLA sees two fused
elementwise maps.

Row scaling (diagonal preconditioning): rA rows have l2 norm sqrt(2) and rB
rows sqrt(3); we scale rows to unit norm via the constants SA, SB, which is the
analytic equivalent of one Ruiz pass on this structured block.

Everything here is min-form: minimize cobj = -(1/2 <Q,X> + c'x).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from .cutbuffer import (
    PRECISION, CutPool, cut_adjoint, cut_adjoint_emb, cut_residuals,
    cut_residuals_emb,
)
from .denserows import DenseRows, dense_residuals, dense_adjoint

SA = 1.0 / math.sqrt(2.0)  # row scaling for rA
SB = 1.0 / math.sqrt(3.0)  # row scaling for rB


def objective_minform(Q, c, x, X):
    """Min-form objective value: -(1/2 <Q, X> + c'x), X stored full symmetric."""
    return -(0.5 * jnp.sum(Q * X) + jnp.dot(c, x, precision=PRECISION))


def mccormick_residuals(x, X):
    """Scaled constraint residuals (feasible iff both >= 0)."""
    rA = SA * (x[:, None] - X)
    rB = SB * (X - x[:, None] - x[None, :] + 1.0)
    return rA, rB


def apply_K(x, X, pool: CutPool, dense: DenseRows | None = None, E3=None):
    """Linear part of the scaled constraint map K z (no constant offsets).

    Constraint system is  K z >= h  with
      hA = 0,  hB = -SB,  hC = pool.rhs (cut rows unit-normalized),
      hD = dense.h (QCQP rows, relax/denserows.py).

    E3 (cutbuffer.support_embedding): when given, the cut block runs as
    dense matmuls instead of gathers — pass it from iteration loops; one-shot
    callers may omit it.
    """
    kA = SA * (x[:, None] - X)
    kB = SB * (X - x[:, None] - x[None, :])
    if E3 is None:
        kC = cut_residuals(x, X, pool, include_rhs=False)
    else:
        kC = cut_residuals_emb(x, X, pool, E3, include_rhs=False)
    if dense is None:
        return kA, kB, kC
    kD = dense_residuals(x, X, dense, include_rhs=False)
    return kA, kB, kC, kD


def apply_KT(yA, yB, yC, pool: CutPool, n: int, yD=None,
             dense: DenseRows | None = None, E3=None):
    """Adjoint K^T y -> (gx: (n,), gX: (n,n)).  E3 as in apply_K."""
    gx = SA * jnp.sum(yA, axis=1) - SB * (jnp.sum(yB, axis=1) + jnp.sum(yB, axis=0))
    gX = -SA * yA + SB * yB
    if E3 is None:
        cx, cX = cut_adjoint(yC, pool, n)
    else:
        cx, cX = cut_adjoint_emb(yC, pool, E3)
    gx, gX = gx + cx, gX + cX
    if dense is not None and yD is not None:
        dx, dX = dense_adjoint(yD, dense)
        gx, gX = gx + dx, gX + dX
    return gx, gX


def project_primal(x, X):
    """Exact Euclidean projection onto {x in [0,1]^n} x {X symmetric, in [0,1]}.

    For each symmetric pair the feasible segment is {(u,u): 0<=u<=1}; the
    projection of (a,b) onto it is clip((a+b)/2), so symmetrize-then-clip is
    exact (not an approximation).
    """
    x = jnp.clip(x, 0.0, 1.0)
    X = jnp.clip(0.5 * (X + X.T), 0.0, 1.0)
    return x, X
