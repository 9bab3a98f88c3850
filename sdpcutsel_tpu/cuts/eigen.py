"""Batched small symmetric eigendecomposition.

Replaces the reference's LAPACK dsyev calls over Python loops (SURVEY.md R6)
with batched device code:

  * ``jnp.linalg.eigh`` — full (w, V) for the few SELECTED candidates at cut
    generation time.
  * the struct-of-arrays Jacobi in ops/jacobi.py — lambda_min only, for the
    hot score-everything pass.

Note on tolerance: cut VALIDITY never depends on eigenvector accuracy — for
any vector v, v'Z v >= 0 is implied by Z >= 0 — only cut VIOLATION (quality)
does, so f32 eigenvectors are safe by construction.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.jacobi import jacobi_min_eigval, min_eig_from_parts


def batched_eigh_small(Z):
    """Z: (T, m, m) symmetric -> (w ascending: (T, m), V columns: (T, m, m)).

    Used only on the SELECTED candidates (small batch) for cut generation,
    where full eigenvectors are needed — XLA's eigh is fine at that size."""
    return jnp.linalg.eigh(Z)


def feasibility_scores(Z):
    """Feasibility-based score: -lambda_min(Z(rho)) (violation magnitude).

    Hot path over ALL candidates: struct-of-arrays Jacobi (ops/jacobi.py),
    every op elementwise over the candidate axis."""
    return -jacobi_min_eigval(Z, sweeps=6)


def feasibility_scores_from_point(x, X, table, sweeps: int = 6):
    """Same, built directly from gathers without materializing (T, m, m)."""
    xr = x[table]
    Xr = X[table[:, :, None], table[:, None, :]]
    return -min_eig_from_parts(xr, Xr, sweeps=sweeps)
