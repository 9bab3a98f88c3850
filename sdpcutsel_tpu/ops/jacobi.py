"""Batched tiny symmetric eigensolver: cyclic Jacobi in struct-of-arrays form.

XLA's generic ``jnp.linalg.eigh`` on a (T, m, m) batch of tiny matrices
(m = k+1 <= 6) runs an iterative algorithm per matrix that is far slower
than elementwise work on this shape.  Here the batch axis is the array axis:
the m(m+1)/2 unique entries of each Z(rho) live in separate (T,)-arrays, and
a FIXED, fully unrolled schedule of Jacobi rotations updates them with pure
elementwise arithmetic over candidates — nothing is serial in T.

For scoring we need only lambda_min (feasibility violation = -lambda_min,
SURVEY.md section 0.4); sweeps * C(m,2) rotations drive off-diagonals to ~0
and the minimum diagonal entry is lambda_min to f32 accuracy.  Cut validity
never depends on eigen accuracy (any vector gives a valid cut), so f32 is
safe by construction.

Used on the hot path by cuts/eigen.feasibility_scores* and
models/scorer.generic_scores; jnp.linalg.eigh remains for the small
selected-candidate eigh at cut generation time.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp


def _rotation_schedule(m: int):
    return [(p, q) for p in range(m) for q in range(p + 1, m)]


def _one_sweep(a, v, m: int, with_vectors: bool):
    """One cyclic sweep (C(m,2) unrolled rotations) over dict-of-arrays a
    (and rotation accumulator v when with_vectors)."""
    eps = jnp.asarray(1e-30, a[(0, 0)].dtype)

    def get(i, j):
        return a[(i, j)] if i <= j else a[(j, i)]

    def set_(i, j, val):
        a[(i, j) if i <= j else (j, i)] = val

    for (p, q) in _rotation_schedule(m):
        apq = a[(p, q)]
        app = a[(p, p)]
        aqq = a[(q, q)]
        small = jnp.abs(apq) < eps
        apq_safe = jnp.where(small, 1.0, apq)
        tau = (aqq - app) / (2.0 * apq_safe)
        # sign(0) must be 1 (45-degree rotation): with equal diagonal entries
        # (every Z(rho) starts with unit diagonal) jnp.sign's 0 would freeze
        # the rotation and the sweep would never converge.
        sgn = jnp.where(tau >= 0.0, 1.0, -1.0)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c

        a[(p, p)] = app - t * apq
        a[(q, q)] = aqq + t * apq
        a[(p, q)] = jnp.zeros_like(apq)
        for r in range(m):
            if r == p or r == q:
                continue
            arp = get(r, p)
            arq = get(r, q)
            set_(r, p, c * arp - s * arq)
            set_(r, q, s * arp + c * arq)
        if with_vectors:
            for r in range(m):
                vrp = v[(r, p)]
                vrq = v[(r, q)]
                v[(r, p)] = c * vrp - s * vrq
                v[(r, q)] = s * vrp + c * vrq
    return a, v


def _jacobi_sweeps(a, m: int, sweeps: int, with_vectors: bool = False,
                   v=None):
    """a: dict {(i,j): (T,) array, i<=j}. Runs cyclic Jacobi.

    Sweeps run under lax.fori_loop so the traced graph is ONE sweep (compile
    time stays flat in `sweeps`; dicts are pytrees).  If with_vectors, v is a
    dict {(i,j): (T,)} holding the accumulated rotation matrix V (row i,
    col j) initialized to identity; eigenvectors are the COLUMNS of V
    (matching jnp.linalg.eigh convention).
    """
    import jax

    if with_vectors:
        def body(_, carry):
            return _one_sweep(dict(carry[0]), dict(carry[1]), m, True)

        a, v = jax.lax.fori_loop(0, sweeps, body, (a, v))
    else:
        def body(_, aa):
            out, _ = _one_sweep(dict(aa), None, m, False)
            return out

        a = jax.lax.fori_loop(0, sweeps, body, a)
    return a, v


def _unpack(Z):
    m = Z.shape[-1]
    return {(i, j): Z[..., i, j] for i in range(m) for j in range(i, m)}


def jacobi_eigvals(Z, sweeps: int = 6):
    """Eigenvalues (ascending) of a (T, m, m) symmetric batch, m <= 8."""
    m = Z.shape[-1]
    a, _ = _jacobi_sweeps(_unpack(Z), m, sweeps)
    diag = jnp.stack([a[(i, i)] for i in range(m)], axis=-1)
    return jnp.sort(diag, axis=-1)


def jacobi_min_eigval(Z, sweeps: int = 6):
    """lambda_min of a (T, m, m) symmetric batch (feasibility scoring)."""
    m = Z.shape[-1]
    a, _ = _jacobi_sweeps(_unpack(Z), m, sweeps)
    out = a[(0, 0)]
    for i in range(1, m):
        out = jnp.minimum(out, a[(i, i)])
    return out


def jacobi_eigh(Z, sweeps: int = 8):
    """Full (w ascending, V columns) like jnp.linalg.eigh, for tiny m."""
    m = Z.shape[-1]
    a = _unpack(Z)
    v = {}
    one = jnp.ones_like(a[(0, 0)])
    zero = jnp.zeros_like(one)
    for i in range(m):
        for j in range(m):
            v[(i, j)] = one if i == j else zero
    a, v = _jacobi_sweeps(a, m, sweeps, with_vectors=True, v=v)
    w = jnp.stack([a[(i, i)] for i in range(m)], axis=-1)        # (T, m)
    V = jnp.stack(
        [jnp.stack([v[(i, j)] for j in range(m)], axis=-1) for i in range(m)],
        axis=-2,
    )                                                             # (T, m, m)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V


def min_eig_from_parts(x_r, X_r, sweeps: int = 6):
    """lambda_min of Z = [[1, x_r'], [x_r, X_r]] built directly from gathered
    parts (x_r: (T, k), X_r: (T, k, k)) without materializing (T, m, m)."""
    k = x_r.shape[-1]
    a = {(0, 0): jnp.ones_like(x_r[..., 0])}
    for j in range(k):
        a[(0, j + 1)] = x_r[..., j]
    for i in range(k):
        for j in range(i, k):
            a[(i + 1, j + 1)] = X_r[..., i, j]
    a, _ = _jacobi_sweeps(a, k + 1, sweeps)
    out = a[(0, 0)]
    for i in range(1, k + 1):
        out = jnp.minimum(out, a[(i, i)])
    return out
