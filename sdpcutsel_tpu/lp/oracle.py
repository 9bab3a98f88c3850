"""CPU LP oracle: explicit sparse McCormick LP solved with scipy HiGHS.

Test-only correctness oracle for the device PDHG solver (SURVEY.md section 4:
"device PDHG LP bound vs scipy HiGHS on small instances").  Builds the classic
upper-triangular-variable formulation the reference feeds CPLEX and solves it
with HiGHS dual simplex.  Never used on the device solve path.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog


def _tri_index(n: int):
    """Map (i, j) i<=j -> flat index into the upper-tri X vector."""
    T = np.zeros((n, n), dtype=np.int64)
    k = 0
    for i in range(n):
        for j in range(i, n):
            T[i, j] = T[j, i] = k
            k += 1
    return T, k


def solve_mccormick_highs(Q, c, cuts=None, qcons=None):
    """Solve max 1/2<Q,X> + c'x over the McCormick LP (+ optional cut rows).

    cuts: optional list of (idx (k,), lin (k,), quad (k,k), rhs) tuples in the
    same convention as relax/cutbuffer.py: lin.x_rho + <quad, X_rho_rho> >= rhs
    with quad a full symmetric matrix over the support.

    qcons: optional list of (Qi (n,n), ci (n,), bi) linearized quadratic
    constraints 1/2 <Qi, X> + ci'x <= bi (the lifted QCQP rows).

    Returns (value, x, Xtri) where value is the max-form LP optimum.
    """
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    T, m = _tri_index(n)
    nv = n + m  # x then tri(X)

    obj = np.zeros(nv)
    obj[:n] = -c
    for i in range(n):
        for j in range(i, n):
            w = 0.5 * Q[i, j] if i == j else Q[i, j]  # tri var counts both sides
            obj[n + T[i, j]] -= w

    rows, cols, vals, rhs_ub = [], [], [], []

    def add_row(entries, ub):
        r = len(rhs_ub)
        for col, v in entries:
            rows.append(r)
            cols.append(col)
            vals.append(v)
        rhs_ub.append(ub)

    for i in range(n):
        for j in range(i, n):
            xij = n + T[i, j]
            # X_ij <= x_i  ->  X_ij - x_i <= 0
            add_row([(xij, 1.0), (i, -1.0)], 0.0)
            if j != i:
                add_row([(xij, 1.0), (j, -1.0)], 0.0)
            # X_ij >= x_i + x_j - 1  ->  x_i + x_j - X_ij <= 1
            if j != i:
                add_row([(i, 1.0), (j, 1.0), (xij, -1.0)], 1.0)
            else:
                add_row([(i, 2.0), (xij, -1.0)], 1.0)

    if cuts is not None:
        for idx, lin, quad, rhs in cuts:
            idx = np.asarray(idx)
            lin = np.asarray(lin, np.float64)
            quad = np.asarray(quad, np.float64)
            coef = {}
            for a, ia in enumerate(idx):
                coef[int(ia)] = coef.get(int(ia), 0.0) + lin[a]
            tri = {}
            for a, ia in enumerate(idx):
                for b, ib in enumerate(idx):
                    t = n + T[int(ia), int(ib)]
                    tri[t] = tri.get(t, 0.0) + quad[a, b]
            entries = [(i, -v) for i, v in coef.items()]
            entries += [(t, -v) for t, v in tri.items()]
            add_row(entries, -float(rhs))  # lin.x + <quad,X> >= rhs

    if qcons is not None:
        for Qi, ci, bi in qcons:
            Qi = np.asarray(Qi, np.float64)
            ci = np.asarray(ci, np.float64)
            entries = [(i, float(ci[i])) for i in range(n) if ci[i] != 0.0]
            for i in range(n):
                for j in range(i, n):
                    w = 0.5 * Qi[i, j] if i == j else Qi[i, j]
                    if w != 0.0:
                        entries.append((n + T[i, j], w))
            add_row(entries, float(bi))

    A = sp.csr_matrix(
        (vals, (rows, cols)), shape=(len(rhs_ub), nv)
    )
    res = linprog(
        obj, A_ub=A, b_ub=np.asarray(rhs_ub), bounds=[(0.0, 1.0)] * nv,
        method="highs",
    )
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed: {res.status} {res.message}")
    x = res.x[:n]
    Xtri = res.x[n:]
    return -res.fun, x, Xtri


def tri_to_full(Xtri, n):
    T, _ = _tri_index(n)
    return Xtri[T]
