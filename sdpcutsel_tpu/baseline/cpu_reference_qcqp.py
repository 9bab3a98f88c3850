"""Faithful CPU replica of the reference QCQP cutting-plane loop.

Pure numpy + scipy-HiGHS re-implementation of the sparse-QCQP path
(SURVEY.md sections 0.7, 3.4), the companion of cpu_reference.py's BoxQP
loop.  The reference's QCQP solver linearizes each quadratic constraint
1/2 <Qi, X> + ci'x <= bi as a static LP row and restricts the eigencut
candidates to the <=k subsets of the maximal cliques of the chordal
extension of the aggregate sparsity graph (chompack's role, here
qcqp/chordal.py — shared host-side preprocessing, so replica and JAX build
rank the IDENTICAL candidate table).

Reference-shaped on purpose: explicit sparse LP rows, HiGHS re-solve from
scratch each round, per-candidate LAPACK eigendecompositions.  Used for
  * QCQP parity targets (gap closed per round vs the JAX CutSolverQCQP),
  * cross-checking the JAX QCQP loop in tests.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from ..instances.qcqp import QCQPInstance
from ..lp.oracle import _tri_index
from ..qcqp.chordal import chordal_decomposition, clique_candidates
from .cpu_reference import CPURoundStats, _mccormick_rows


def _constraint_rows(inst: QCQPInstance, n, T, nv):
    """Static rows ci'x + sum_{a<=b} w_ab X_ab <= bi (linearization of
    1/2 <Qi, X> + ci'x <= bi over the lifted variables; w_ab = Qi[a,b] for
    a<b and Qi[a,a]/2 on the diagonal, matching relax/denserows.py)."""
    rows, cols, vals, rhs = [], [], [], []
    for r, (Qi, ci, bi) in enumerate(zip(inst.Qs, inst.cs, inst.bs)):
        for i in range(n):
            if ci[i] != 0.0:
                rows.append(r)
                cols.append(i)
                vals.append(float(ci[i]))
            for j in range(i, n):
                w = 0.5 * Qi[i, i] if j == i else Qi[i, j]
                if w != 0.0:
                    rows.append(r)
                    cols.append(n + T[i, j])
                    vals.append(float(w))
        rhs.append(float(bi))
    return rows, cols, vals, rhs


def cpu_cut_select_qcqp(
    inst: QCQPInstance,
    k: int = 4,
    sel_size: int = 16,
    rounds: int = 8,
    strategy: str = "feasibility",
    viol_tol: float = 1e-4,
    rng_seed: int = 0,
    score_fn=None,
):
    """Run the reference QCQP loop; returns (list[CPURoundStats],
    candidates/sec over the scoring passes).  ``strategy`` is one of
    feasibility / random / custom (score_fn(x, Xfull, table) -> (C,))."""
    n = inst.n
    T, mtri = _tri_index(n)
    nv = n + mtri
    obj = np.zeros(nv)
    obj[:n] = -np.asarray(inst.c0, np.float64)
    Q0 = np.asarray(inst.Q0, np.float64)
    for i in range(n):
        for j in range(i, n):
            w = 0.5 * Q0[i, j] if i == j else Q0[i, j]
            obj[n + T[i, j]] -= w

    rows, cols, vals, rhs = _mccormick_rows(n, T)
    base = len(rhs)
    crows, ccols, cvals, crhs = _constraint_rows(inst, n, T, nv)
    rows += [base + r for r in crows]
    cols += ccols
    vals += cvals
    rhs += crhs

    cliques, _ = chordal_decomposition(n, inst.sparsity_graph())
    table = clique_candidates(cliques, k)
    if table.shape[0] == 0:
        raise ValueError("no candidate subsets: sparsity graph is empty")
    rng = np.random.default_rng(rng_seed)
    bounds = [(0.0, 1.0)] * nv

    history: list[CPURoundStats] = []
    scored = 0
    score_time = 0.0

    for r in range(rounds):
        A = sp.csr_matrix((vals, (rows, cols)), shape=(len(rhs), nv))
        t0 = time.perf_counter()
        res = linprog(obj, A_ub=A, b_ub=np.asarray(rhs), bounds=bounds,
                      method="highs")
        lp_time = time.perf_counter() - t0
        if res.status != 0:
            raise RuntimeError(f"HiGHS failed at round {r}: {res.message}")
        bound = -res.fun
        x = res.x[:n]
        Xfull = res.x[n:][T]

        # ---- score every clique candidate (duplicated pad indices give a
        # singular-but-PSD-valid Z; zero eigenvalues never pass viol_tol) ----
        t0 = time.perf_counter()
        xr = x[table]                                        # (C, k)
        Xr = Xfull[table[:, :, None], table[:, None, :]]     # (C, k, k)
        C = table.shape[0]
        Z = np.empty((C, k + 1, k + 1))
        Z[:, 0, 0] = 1.0
        Z[:, 0, 1:] = xr
        Z[:, 1:, 0] = xr
        Z[:, 1:, 1:] = Xr
        if strategy == "feasibility":
            scores = -np.linalg.eigvalsh(Z)[:, 0]
        elif strategy == "random":
            scores = rng.random(C)
        elif strategy == "custom":
            scores = np.asarray(score_fn(x, Xfull, table))
        else:
            raise ValueError(strategy)
        score_time += time.perf_counter() - t0
        scored += C

        sel = np.argsort(-scores)[:sel_size]

        # ---- eigcuts from selected (duplicate indices accumulate through
        # the coefficient dicts, exactly as cuts/generate.py scatters) ----
        added = 0
        w, V = np.linalg.eigh(Z[sel])
        for s_i, cand in enumerate(sel):
            idx = table[cand]
            for e in range(k + 1):
                if w[s_i, e] >= -viol_tol:
                    continue
                v = V[s_i, :, e]
                v0, u = v[0], v[1:]
                lin = 2.0 * v0 * u
                quad = np.outer(u, u)
                rcut = -v0 * v0
                nrm = np.sqrt((lin**2).sum() + (quad**2).sum())
                lin, quad, rcut = lin / nrm, quad / nrm, rcut / nrm
                rr = len(rhs)
                coef_x = {}
                coef_t = {}
                for a, ia in enumerate(idx):
                    coef_x[ia] = coef_x.get(ia, 0.0) - lin[a]
                    for b, ib in enumerate(idx):
                        t_ = n + T[ia, ib]
                        coef_t[t_] = coef_t.get(t_, 0.0) - quad[a, b]
                for col, v_ in list(coef_x.items()) + list(coef_t.items()):
                    rows.append(rr)
                    cols.append(col)
                    vals.append(v_)
                rhs.append(-rcut)
                added += 1

        history.append(CPURoundStats(
            round=r, bound=bound, cuts_added=added,
            score_time_s=score_time, lp_time_s=lp_time,
        ))
        if added == 0 and r > 0:
            break

    cands_per_sec = scored / max(score_time, 1e-9)
    return history, cands_per_sec
