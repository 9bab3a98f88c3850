"""Faithful CPU replica of the reference cutting-plane algorithm.

Pure numpy + scipy-HiGHS re-implementation of the loop in SURVEY.md section
0.5 (the reference itself used CPLEX dual simplex + LAPACK; its data/code
mount was empty, so this replica — built from the published algorithm — IS the
measured baseline that parity and speedups are quoted against, see SURVEY.md
section 6 and BASELINE.md).

Intentionally "reference-shaped", NOT accelerator-shaped: per-candidate Python/numpy
eigendecompositions, explicit LP rows, simplex re-solves.  Used for
  * parity targets: gap closed per round on each instance,
  * the CPU scoring-throughput baseline for bench.py,
  * cross-checking the JAX loop on small instances in tests.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from ..cuts.enumerate import combinations_table
from ..instances.boxqp import BoxQPInstance
from ..lp.oracle import _tri_index


@dataclasses.dataclass
class CPURoundStats:
    round: int
    bound: float
    cuts_added: int
    score_time_s: float
    lp_time_s: float


def _mccormick_rows(n, T):
    rows, cols, vals, rhs = [], [], [], []

    def add(entries, ub):
        r = len(rhs)
        for ccol, v in entries:
            rows.append(r)
            cols.append(ccol)
            vals.append(v)
        rhs.append(ub)

    for i in range(n):
        for j in range(i, n):
            xij = n + T[i, j]
            add([(xij, 1.0), (i, -1.0)], 0.0)
            if j != i:
                add([(xij, 1.0), (j, -1.0)], 0.0)
                add([(i, 1.0), (j, 1.0), (xij, -1.0)], 1.0)
            else:
                add([(i, 2.0), (xij, -1.0)], 1.0)
    return rows, cols, vals, rhs


def _diverse_select(scores, table, sel_size: int, alpha: float, n: int):
    """Greedy support-diverse selection — numpy twin of ops/topk.diverse_topk
    (identical math: pick argmax(score - alpha * occurrence-count penalty),
    update per-index counts, repeat; first-max tie-breaking like argmax on
    both stacks).  Ported to the replica so feasibility parity can be
    measured like-for-like (the JAX build's tie-breaking is a
    selection-rule choice, not device-specific machinery — the replica gets the
    same host-side rule and the 'divergent' cells collapse to real parity)."""
    sc = scores.astype(np.float64).copy()
    counts = np.zeros(n)
    sel = []
    for _ in range(sel_size):
        eff = sc - alpha * counts[table].sum(1)
        i = int(np.argmax(eff))
        if not np.isfinite(sc[i]):
            break
        sel.append(i)
        np.add.at(counts, table[i], 1.0)
        sc[i] = -np.inf
    return np.asarray(sel, np.int64)


def cpu_cut_select(
    inst: BoxQPInstance,
    k: int = 3,
    sel_size: int = 20,
    rounds: int = 10,
    strategy: str = "feasibility",
    viol_tol: float = 1e-4,
    rng_seed: int = 0,
    score_fn=None,
    diversity_alpha: float = 0.0,
):
    """Run the reference loop; returns (list[CPURoundStats], candidates/sec
    measured over feasibility scoring passes)."""
    n = inst.n
    T, m = _tri_index(n)
    nv = n + m
    obj = np.zeros(nv)
    obj[:n] = -inst.c
    for i in range(n):
        for j in range(i, n):
            w = 0.5 * inst.Q[i, j] if i == j else inst.Q[i, j]
            obj[n + T[i, j]] -= w

    rows, cols, vals, rhs = _mccormick_rows(n, T)
    table = combinations_table(n, k)
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

        # ---- score all candidates (reference hot loop #1) ----
        t0 = time.perf_counter()
        xr = x[table]                                        # (C, k)
        Xr = Xfull[table[:, :, None], table[:, None, :]]     # (C, k, k)
        C = table.shape[0]
        Z = np.empty((C, k + 1, k + 1))
        Z[:, 0, 0] = 1.0
        Z[:, 0, 1:] = xr
        Z[:, 1:, 0] = xr
        Z[:, 1:, 1:] = Xr
        tri_viol = None
        if strategy == "feasibility":
            wmin = np.linalg.eigvalsh(Z)[:, 0]
            scores = -wmin
        elif strategy == "random":
            scores = rng.random(C)
        elif strategy == "custom":
            scores = score_fn(x, Xfull, table)
        elif strategy == "triangle":
            # per-(triple, type) RLT-3 violations, exactly cuts/triangle.py
            assert k == 3, "triangle strategy requires k=3"
            xi, xj, xl = xr[:, 0], xr[:, 1], xr[:, 2]
            Xij, Xil, Xjl = Xr[:, 0, 1], Xr[:, 0, 2], Xr[:, 1, 2]
            tri_viol = np.stack([
                xi + xj + xl - Xij - Xil - Xjl - 1.0,
                Xij + Xil - Xjl - xi,
                Xij + Xjl - Xil - xj,
                Xil + Xjl - Xij - xl,
            ], axis=1)                                   # (C, 4)
            scores = tri_viol.max(1)
        else:
            raise ValueError(strategy)
        score_time += time.perf_counter() - t0
        scored += C

        if strategy == "triangle":
            from ..cuts.triangle import (
                TRIANGLE_LIN, TRIANGLE_QUAD, TRIANGLE_RHS,
            )

            flat = tri_viol.reshape(-1)
            added = 0
            for sidx in np.argsort(-flat)[:sel_size]:
                if flat[sidx] <= viol_tol:
                    continue
                tri_i, typ = divmod(int(sidx), 4)
                idx = table[tri_i]
                lin = TRIANGLE_LIN[typ]
                quad = TRIANGLE_QUAD[typ]
                rcut = float(TRIANGLE_RHS[typ])
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
            continue

        if diversity_alpha > 0.0:
            sel = _diverse_select(scores, table, sel_size,
                                  diversity_alpha, n)
        else:
            sel = np.argsort(-scores)[:sel_size]

        # ---- generate cuts from selected (eigh only on selected) ----
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
                # row: -(lin.x + <quad, X>) <= -rcut
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
