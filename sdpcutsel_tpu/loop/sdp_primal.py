"""Burer-Monteiro primal SDP feasible-point solver (f64, host).

Purpose: a TIGHT independent lower bound on the SDP relaxation value

    max 1/2<Q,X> + c'x   s.t.  McCormick(x, X),  Z = [[1,x'],[x,X]] >= 0

to sandwich the eigencut-loop upper bound (loop/sdp_bound.py).  The round-3
certificate blended the final LP point toward an interior anchor; at n>=40
the LP point sits far outside the PSD cone, the blend coefficient explodes
and the certificate collapses (rel_width ~0.8-1.0).

This module instead MAXIMIZES the primal directly over a low-rank
factorization: fix Y0 = e1 and parametrize

    Z = [e1; Y1] [e1; Y1]'   =>   Z00 = 1,  x = Y1[:, 0],  X = Y1 Y1'

so Z >= 0 holds EXACTLY by construction for every iterate; only the
McCormick box constraints are soft (augmented Lagrangian).  After
optimization the point is clipped into the box — a tiny perturbation since
the AL drives violations to ~1e-6 — and the small PSD damage from clipping
is repaired by the existing certified interior-anchor blend
(loop/sdp_bound.sdp_lower_bound), which is a valid f64 lower bound
regardless of how good the optimizer was.  Tightness comes from the
optimizer; validity comes only from the final blend.

Pure numpy f64 with hand-written gradients and Adam: the problem is tiny
(Y1 is n x r, n <= 125, r <= 64; one iteration is ~n^2 r flops), and
keeping it off-device avoids flipping jax_enable_x64 globally.  Reference
capability replicated: the external SDP solver the reference used to obtain
gap denominators (SURVEY.md section 0.5 / section 6).
"""

from __future__ import annotations

import numpy as np


def _relu(a):
    return np.maximum(a, 0.0)


def bm_feasible_point(
    Q,
    c,
    x0=None,
    X0=None,
    rank: int | None = None,
    stages: int = 10,
    iters_per_stage: int = 300,
    lr: float = 0.03,
    mu0: float | None = None,
    mu_growth: float = 2.5,
    seed: int = 0,
    certify_from: int | None = 2,
    rows=None,
    anchor=None,
    return_multipliers: bool = False,
):
    """Approximately solve the primal SDP by Burer-Monteiro + augmented
    Lagrangian.  Returns (x, X, lb): the BEST point seen across AL stages
    and its certified f64 lower bound.

    Per-stage certification matters: the certified value peaks at moderate
    mu (measured n=12: rel error 5e-5 at stage 6-7) and then DEGRADES as
    the exploding penalty pushes the iterate strictly interior and Adam
    oscillates across the boundary — so the final iterate is the wrong one
    to keep.  Certification (clip into the McCormick box + interior-anchor
    blend, sdp_bound.sdp_lower_bound) is valid at every stage, so max over
    stages is too.  certify_from=None skips certification and returns the
    final iterate with lb=-inf (cheaper, for warm starts only).

    Warm start: (x0, X0) if given (e.g. the eigencut loop's final LP point);
    Y1's first column is x and the remaining columns factor the PSD part of
    X - xx'.

    ``rows=(Gs, gs, bs)``: extra linear constraints  <G_i, X> + g_i'x <= b_i
    (a QCQP's linearized quadratic constraints, G_i = Q_i/2 — SURVEY.md
    section 0.7) joined into the augmented Lagrangian; certification then
    uses the row-aware blend (sdp_bound.sdp_lower_bound with the same rows
    and a strictly row-feasible ``anchor`` (x_a, X_a), which is REQUIRED
    with rows since the default 0.5/0.25 anchor need not satisfy them).
    """
    from .sdp_bound import sdp_lower_bound
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    r = int(rank if rank is not None else min(n, 64))
    r = max(r, 2)
    rng = np.random.default_rng(seed)

    if x0 is None:
        x = np.full(n, 0.5)
        M = 0.05 * np.eye(n)
    else:
        x = np.clip(np.asarray(x0, np.float64), 0.0, 1.0)
        if X0 is None:
            # x0 without X0 is a legal warm start: factor a
            # slightly-interior lift around the given point
            X0 = np.outer(x, x) + 0.05 * np.eye(n)
        M = np.asarray(X0, np.float64) - np.outer(x, x)
        M = 0.5 * (M + M.T)
    w, V = np.linalg.eigh(M)
    w = np.maximum(w, 0.0)
    # top r-1 eigen-directions of the PSD part; pad with tiny noise so dead
    # columns can still activate during ascent
    order = np.argsort(w)[::-1][: r - 1]
    fac = V[:, order] * np.sqrt(w[order])[None, :]
    Y1 = np.concatenate([x[:, None], fac], axis=1)
    Y1 += 1e-3 * rng.standard_normal(Y1.shape)

    qscale = max(1.0, float(np.abs(Q).max()), float(np.abs(c).max()))
    mu = float(mu0 if mu0 is not None else qscale)
    lamA = np.zeros((n, n))  # X >= 0        : g = -X
    lamB = np.zeros((n, n))  # X_ij <= x_i   : g = X - x_i
    lamC = np.zeros((n, n))  # x_i+x_j-1<=X  : g = x_i + x_j - 1 - X
    lamD = np.zeros(n)       # x >= 0        : g = -x
    lamE = np.zeros(n)       # x <= 1        : g = x - 1
    if rows is not None:
        Gs = np.asarray(rows[0], np.float64)           # (m, n, n)
        gs = np.asarray(rows[1], np.float64)           # (m, n)
        bs = np.asarray(rows[2], np.float64)           # (m,)
        # row-normalize so one mu fits all rows
        rn = np.sqrt((Gs**2).sum((1, 2)) + (gs**2).sum(1)) + 1e-30
        Gs, gs, bs = Gs / rn[:, None, None], gs / rn[:, None], bs / rn
        lamR = np.zeros(bs.shape[0])                   # <G,X>+g'x <= b

    m1 = np.zeros_like(Y1)
    v1 = np.zeros_like(Y1)
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    t = 0

    def grads(Y1):
        x = Y1[:, 0]
        X = Y1 @ Y1.T
        dA = _relu(lamA - mu * X)
        dB = _relu(lamB + mu * (X - x[:, None]))
        dC = _relu(lamC + mu * (x[:, None] + x[None, :] - 1.0 - X))
        dD = _relu(lamD - mu * x)
        dE = _relu(lamE + mu * (x - 1.0))
        # minimize h = -f + AL penalties
        GX = -0.5 * Q - dA + dB - dC
        gx = -c - dB.sum(axis=1) + dC.sum(axis=1) + dC.sum(axis=0) - dD + dE
        if rows is not None:
            gR = np.einsum("mij,ij->m", Gs, X) + gs @ x - bs
            dR = _relu(lamR + mu * gR)
            GX = GX + np.einsum("m,mij->ij", dR, Gs)
            gx = gx + dR @ gs
        G = (GX + GX.T) @ Y1
        G[:, 0] += gx
        return G

    lr_s = lr
    best = (-np.inf, None, None)
    for s in range(stages):
        for _ in range(iters_per_stage):
            t += 1
            g = grads(Y1)
            m1 = beta1 * m1 + (1 - beta1) * g
            v1 = beta2 * v1 + (1 - beta2) * g * g
            mh = m1 / (1 - beta1**t)
            vh = v1 / (1 - beta2**t)
            Y1 -= lr_s * mh / (np.sqrt(vh) + eps)
        x = Y1[:, 0]
        X = 0.5 * (Y1 @ Y1.T + (Y1 @ Y1.T).T)
        if certify_from is not None and s >= certify_from:
            lb = sdp_lower_bound(Q, c, x, X, repair_iters=5,
                                 rows=rows, anchor=anchor)
            if lb > best[0]:
                best = (lb, x.copy(), X.copy())
        lamA = _relu(lamA - mu * X)
        lamB = _relu(lamB + mu * (X - x[:, None]))
        lamC = _relu(lamC + mu * (x[:, None] + x[None, :] - 1.0 - X))
        lamD = _relu(lamD - mu * x)
        lamE = _relu(lamE + mu * (x - 1.0))
        if rows is not None:
            gR = np.einsum("mij,ij->m", Gs, X) + gs @ x - bs
            lamR = _relu(lamR + mu * gR)
        mu *= mu_growth
        lr_s *= 0.7

    x = Y1[:, 0]
    X = 0.5 * (Y1 @ Y1.T + (Y1 @ Y1.T).T)
    # final AL multiplier estimates — near-optimal dual variables of the SDP
    # when the ascent converged; warm start for sdp_dual.dual_upper_bound
    mults = {"A": lamA, "B": lamB, "C": lamC, "D": lamD, "E": lamE}
    if rows is not None:
        mults["R"] = lamR / rn  # undo the row normalization
    if best[1] is None:
        return (x, X, -np.inf, mults) if return_multipliers \
            else (x, X, -np.inf)
    # final iterate might still win (rare); certify once more
    lb = sdp_lower_bound(Q, c, x, X, repair_iters=5, rows=rows, anchor=anchor)
    if lb > best[0]:
        best = (lb, x, X)
    if return_multipliers:
        return best[1], best[2], best[0], mults
    return best[1], best[2], best[0]


def bm_lower_bound(Q, c, x0=None, X0=None, **kw) -> float:
    """Certified f64 lower bound on the SDP value: Burer-Monteiro ascent
    with per-stage exact-feasibility repair via the interior-anchor blend.
    Every return value is a true lower bound; optimizer quality only
    affects tightness."""
    _, _, lb = bm_feasible_point(Q, c, x0=x0, X0=X0, **kw)
    return lb
