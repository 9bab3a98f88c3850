"""Direct Lagrangian-dual UPPER bound on the McCormick SDP value (f64, host).

Round-5 replacement for the eigencut loop as the denominator certifier: at
n >= 80 the outer polyhedral approximation converges too slowly (measured
spar100-75-2: bound still 2000 above the saturated Burer-Monteiro primal
after 150 rounds, lambda_min stuck at -0.25), leaving gap-denominator
sandwich widths of 18-26%.  Instead of approximating
the PSD cone with cuts, certify from the DUAL side in closed form.

Derivation.  Primal: max f = 1/2<Q,X> + c'x over the McCormick box
constraints and Z = [[1,x'],[x,X]] >= 0.  For any multipliers lam >= 0 on
the box rows (lamA: X >= 0, lamB: X_ij <= x_i, lamC: x_i+x_j-1 <= X_ij,
lamD: x >= 0, lamE: x <= 1 — the SAME five families, in the same
orientation, as sdp_primal.bm_feasible_point's augmented Lagrangian), the
penalized objective is affine in Z:

    L(Z; lam) = <G, X> + g'x + h0,
    G  = Q/2 + sym(lamA) - sym(lamB) + sym(lamC)
    g  = c + lamB.sum(1) - (lamC + lamC') 1 + lamD - lamE
    h0 = sum(lamC) + sum(lamE)

and weak duality gives, for every lam >= 0,

    SDP value  <=  U(lam) = h0 + sup_{Z >= 0, Z00 = 1} (<G,X> + g'x).

With G strictly negative definite the sup is attained at the rank-1 point
x* = z, X* = z z', z = -1/2 G^{-1} g, and

    U(lam) = h0 - 1/4 g' G^{-1} g.

G < 0 is enforceable WITHIN the multiplier family: adding beta to lamB's
diagonal (the X_ii <= x_i rows) shifts G by -beta I (and g by +beta 1), so
any iterate can be repaired to a valid certificate.  By the envelope
theorem the subgradient of U in each multiplier is just minus that
constraint's value at the maximizer Z*(lam) — so minimizing U is a
projected subgradient descent at one n x n Cholesky solve per iteration,
warm-startable from the BM solver's own final AL multipliers.  Validity of
the returned bound never depends on optimizer convergence: every evaluation
with the repaired G is a true f64 upper bound, and the running min is kept.

Reference capability replicated: the external SDP solver the reference used
for its gap denominators (SURVEY.md sections 0.5, 6) — here as the upper
jaw of the sandwich whose lower jaw is sdp_primal.bm_feasible_point.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import cho_factor, cho_solve


def _sym(M):
    return 0.5 * (M + M.T)


def _assemble(Q, c, lamA, lamB, lamC, lamD, lamE, rows=None, lamR=None):
    G = 0.5 * Q + _sym(lamA) - _sym(lamB) + _sym(lamC)
    g = c + lamB.sum(axis=1) - (lamC + lamC.T) @ np.ones(c.shape[0]) \
        + lamD - lamE
    h0 = lamC.sum() + lamE.sum()
    if rows is not None:
        Gs, gs, bs = rows
        # QCQP lifted rows <G_i, X> + g_i'x <= b_i with multipliers lamR>=0
        G = G - np.einsum("m,mij->ij", lamR, Gs)
        g = g - lamR @ gs
        h0 = h0 + lamR @ bs
    return G, g, h0


def _strict_eval(Q, c, params, rows, margin_abs):
    """Repair G < 0 via the lamB-diagonal shift, then the closed form.
    Returns (U, params_repaired) — U is ALWAYS a valid f64 upper bound."""
    n = c.shape[0]
    A, B, C, D, E = params[:5]
    R = params[5] if len(params) > 5 else None
    G, g, h0 = _assemble(Q, c, A, B, C, D, E, rows, R)
    lam_max = float(np.linalg.eigvalsh(G)[-1])
    if lam_max > -margin_abs:
        shift = lam_max + margin_abs
        B = B + shift * np.eye(n)
        G = G - shift * np.eye(n)
        g = g + shift * np.ones(n)
    cf = cho_factor(-G)
    # cho_solve(cf, g) = (-G)^{-1} g = -G^{-1} g, so
    # -1/4 g' G^{-1} g = +1/4 g' cho_solve(cf, g)
    U = float(h0 + 0.25 * g @ cho_solve(cf, g))
    return U, [A, B, C, D, E] + ([R] if R is not None else [])


def dual_upper_bound(
    Q,
    c,
    lams=None,
    barrier_ts=(1e2, 1e4, 1e6, 1e8),
    maxiter: int = 400,
    margin: float = 1e-9,
    rows=None,
    verbose: bool = False,
):
    """Certified f64 upper bound on the SDP relaxation value.

    Minimizes U(lam) with a log-det barrier on -G (keeps the closed form in
    its smooth domain) by L-BFGS-B over lam >= 0, one barrier stage per
    entry of ``barrier_ts``; gradients are exact (envelope theorem for U,
    (-G)^{-1} for the barrier).  The returned value is the running min of
    STRICT evaluations (barrier dropped, G repaired negative definite), so
    optimizer quality affects only tightness, never validity.

    ``lams``: optional warm start dict with keys A, B, C, D, E (and R with
    ``rows``) — e.g. the BM solver's final AL multipliers.  Returns
    (ub, lams_out).  ``rows=(Gs, gs, bs)`` joins a QCQP's lifted constraint
    rows with their own multipliers.
    """
    from scipy.optimize import minimize

    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    qscale = max(1.0, float(np.abs(Q).max()), float(np.abs(c).max()))
    margin_abs = margin * qscale
    if lams is None:
        lams = {}
    m_rows = 0
    if rows is not None:
        Gs = np.asarray(rows[0], np.float64)
        gs = np.asarray(rows[1], np.float64)
        bs = np.asarray(rows[2], np.float64)
        rows = (Gs, gs, bs)
        m_rows = bs.shape[0]

    shapes = [(n, n)] * 3 + [(n,), (n,)] + ([(m_rows,)] if m_rows else [])
    sizes = [int(np.prod(s)) for s in shapes]

    def pack(ps):
        return np.concatenate([p.ravel() for p in ps])

    def unpack(v):
        out, o = [], 0
        for s, sz in zip(shapes, sizes):
            out.append(v[o:o + sz].reshape(s))
            o += sz
        return out

    params = [np.maximum(np.asarray(lams.get(k, np.zeros(s)), np.float64),
                         0.0)
              for k, s in zip(["A", "B", "C", "D", "E", "R"], shapes)]
    # start strictly inside the barrier: shift lamB's diagonal so G < 0
    G0, _, _ = _assemble(Q, c, *params[:5], rows,
                         params[5] if m_rows else None)
    lam_max = float(np.linalg.eigvalsh(G0)[-1])
    if lam_max > -1e-3 * qscale:
        params[1] = params[1] + (lam_max + 1e-2 * qscale) * np.eye(n)

    best = [np.inf]
    best_params = [params]

    def make_obj(t):
        def obj(v):
            ps = unpack(v)
            A, B, C, D, E = ps[:5]
            R = ps[5] if m_rows else None
            G, g, h0 = _assemble(Q, c, A, B, C, D, E, rows, R)
            try:
                cf = cho_factor(-G)
            except np.linalg.LinAlgError:
                return np.inf, np.zeros_like(v)
            except Exception:
                return np.inf, np.zeros_like(v)
            sol = cho_solve(cf, g)                 # (-G)^{-1} g
            z = 0.5 * sol
            U = h0 + 0.25 * g @ sol
            # barrier: -(1/t) logdet(-G); P = (-G)^{-1}
            sign, logdet = np.linalg.slogdet(-G)
            if sign <= 0:
                return np.inf, np.zeros_like(v)
            P = cho_solve(cf, np.eye(n))
            f = U - logdet / t
            # track the best STRICT certificate seen along the way
            if U < best[0]:
                strictU, rep = _strict_eval(Q, c, ps, rows, margin_abs)
                if strictU < best[0]:
                    best[0] = strictU
                    best_params[0] = rep
            # envelope: dU/dlam_k = -(constraint value g_k at Z*); barrier
            # adds (1/t) tr(P dG/dlam_k) where dG/dlam is +sym for A,
            # -sym for B, +sym for C, -G_m for the QCQP rows
            X = np.outer(z, z)
            Pb = P / t
            dA = X + Pb                              # -gA=-(-X)=X, +P/t
            dB = -(X - z[:, None]) - Pb              # -gB, -P/t
            dC = -(z[:, None] + z[None, :] - 1.0 - X) + Pb
            dD = z                                   # -gD = -(-z)
            dE = 1.0 - z                             # -gE = -(z-1)
            grads = [dA, dB, dC, dD, dE]
            if m_rows:
                gR = np.einsum("mij,ij->m", Gs, X) + gs @ z - bs
                dR = -gR - np.einsum("ij,mij->m", P, Gs) / t
                grads.append(dR)
            return f, pack(grads)
        return obj

    v0 = pack(params)
    bounds = [(0.0, None)] * v0.shape[0]
    for t in barrier_ts:
        res = minimize(make_obj(t * qscale), v0, jac=True, method="L-BFGS-B",
                       bounds=bounds,
                       options={"maxiter": maxiter, "maxcor": 20})
        v0 = res.x
        if verbose:
            print(f"[sdp_dual] t={t:g}: obj={res.fun:.4f} "
                  f"best_strict={best[0]:.4f} nit={res.nit}", flush=True)

    # final strict evaluation from the last iterate too
    U, rep = _strict_eval(Q, c, unpack(v0), rows, margin_abs)
    if U < best[0]:
        best[0] = U
        best_params[0] = rep
    keys = ["A", "B", "C", "D", "E"] + (["R"] if m_rows else [])
    return best[0], dict(zip(keys, best_params[0]))
