"""SDP relaxation bound via full-dimensional eigenvector cuts.

The reference's headline metric is % of the (initial McCormick bound - SDP
bound) gap closed (SURVEY.md section 0.5), which needs the SDP relaxation
value  max 1/2<Q,X> + c'x  s.t. McCormick, Z = [[1,x'],[x,X]] >= 0.  The
reference obtained it from an external SDP solver; the route here
reuses our own machinery: a cutting-plane loop whose single candidate is the
FULL index set — each round eigendecomposes the (n+1)x(n+1) moment matrix at
the LP optimum and adds one dense cut per negative eigenvalue.  This outer
polyhedral approximation converges to the SDP bound from above; we stop at
lambda_min(Z) >= -tol, so the reported value is a certified UPPER bound on
the true SDP value within the LP dual tolerance.

Representation matters: a full-dimensional cut touches EVERY entry of X, so
the sparse-support CutPool (per-row gathers) is pure overhead — cuts here go
into a fixed-capacity DenseRows block (v' Z v >= 0 expands to
<u u', X> + 2 v0 u'x >= -v0^2, i.e. one dense (n, n) coefficient matrix per
cut) whose matvec is a single einsum.  Zero rows are inert, so
the preallocated buffer is mask-free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LPConfig
from ..instances.boxqp import BoxQPInstance
from ..lp.pdhg import dual_bound_f64, init_state, solve_lp
from ..relax.cutbuffer import empty_pool
from ..relax.denserows import DenseRows


def _empty_dense_cuts(n: int, capacity: int, dtype):
    return DenseRows(
        G=jnp.zeros((capacity, n, n), dtype=dtype),
        g=jnp.zeros((capacity, n), dtype=dtype),
        h=jnp.zeros((capacity,), dtype=dtype),
    )


def _gen_dense_cuts_host(x, X, eig_tol, m_max):
    """Host-f64 twin of _gen_dense_cuts for the eigencut certifier loop:
    LAPACK dsyev at (n+1) <= 126 is cheap on the host, saves a device
    dispatch and a transfer per in-out blend attempt, and f64 eigenvectors
    give slightly deeper cuts.  Returns (rows | None, lam_min) with rows = (G, g, h) f32 arrays
    ready for both the device buffer and the host mirror."""
    n = x.shape[0]
    Z = np.empty((n + 1, n + 1))
    Z[0, 0] = 1.0
    Z[0, 1:] = x
    Z[1:, 0] = x
    Z[1:, 1:] = X
    w, V = np.linalg.eigh(Z)
    lam_min = float(w[0])
    neg = np.nonzero(w < -eig_tol)[0][:m_max]
    if neg.size == 0:
        return None, lam_min
    v0 = V[0, neg]
    U = V[1:, neg]
    G = U.T[:, :, None] * U.T[:, None, :]
    g = 2.0 * v0[:, None] * U.T
    h = -(v0 ** 2)
    nrm = np.sqrt((G**2).sum((1, 2)) + (g**2).sum(1)) + 1e-30
    return ((G / nrm[:, None, None]).astype(np.float32),
            (g / nrm[:, None]).astype(np.float32),
            (h / nrm).astype(np.float32)), lam_min


def _purge_dense_rows(mirror, state, count: int, m0: int, dtype):
    """Host-side compaction of the dense cut buffer: keep the QCQP prefix
    [0, m0) plus every cut that is near-active at the current LP point
    (small slack) or carries dual weight; compact survivors to the front and
    permute the warm-start duals to match.  Shallow stale cuts otherwise
    saturate the fixed-capacity buffer and silently freeze the bound (the
    observed n=100 plateau, round 4).

    Round 5: operates on the HOST MIRROR (f32 numpy copies of the device
    rows) instead of pulling the (capacity, n, n) device buffer every
    purge.  Returns the compacted
    mirror, the rebuilt device buffer, the permuted state, and the count."""
    Gm, gm, hm = mirror
    G = Gm[:count].astype(np.float64)
    g = gm[:count].astype(np.float64)
    h = hm[:count].astype(np.float64)
    x = np.asarray(state.x, np.float64)
    X = np.asarray(state.X, np.float64)
    yD = np.asarray(state.yD, np.float64)
    idx = np.arange(count)
    slack = np.einsum("mij,ij->m", G, X) + g @ x - h
    dual = yD[:count]
    # hard budget: PDHG duals are smeared (no simplex-style sparsity), so a
    # threshold rule keeps everything; instead RANK by near-activity with a
    # dual-weight bonus and keep the best `target` rows
    target = max(m0, int(0.6 * count))
    sn = slack / max(1e-12, float(slack.std()))
    dn = dual / max(1e-12, float(dual.std()))
    score = sn - dn
    score[:m0] = -np.inf                      # QCQP prefix always survives
    kept = idx[np.argsort(score, kind="stable")[:target]]
    kept.sort()
    k = len(kept)
    Gn = np.zeros_like(Gm)
    gn = np.zeros_like(gm)
    hn = np.zeros_like(hm)
    yn = np.zeros_like(np.asarray(state.yD))
    Gn[:k], gn[:k], hn[:k] = Gm[kept], gm[kept], hm[kept]
    yn[:k] = yD[kept]
    new_dense = DenseRows(G=jnp.asarray(Gn, dtype), g=jnp.asarray(gn, dtype),
                          h=jnp.asarray(hn, dtype))
    new_state = state._replace(yD=jnp.asarray(yn, state.yD.dtype))
    return (Gn, gn, hn), new_dense, new_state, jnp.asarray(k, jnp.int32)


def sdp_relaxation_bound(
    inst,
    lp_cfg: LPConfig | None = None,
    max_rounds: int = 120,
    eig_tol: float = 1e-4,
    capacity: int = 1024,
    dtype=jnp.float32,
    verbose: bool = False,
    stall_tol: float = 5e-5,
    stall_rounds: int = 5,
    with_point: bool = False,
    anchor=None,
    max_cuts_per_round: int = 10**9,
    purge_at: int | None = None,
    seed_dirs=None,
    final_polish: bool = False,
    stop_below: float | None = None,
):
    """Returns (sdp_bound, initial_relaxation_bound, history list); with
    with_point=True additionally the final LP point (x, X) as f64 numpy —
    the input to ``sdp_lower_bound``'s independent validation.

    Accepts a BoxQP instance (Q, c) or a QCQP instance (Q0, c0, constraint
    rows become a DenseRows prefix of the eigencut buffer).

    ``anchor=(x_in, X_in)``: enable in-out separation (Ben-Ameur & Neto
    style).  Plain eigencut stalls at large n: cuts generated AT the LP
    optimum stop improving the bound while lambda_min(Z*) is still ~-1
    (observed round 4, n=100).  With a deep PSD-interior anchor — the
    Burer-Monteiro near-optimal primal point (sdp_primal.py) is ideal —
    cuts are instead generated at the blend (1-beta) z_LP + beta z_anchor,
    which supports the cone much closer to the feasible region, so the
    outer approximation tightens far faster.  beta adapts: shrinks when the
    blend is already PSD (cut would be invalid... not violated), grows
    after cuts succeed.  The reported bound is always the LP value —
    a certified upper bound regardless of where cuts were generated."""
    lp_cfg = lp_cfg or LPConfig()
    n = inst.n
    is_qcqp = hasattr(inst, "Q0")
    Qnp = inst.Q0 if is_qcqp else inst.Q
    cnp = inst.c0 if is_qcqp else inst.c
    Q = jnp.asarray(Qnp, dtype)
    c = jnp.asarray(cnp, dtype)

    pool = empty_pool(1, 1, dtype)          # no sparse cuts in this loop
    dense = _empty_dense_cuts(n, capacity, dtype)
    # host mirror of the dense rows (f32 — bit-identical to the device
    # buffer): the f64 certificate and the purge read rows every round, so
    # the (capacity, n, n) device buffer is never pulled back per round
    mG = np.zeros((capacity, n, n), np.float32)
    mg = np.zeros((capacity, n), np.float32)
    mh = np.zeros((capacity,), np.float32)
    count = jnp.zeros((), jnp.int32)
    if is_qcqp and inst.m > 0:
        from ..relax.denserows import dense_from_qcqp

        qrows = dense_from_qcqp(inst.Qs, inst.cs, inst.bs, dtype)
        m = qrows.h.shape[0]
        dense = DenseRows(
            G=dense.G.at[:m].set(qrows.G),
            g=dense.g.at[:m].set(qrows.g),
            h=dense.h.at[:m].set(qrows.h),
        )
        mG[:m] = np.asarray(qrows.G, np.float32)
        mg[:m] = np.asarray(qrows.g, np.float32)
        mh[:m] = np.asarray(qrows.h, np.float32)
        count = jnp.asarray(m, jnp.int32)
    if seed_dirs is not None:
        # Pre-seed the buffer with v v' >= 0 rows for given (n+1)-vectors —
        # round-5 acceleration: by complementary slackness the optimal SDP
        # dual S has range inside null(Z*) of the (near-)optimal primal, so
        # seeding the Burer-Monteiro solution's bottom eigenvectors (and
        # their pairwise sums — rank-1 terms of one basis do not span the
        # null space's symmetric square) lets the LP dual express the
        # near-optimal S immediately instead of discovering it one
        # eigendecomposition per round.  Every seeded row is a valid cut, so
        # correctness is unchanged; only convergence speed improves.
        Vs = np.asarray(seed_dirs, np.float64)            # (q, n+1)
        v0s, Us = Vs[:, 0], Vs[:, 1:]
        Gm = Us[:, :, None] * Us[:, None, :]
        gm = 2.0 * v0s[:, None] * Us
        hm = -(v0s ** 2)
        nrm = np.sqrt((Gm**2).sum((1, 2)) + (gm**2).sum(1)) + 1e-30
        q = min(Vs.shape[0], capacity - int(count) - 64)
        sG = (Gm / nrm[:, None, None])[:q].astype(np.float32)
        sg = (gm / nrm[:, None])[:q].astype(np.float32)
        sh = (hm / nrm)[:q].astype(np.float32)
        c0 = int(count)
        dense = DenseRows(
            G=dense.G.at[c0:c0 + q].set(jnp.asarray(sG, dtype)),
            g=dense.g.at[c0:c0 + q].set(jnp.asarray(sg, dtype)),
            h=dense.h.at[c0:c0 + q].set(jnp.asarray(sh, dtype)),
        )
        mG[c0:c0 + q], mg[c0:c0 + q], mh[c0:c0 + q] = sG, sg, sh
        count = count + jnp.asarray(q, jnp.int32)
    state = init_state(n, 1, capacity, dtype)

    if anchor is not None:
        x_in = np.asarray(anchor[0], np.float64)
        X_in = np.asarray(anchor[1], np.float64)
        beta = 0.5
    m0 = int(count)          # QCQP prefix rows: never purged

    def append_rows(rows):
        # new rows go to the host mirror AND the device buffer (one small
        # ~2 MB slice upload) — generation itself is host-f64 (see
        # _gen_dense_cuts_host)
        nonlocal dense, count
        Gr, gr, hr = rows
        c0 = int(count)
        q = min(Gr.shape[0], capacity - c0)
        if q <= 0:
            return
        mG[c0:c0 + q], mg[c0:c0 + q], mh[c0:c0 + q] = Gr[:q], gr[:q], hr[:q]
        dense = DenseRows(
            G=dense.G.at[c0:c0 + q].set(jnp.asarray(Gr[:q], dtype)),
            g=dense.g.at[c0:c0 + q].set(jnp.asarray(gr[:q], dtype)),
            h=dense.h.at[c0:c0 + q].set(jnp.asarray(hr[:q], dtype)),
        )
        count = jnp.asarray(c0 + q, jnp.int32)

    history = []
    bound0 = None
    for r in range(max_rounds):
        state, info = solve_lp(Q, c, pool, state, lp_cfg, dense=dense)
        cnt = int(count)
        bound = dual_bound_f64(Qnp, cnp, pool, state,
                               dense_np=(mG[:cnt], mg[:cnt], mh[:cnt]))
        if bound0 is None:
            bound0 = bound
        if purge_at is not None and int(count) > purge_at:
            (mGk, mgk, mhk), dense, state, count = _purge_dense_rows(
                (mG, mg, mh), state, int(count), m0, dtype)
            mG[:], mg[:], mh[:] = mGk, mgk, mhk
        x_np = np.asarray(state.x, np.float64)
        X_np = np.asarray(state.X, np.float64)
        if anchor is not None:
            # in-out: separate at the blend toward the interior anchor; if
            # the blend is PSD (no cut), shrink beta toward the LP point
            for _ in range(8):
                xs = (1.0 - beta) * x_np + beta * x_in
                Xs = (1.0 - beta) * X_np + beta * X_in
                rows_new, lam_min = _gen_dense_cuts_host(
                    xs, Xs, eig_tol, max_cuts_per_round)
                if lam_min < -eig_tol:
                    append_rows(rows_new)
                    beta = min(beta * 1.3, 0.9)
                    break
                beta *= 0.5
            else:
                # even the (near-)LP point separates nothing: converged.
                # Reset beta — 8 halvings left it ~0.004, and with only
                # x1.3/round recovery one such round would degrade in-out
                # to plain eigencut for ~20 rounds.
                beta = 0.5
                rows_new, lam_min = _gen_dense_cuts_host(
                    x_np, X_np, eig_tol, max_cuts_per_round)
                if rows_new is not None:
                    append_rows(rows_new)
        else:
            rows_new, lam_min = _gen_dense_cuts_host(
                x_np, X_np, eig_tol, max_cuts_per_round)
            if rows_new is not None:
                append_rows(rows_new)
        history.append({"round": r, "bound": bound, "lam_min": lam_min,
                        "cuts": int(count), "lp_iters": int(info["iters"]),
                        "lp_kkt": float(info["kkt_error"])})
        if verbose:
            print(f"[sdp_bound] round {r}: bound={bound:.6f} "
                  f"lam_min={lam_min:.2e} cuts={int(count)} "
                  f"lp_iters={int(info['iters'])} "
                  f"kkt={float(info['kkt_error']):.2e}", flush=True)
        if lam_min >= -eig_tol:
            break
        # Each round's bound is an INDEPENDENTLY certified upper bound
        # (f64 dual certificate), so the running MIN is too — and purging
        # can make later rounds non-monotone, so best-so-far is the value
        # to both report and stall-test.
        best = min(h["bound"] for h in history)
        if stop_below is not None and best <= stop_below:
            break   # caller's tightness target reached — budget the rest
        if len(history) > stall_rounds:
            prev_best = min(h["bound"] for h in history[: -stall_rounds])
            if prev_best - best <= stall_tol * (1.0 + abs(best)):
                break

    # Final polish (round 5): the per-round LPs stop at kkt ~1e-2 under the
    # iteration budget, and the f64 certificate pays for dual infeasibility;
    # one long tight re-solve over the final buffer recovers that at the
    # cost of a single extra solve.  The polished value is one more valid
    # certificate, so the running min absorbs it.
    if final_polish and history:
        import dataclasses as _dc

        tight = _dc.replace(lp_cfg, max_iters=lp_cfg.max_iters * 4,
                            tol=lp_cfg.tol * 1e-2)
        state, info = solve_lp(Q, c, pool, state, tight, dense=dense)
        cnt = int(count)
        b = dual_bound_f64(Qnp, cnp, pool, state,
                           dense_np=(mG[:cnt], mg[:cnt], mh[:cnt]))
        history.append({"round": len(history), "bound": b,
                        "lam_min": float("nan"), "cuts": int(count),
                        "lp_iters": int(info["iters"]),
                        "lp_kkt": float(info["kkt_error"]),
                        "polish": True})
        if verbose:
            print(f"[sdp_bound] polish: bound={b:.6f} "
                  f"iters={int(info['iters'])} "
                  f"kkt={float(info['kkt_error']):.2e}", flush=True)

    best = min(h["bound"] for h in history)
    if with_point:
        point = (np.asarray(state.x, np.float64), np.asarray(state.X, np.float64))
        return best, bound0, history, point
    return best, bound0, history


def bm_null_directions(x, X, max_dirs: int = 320, tol_frac: float = 0.02):
    """Seed directions for ``sdp_relaxation_bound(seed_dirs=...)`` from a
    near-optimal primal point: the bottom eigenvectors of Z(x, X) (the
    optimal dual S's range, by complementary slackness) plus their pairwise
    sums/differences — the rank-1 matrices of one eigenbasis alone do not
    span the symmetric square of the null space."""
    n = x.shape[0]
    Z = np.empty((n + 1, n + 1))
    Z[0, 0] = 1.0
    Z[0, 1:] = x
    Z[1:, 0] = x
    Z[1:, 1:] = X
    w, V = np.linalg.eigh(Z)
    thresh = tol_frac * max(w[-1], 1e-12)
    q = int(np.sum(w < thresh))
    q = max(q, 2)
    base = V[:, :q].T                                  # (q, n+1)
    dirs = [base]
    for i in range(q):
        for j in range(i + 1, q):
            dirs.append((base[i] + base[j])[None, :] / np.sqrt(2.0))
            dirs.append((base[i] - base[j])[None, :] / np.sqrt(2.0))
    out = np.concatenate(dirs, axis=0)
    return out[:max_dirs]


def sdp_lower_bound(Q, c, x, X, gamma: float = 0.2,
                    repair_iters: int = 30, rows=None,
                    anchor=None) -> float:
    """Independent f64 LOWER bound on the SDP relaxation value from a
    constructed feasible point (the eigencut loop's
    stall-stop yields a certified UPPER bound that could in principle stop
    too high, silently shrinking every gap-closed denominator — this
    certificate bounds that error from the other side).

    Construction: (1) repair the final LP point (x*, X*) to exact McCormick
    feasibility (entrywise clip of X into [max(0, x_i+x_j-1), min(x_i, x_j)]
    — the box is symmetric, so symmetry survives); (2) take the strictly
    PSD-interior McCormick point x0 = 0.5*1, X0 = 0.25*11' + gamma*I; (3)
    lambda_min of Z(alpha) = (1-alpha) Z* + alpha Z0 is concave in alpha, so
    bisection finds the smallest alpha with Z(alpha) PSD; the affine
    combination stays McCormick-feasible, and its objective is a valid lower
    bound on the SDP max.

    The raw LP point can sit far outside the PSD cone (the eigencut loop
    only separates along low-dimensional submatrices), forcing a large
    anchor blend that craters the objective.  So we ALSO run alternating
    projections on X with x held fixed — Schur: Z ⪰ 0 iff M = X - xx' ⪰ 0,
    alternate eigenvalue-clipping M into the PSD cone with clipping X back
    into the McCormick box — and certify the blend from each iterate; every
    blend is a valid lower bound regardless of projection convergence, so
    the returned max is too.

    ``rows=(Gs, gs, bs)``: additional linear constraints
    <G_i, X> + g_i'x <= b_i (the QCQP lifted constraint rows).  The blend
    predicate then also requires every row satisfied; each row is affine in
    alpha and strictly satisfied at the anchor, so the feasible alpha-set is
    an interval containing 1 and bisection stays valid.  A strictly
    row-feasible ``anchor=(x_a, X_a)`` is REQUIRED with rows (the default
    0.5/0.25 anchor knows nothing about them); anchor feasibility is
    asserted so an invalid anchor fails loudly instead of producing a wrong
    certificate."""
    Q = np.asarray(Q, np.float64)
    c = np.asarray(c, np.float64)
    n = c.shape[0]
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    X = 0.5 * (X + X.T)
    lo = np.maximum(0.0, x[:, None] + x[None, :] - 1.0)
    hi = np.minimum(x[:, None], x[None, :])
    X = np.clip(np.asarray(X, np.float64), lo, hi)

    def Zof(xv, Xv):
        Z = np.empty((n + 1, n + 1))
        Z[0, 0] = 1.0
        Z[0, 1:] = xv
        Z[1:, 0] = xv
        Z[1:, 1:] = Xv
        return Z

    if anchor is not None:
        x0 = np.asarray(anchor[0], np.float64)
        X0 = np.asarray(anchor[1], np.float64)
        lo0 = np.maximum(0.0, x0[:, None] + x0[None, :] - 1.0)
        hi0 = np.minimum(x0[:, None], x0[None, :])
        assert (X0 >= lo0 - 1e-12).all() and (X0 <= hi0 + 1e-12).all(), (
            "interior anchor must be McCormick-feasible")
    else:
        if rows is not None:
            raise ValueError(
                "rows without a row-feasible anchor: the default interior "
                "anchor does not satisfy arbitrary QCQP rows")
        x0 = np.full(n, 0.5)
        X0 = np.full((n, n), 0.25) + gamma * np.eye(n)
    Z0 = Zof(x0, X0)
    assert np.linalg.eigvalsh(Z0)[0] > 0, "interior anchor must be PSD"
    if rows is not None:
        Gs = np.asarray(rows[0], np.float64)
        gs = np.asarray(rows[1], np.float64)
        bs = np.asarray(rows[2], np.float64)

        def row_viol(xv, Xv):
            return (np.einsum("mij,ij->m", Gs, Xv) + gs @ xv - bs).max()

        assert row_viol(x0, X0) < 0.0, (
            "interior anchor must strictly satisfy the QCQP rows")

    def blend_bound(xv, Xv):
        Zs = Zof(xv, Xv)

        def feasible(alpha):
            if np.linalg.eigvalsh((1 - alpha) * Zs + alpha * Z0)[0] < 0.0:
                return False
            if rows is not None:
                xa = (1 - alpha) * xv + alpha * x0
                Xa = (1 - alpha) * Xv + alpha * X0
                if row_viol(xa, Xa) > 0.0:
                    return False
            return True

        if feasible(0.0):
            alpha = 0.0
        else:
            a, b = 0.0, 1.0  # feasible(1) holds strictly
            for _ in range(60):
                mid = 0.5 * (a + b)
                if feasible(mid):
                    b = mid
                else:
                    a = mid
            alpha = min(b + 1e-9, 1.0)
        xa = (1 - alpha) * xv + alpha * x0
        Xa = (1 - alpha) * Xv + alpha * X0
        return float(0.5 * np.sum(Q * Xa) + c @ xa)

    best = blend_bound(x, X)
    Xr = X
    for it in range(repair_iters):
        M = Xr - np.outer(x, x)
        w, V = np.linalg.eigh(M)
        if w[0] >= -1e-12:
            best = max(best, blend_bound(x, Xr))
            break
        M = (V * np.maximum(w, 0.0)) @ V.T
        Xr = np.clip(np.outer(x, x) + M, lo, hi)
        Xr = 0.5 * (Xr + Xr.T)
        # certify intermediate iterates sparsely (each blend costs ~60 eighs)
        if it % 10 == 9:
            best = max(best, blend_bound(x, Xr))
    else:
        best = max(best, blend_bound(x, Xr))
    return best


def qcqp_rows(inst):
    """The QCQP's lifted linear rows <Q_i/2, X> + c_i'x <= b_i as stacked
    arrays for the BM solver / blend certificate (SURVEY.md section 0.7)."""
    Gs = np.stack([0.5 * np.asarray(Qi, np.float64) for Qi in inst.Qs])
    gs = np.stack([np.asarray(ci, np.float64) for ci in inst.cs])
    bs = np.asarray(inst.bs, np.float64)
    return Gs, gs, bs


def qcqp_interior_anchor(inst, gammas=(0.1, 0.03, 0.01, 0.003, 0.001)):
    """Strictly feasible interior anchor for a QCQP: x0 = 0.25*1 (the point
    the generator guarantees constraint slack at — instances/qcqp.py), X0 =
    x0 x0' + gamma I.  Z0 is then PSD (Schur: X0 - x0 x0' = gamma I), X0 is
    strictly inside the McCormick box (off-diag 0.0625 in (0, 0.25)), and
    gamma shrinks until every row keeps strict slack.  Raises if none of the
    gammas work (an instance whose constraints are tight at x0 — not
    produced by our generator)."""
    n = inst.n
    x0 = np.full(n, 0.25)
    Gs, gs, bs = qcqp_rows(inst)
    base = np.einsum("mij,ij->m", Gs, np.outer(x0, x0)) + gs @ x0 - bs
    for gamma in gammas:
        viol = base + gamma * np.trace(Gs, axis1=1, axis2=2)
        if viol.max() < -1e-9:
            return x0, np.outer(x0, x0) + gamma * np.eye(n)
    raise ValueError("no strictly feasible interior anchor found; "
                     f"best row slack {viol.max():.3e}")


def validate_sdp_bound(inst, lp_cfg: LPConfig | None = None,
                       max_rounds: int = 120, **kw):
    """Sandwich the SDP value: (upper, lower, rel_width) where upper is the
    eigencut-loop certificate and lower the independent feasible-point bound.
    rel_width bounds the error the stall-based early stop can introduce into
    the gap-closed denominator.

    Handles BOTH problem families: BoxQP directly; QCQP by joining the
    lifted constraint rows into the BM augmented Lagrangian and requiring
    the certificate blend to satisfy them (row-feasible interior anchor
    from qcqp_interior_anchor)."""
    from .sdp_primal import bm_feasible_point

    # Tight lower end: Burer-Monteiro primal ascent (round 4; replaces the
    # LP-point blend whose certificate collapsed at n>=40), certified by the
    # interior-anchor blend.  The SAME near-optimal point then anchors the
    # in-out eigencut loop, which converges far past the plain loop's stall.
    if hasattr(inst, "Q0"):
        rows = qcqp_rows(inst) if inst.m > 0 else None
        anchor0 = qcqp_interior_anchor(inst) if inst.m > 0 else None
        x_in, X_in, lb = bm_feasible_point(inst.Q0, inst.c0, rows=rows,
                                           anchor=anchor0)
    else:
        x_in, X_in, lb = bm_feasible_point(inst.Q, inst.c)
    # Round-5 accelerated defaults: seed the buffer
    # with the BM solution's null-space directions, take more eigencut
    # directions per round into a larger buffer.
    kw.setdefault("max_cuts_per_round", 48)
    kw.setdefault("capacity", 2048)
    kw.setdefault("purge_at", 1500)
    kw.setdefault("stall_tol", 1e-5)
    kw.setdefault("stall_rounds", 15)
    kw.setdefault("seed_dirs", bm_null_directions(x_in, X_in))
    kw.setdefault("final_polish", True)
    ub, _, _ = sdp_relaxation_bound(
        inst, lp_cfg, max_rounds=max_rounds, anchor=(x_in, X_in), **kw)
    rel = (ub - lb) / (1.0 + abs(ub))
    return ub, lb, rel


def gap_closed(bound0: float, sdp: float, bounds) -> np.ndarray:
    """% of (bound0 - sdp) gap closed per round, clipped to [0, 1]."""
    denom = max(bound0 - sdp, 1e-12)
    return np.clip((bound0 - np.asarray(bounds)) / denom, 0.0, 1.0)
