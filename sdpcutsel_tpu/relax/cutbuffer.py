"""Fixed-capacity masked cut pool — the jit-friendly dynamic cut buffer.

The reference appends/removes CPLEX rows dynamically each round (SURVEY.md
section 3.1).  Under XLA everything must have static shapes, so the
equivalent here is a fixed-capacity buffer of cut rows with an activity mask:

    cut t (support rho of size <= kmax, eigenvector v = (v0, u)):
        lin . x[idx_t]  +  <quad, X[idx_t, idx_t]>  >=  rhs_t
    with lin = 2*v0*u, quad = u u^T, rhs = -v0^2  (SURVEY.md section 0.3),
    all divided by the row l2 norm so every cut row is unit-norm
    (diagonal preconditioning, matching relax/mccormick.py's SA/SB).

Padded support slots carry idx=0 with zero coefficients, so gathers read x[0]
harmlessly and adjoint scatters add zero.  Appending places new cuts at
positions count + cumsum(valid) - 1 with out-of-range destinations dropped
(jnp scatter mode='drop'), so overflow silently keeps the first fits — callers
should purge before appending when near capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Precision of every f32 product of the LP operator: full f32 on every
# backend.  A TF32 or bf16 pass would make the gathered X inexact at ~1e-3,
# far above viol_tol = 1e-4 (docs/ARCHITECTURE.md, invariant #4).
PRECISION = jax.lax.Precision.HIGHEST


class CutPool(NamedTuple):
    idx: jnp.ndarray    # (M, kmax) int32 — support indices into x
    lin: jnp.ndarray    # (M, kmax) — coefficients on x[idx]
    quad: jnp.ndarray   # (M, kmax, kmax) — symmetric coefficients on X[idx, idx]
    rhs: jnp.ndarray    # (M,)
    active: jnp.ndarray  # (M,) float mask {0., 1.}
    count: jnp.ndarray   # () int32

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]

    @property
    def kmax(self) -> int:
        return self.idx.shape[1]


def empty_pool(capacity: int, kmax: int, dtype=jnp.float32) -> CutPool:
    return CutPool(
        idx=jnp.zeros((capacity, kmax), dtype=jnp.int32),
        lin=jnp.zeros((capacity, kmax), dtype=dtype),
        quad=jnp.zeros((capacity, kmax, kmax), dtype=dtype),
        rhs=jnp.zeros((capacity,), dtype=dtype),
        active=jnp.zeros((capacity,), dtype=dtype),
        count=jnp.zeros((), dtype=jnp.int32),
    )


def cut_residuals(x, X, pool: CutPool, include_rhs: bool = True):
    """Residuals r_t = lin.x_rho + <quad, X_rho_rho> (- rhs).  Inactive rows -> 0
    linear part (and -rhs if included); callers mask with pool.active."""
    xg = x[pool.idx]                                   # (M, kmax)
    Xg = X[pool.idx[:, :, None], pool.idx[:, None, :]]  # (M, kmax, kmax)
    r = jnp.sum(pool.lin * xg, axis=1) + jnp.sum(pool.quad * Xg, axis=(1, 2))
    r = r * pool.active
    if include_rhs:
        r = r - pool.rhs * pool.active
    return r


def cut_adjoint(yC, pool: CutPool, n: int):
    """Adjoint of the cut block: scatter-add yC-weighted coefficients back into
    (gx: (n,), gX: (n,n))."""
    w = yC * pool.active                                  # (M,)
    gx = jnp.zeros((n,), dtype=pool.lin.dtype).at[pool.idx.ravel()].add(
        (w[:, None] * pool.lin).ravel(), mode="drop"
    )
    flat = (pool.idx[:, :, None] * n + pool.idx[:, None, :]).ravel()
    gX = jnp.zeros((n * n,), dtype=pool.quad.dtype).at[flat].add(
        (w[:, None, None] * pool.quad).ravel(), mode="drop"
    ).reshape(n, n)
    return gx, gX


def support_embedding(pool: CutPool, n: int, dtype=None):
    """One-hot support embedding E3: (M, kmax, n), E3[t, a, i] = active_t *
    [idx[t, a] == i].

    Purpose: E3 re-expresses cut_residuals/cut_adjoint inside the PDHG inner
    loop as dense (M*kmax, n)-shaped matmuls instead of per-element gathers
    and scatter-adds with duplicate destinations (~100M MACs/iteration at
    M=2048, n=125).  E3 depends only on the pool, so the solver builds it
    ONCE per solve (loop-invariant, lives outside the while_loop) with an
    elementwise compare — no scatter anywhere."""
    if dtype is None:
        dtype = pool.lin.dtype
    iota = jnp.arange(n, dtype=pool.idx.dtype)
    E3 = (pool.idx[:, :, None] == iota).astype(dtype)
    return E3 * pool.active[:, None, None]


def cut_residuals_emb(x, X, pool: CutPool, E3, include_rhs: bool = True):
    """cut_residuals via the support embedding (matmuls, no gathers).
    E3 carries the active mask, so inactive rows are zero by construction.

    Shapes matter: a naive einsum('tan,nm->tam') lowers to M batched (k, n)
    matmuls — thousands of 3-row products.  Flattening to ONE (M*k, n) @
    (n, n) contraction and doing the tiny k x k reductions elementwise keeps
    it one large product."""
    M, k, n = E3.shape
    Ef = E3.reshape(M * k, n)
    xg = jnp.dot(Ef, x, precision=PRECISION).reshape(M, k)
    tmp = jnp.dot(Ef, X, precision=PRECISION).reshape(M, k, n)  # (E X)[t,a,:]
    # Xg[t,a,b] = sum_m tmp[t,a,m] E3[t,b,m] — k*k is tiny; elementwise+reduce
    Xg = jnp.sum(tmp[:, :, None, :] * E3[:, None, :, :], axis=-1)
    r = jnp.sum(pool.lin * xg, axis=1) + jnp.sum(pool.quad * Xg, axis=(1, 2))
    if include_rhs:
        r = r - pool.rhs * pool.active
    return r


def cut_adjoint_emb(yC, pool: CutPool, E3):
    """cut_adjoint via the support embedding (matmuls, no scatter-adds).
    Same shape discipline as cut_residuals_emb: one (n, M*k) @ (M*k, n)
    contraction for gX; the k x k coefficient mix is elementwise."""
    M, k, n = E3.shape
    w = yC * pool.active
    Ef = E3.reshape(M * k, n)
    gx = jnp.dot((w[:, None] * pool.lin).reshape(M * k), Ef,
                 precision=PRECISION)
    # wq[t,a,:] = sum_b (w quad)[t,a,b] E3[t,b,:]
    wq = jnp.sum((w[:, None, None] * pool.quad)[:, :, :, None]
                 * E3[:, None, :, :], axis=2)
    gX = jnp.dot(Ef.T, wq.reshape(M * k, n), precision=PRECISION)
    return gx, gX


def append_cuts(pool: CutPool, idx, lin, quad, rhs, valid) -> CutPool:
    """Append up to m new (already unit-normalized) cuts where valid (m,) mask
    is set.  Static shapes; overflow rows beyond capacity are dropped."""
    valid = valid.astype(pool.active.dtype)
    dest = pool.count + jnp.cumsum(valid.astype(jnp.int32)) - 1
    dest = jnp.where(valid > 0, dest, pool.capacity)  # invalid -> dropped
    new = CutPool(
        idx=pool.idx.at[dest].set(idx.astype(jnp.int32), mode="drop"),
        lin=pool.lin.at[dest].set(lin.astype(pool.lin.dtype), mode="drop"),
        quad=pool.quad.at[dest].set(quad.astype(pool.quad.dtype), mode="drop"),
        rhs=pool.rhs.at[dest].set(rhs.astype(pool.rhs.dtype), mode="drop"),
        active=pool.active.at[dest].set(valid, mode="drop"),
        count=jnp.minimum(
            pool.count + jnp.sum(valid.astype(jnp.int32)),
            jnp.int32(pool.capacity),
        ),
    )
    return new


def purge_pool(pool: CutPool, yC, slack, slack_tol: float, dual_tol: float = 1e-8):
    """Purge slack, inactive cuts (reference's cut management, SURVEY.md 0.5):
    keep active cuts that are binding (slack < slack_tol) or carry dual weight.
    Returns (compacted pool, permuted duals yC).  Stable compaction via argsort
    of the drop mask keeps static shapes."""
    keep = (pool.active > 0) & ((slack < slack_tol) | (yC > dual_tol))
    order = jnp.argsort(jnp.where(keep, 0, 1), stable=True)
    kept = keep[order].astype(pool.active.dtype)
    return (
        CutPool(
            idx=pool.idx[order] * kept[:, None].astype(jnp.int32),
            lin=pool.lin[order] * kept[:, None],
            quad=pool.quad[order] * kept[:, None, None],
            rhs=pool.rhs[order] * kept,
            active=kept,
            count=jnp.sum(kept).astype(jnp.int32),
        ),
        yC[order] * kept,
    )
