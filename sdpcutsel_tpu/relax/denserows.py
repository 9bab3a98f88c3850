"""Dense linear rows over (x, X): linearized quadratic constraints (QCQP).

Each QCQP constraint 1/2 x'Qi x + ci'x <= bi linearizes through the lift as

    1/2 <Qi, X> + ci'x <= bi      (SURVEY.md section 0.7)

which in the min-form convention K z >= h becomes

    row_i:  -(<Gi, X> + gi'x) >= -bi,  Gi = Qi/2, gi = ci,

row-normalized like every other block.  Stored dense ((m, n, n) + (m, n)):
for the target sizes (n <= 125, m <= ~64) the matvec is one einsum — no
sparse machinery needed.  BoxQP uses an empty block (m = 0); zero-size
arrays compile fine under jit.  Products run at cutbuffer.PRECISION.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .cutbuffer import PRECISION


class DenseRows(NamedTuple):
    G: jnp.ndarray   # (m, n, n) symmetric coefficient on X (already scaled)
    g: jnp.ndarray   # (m, n) coefficient on x
    h: jnp.ndarray   # (m,) right-hand side in K z >= h form


def empty_dense(n: int, dtype=jnp.float32) -> DenseRows:
    return DenseRows(
        G=jnp.zeros((0, n, n), dtype=dtype),
        g=jnp.zeros((0, n), dtype=dtype),
        h=jnp.zeros((0,), dtype=dtype),
    )


def dense_from_qcqp(Qs, cs, bs, dtype=jnp.float32) -> DenseRows:
    """Build the normalized dense block from QCQP constraint data."""
    if len(bs) == 0:
        n = 0
        raise ValueError("use empty_dense for zero constraints")
    G = np.stack([-0.5 * np.asarray(Q, np.float64) for Q in Qs])
    g = np.stack([-np.asarray(c, np.float64) for c in cs])
    h = -np.asarray(bs, np.float64)
    nrm = np.sqrt((G**2).sum((1, 2)) + (g**2).sum(1)) + 1e-30
    return DenseRows(
        G=jnp.asarray(G / nrm[:, None, None], dtype),
        g=jnp.asarray(g / nrm[:, None], dtype),
        h=jnp.asarray(h / nrm, dtype),
    )


def batched_dense_from_qcqp(instances, dtype=jnp.float32) -> DenseRows:
    """Stack per-instance normalized dense blocks into (B, m_max, ...) leaves
    for the sharded batched round (parallel/round.py).  Instances with fewer
    constraints get inert all-zero rows (h = 0, coefficients 0: the residual
    max(h - Kz, 0) is identically 0, so padding never binds)."""
    B = len(instances)
    n = instances[0].n
    m_max = max(inst.m for inst in instances)
    G = np.zeros((B, m_max, n, n), np.float64)
    g = np.zeros((B, m_max, n), np.float64)
    h = np.zeros((B, m_max), np.float64)
    for i, inst in enumerate(instances):
        if inst.m == 0:
            continue
        d = dense_from_qcqp(inst.Qs, inst.cs, inst.bs, jnp.float32)
        G[i, :inst.m] = np.asarray(d.G)
        g[i, :inst.m] = np.asarray(d.g)
        h[i, :inst.m] = np.asarray(d.h)
    return DenseRows(G=jnp.asarray(G, dtype), g=jnp.asarray(g, dtype),
                     h=jnp.asarray(h, dtype))


def dense_residuals(x, X, dense: DenseRows, include_rhs: bool = True):
    """K z (linear part) for the dense block; (m,)."""
    r = (jnp.einsum("mij,ij->m", dense.G, X, precision=PRECISION)
         + jnp.dot(dense.g, x, precision=PRECISION))
    if include_rhs:
        r = r - dense.h
    return r


def dense_adjoint(yD, dense: DenseRows):
    """(gx, gX) = K^T yD for the dense block."""
    gx = jnp.dot(dense.g.T, yD, precision=PRECISION)
    gX = jnp.einsum("m,mij->ij", yD, dense.G, precision=PRECISION)
    return gx, gX
