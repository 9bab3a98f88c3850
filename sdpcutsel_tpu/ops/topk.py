"""Top-k selection helpers with deterministic tie-breaking.

Deterministic selection matters for cross-shard reproducibility: the sharded
global top-k (parallel/sharding.py) must pick the same cuts regardless of mesh
layout (SURVEY.md section 7, hard part 5).  jax.lax.top_k breaks ties toward
the lower index, which composes deterministically with shard-local offsets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def masked_topk(scores, k: int, mask=None):
    """Top-k scores with invalid entries masked to -inf.

    Returns (values: (k,), indices: (k,), valid: (k,) — finite entries)."""
    if mask is not None:
        neg = jnp.asarray(-jnp.inf, scores.dtype)
        scores = jnp.where(mask, scores, neg)
    vals, idx = jax.lax.top_k(scores, k)
    valid = jnp.isfinite(vals)
    return vals, idx, valid


def diverse_topk(scores, table, k: int, n: int, alpha: float, mask=None):
    """Greedy support-diverse top-k over candidate index subsets.

    At a McCormick LP optimum, candidate violations are massively tied (often
    60+ candidates share -lambda_min exactly, for sel_size=20 slots), and
    lax.top_k's lowest-index tie-breaking then selects lexicographically
    clustered subsets whose supports overlap heavily — near-redundant cuts
    (measured: spar050-100-1 feasibility gap closed 0.086 plain vs 0.188
    diverse at equal budget, replica 0.116).  This selects iteratively,
    penalizing each candidate by alpha x (how often its indices were already
    used by selected candidates):

        pick argmax( score - alpha * sum_i in rho count[i] ),  k times.

    alpha small (default config: 1e-4 x score scale) so the penalty only
    re-orders (near-)ties; genuinely better-scoring candidates still win.
    Same return convention as masked_topk: (values, indices, valid), where
    values are the ORIGINAL scores of the picks (monotonicity of the bound
    does not depend on selection order).  O(k * C) — one scan of k steps.
    """
    neg = jnp.asarray(-jnp.inf, scores.dtype)
    if mask is not None:
        scores = jnp.where(mask, scores, neg)
    C = scores.shape[0]
    iota = jnp.arange(C)

    # Per-candidate penalty is maintained INCREMENTALLY instead of
    # re-gathering counts[table].sum(1) — a (C, k) gather per greedy step
    # inside the scan.  Picking candidate i adds
    # 1 to each of its indices' counts, so every other candidate's penalty
    # grows by its number of index matches with table[i] — a vectorized
    # (C, k, k) compare, no gather.  Identical math incl. duplicate-index
    # padding rows (both sides count per occurrence).
    def body(carry, _):
        sc, pen = carry
        eff = sc - jnp.asarray(alpha, sc.dtype) * pen
        i = jnp.argmax(eff)
        val = sc[i]
        picked_real = jnp.isfinite(val)
        idx_i = table[i]                               # (k,) single-row gather
        add = (table[:, :, None] == idx_i[None, None, :]).sum(
            (1, 2)).astype(sc.dtype)
        pen = jnp.where(picked_real, pen + add, pen)
        sc = jnp.where(iota == i, neg, sc)
        return (sc, pen), (val, i)

    (_, _), (vals, sel) = jax.lax.scan(
        body, (scores, jnp.zeros((C,), scores.dtype)), None, length=k)
    return vals, sel, jnp.isfinite(vals)
