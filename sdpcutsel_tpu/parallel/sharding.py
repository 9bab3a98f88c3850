"""Candidate-space sharding and the global top-k collective (P1/P5).

The C(n,k) candidate table is sharded contiguously across the 'cand' mesh
axis.  Each shard scores its local candidates, takes a LOCAL top-sel_size
(lax.top_k), and only those (sel_size values + global indices) cross the
interconnect in one all_gather; the global top-k then runs replicated on the
tiny gathered set.  Communication per round: P * sel_size * 8 bytes — nothing
rides the network proportional to C(n,k).

Determinism (SURVEY.md hard part 5): the table is sharded in contiguous
order and lax.top_k breaks ties toward lower positions, so local winners and
the gathered order reproduce the single-device selection exactly when scores
are tie-free; under ties the gathered array preserves (shard, local) =
global candidate order, giving mesh-layout-independent selection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def pad_table(table: np.ndarray, parts: int):
    """Pad the candidate table to a multiple of `parts` rows.

    Padded rows repeat candidate 0 and are masked out by the validity mask.
    Returns (padded (Tp, k), valid (Tp,)).
    """
    T = table.shape[0]
    Tp = ((T + parts - 1) // parts) * parts
    pad = Tp - T
    padded = np.concatenate([table, np.tile(table[:1], (pad, 1))]) if pad else table
    valid = np.concatenate([np.ones(T, bool), np.zeros(pad, bool)])
    return padded, valid


def shard_candidates(table: np.ndarray, mesh: Mesh):
    """Place the table, padded to a multiple of the 'cand' axis size, with
    rows sharded over 'cand'.  Returns (table, valid)."""
    padded, valid = pad_table(np.asarray(table), mesh.shape["cand"])
    sharding = NamedSharding(mesh, P("cand", None))
    return (
        jax.device_put(jnp.asarray(padded), sharding),
        jax.device_put(jnp.asarray(valid), NamedSharding(mesh, P("cand"))),
    )


def sharded_score_and_select(score_local_fn, mesh: Mesh, sel_size: int):
    """Build the sharded score->select step.

    score_local_fn(x, X, table_shard, valid_shard) -> (Tshard,) local scores
    (any strategy; runs independently per shard — x, X are replicated).

    Returns fn(x, X, table, valid) -> (global_scores_topk, global_rows (S, k),
    sel_valid (S,)) with table sharded over 'cand'.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("cand", None), P("cand")),
        out_specs=(P(), P(), P()),
        check_vma=False,  # outputs are replicated by the all_gather+top_k
    )
    def step(x, X, table_shard, valid_shard):
        scores = score_local_fn(x, X, table_shard, valid_shard)
        neg = jnp.asarray(-jnp.inf, scores.dtype)
        scores = jnp.where(valid_shard, scores, neg)
        lv, li = jax.lax.top_k(scores, sel_size)              # local winners
        rows = table_shard[li]                                # (S, k)
        # gather all shards' winners: (P*S,) values + (P*S, k) rows
        gv = jax.lax.all_gather(lv, "cand", tiled=True)
        gr = jax.lax.all_gather(rows, "cand", tiled=True)
        v, i = jax.lax.top_k(gv, sel_size)                    # global top-k
        return v, gr[i], jnp.isfinite(v)

    return step
