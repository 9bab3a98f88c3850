"""Debug mode (SURVEY.md section 5.2).

On-device data races cannot exist (XLA programs are race-free by
construction), so the analogue here of the reference-era sanitizers is
numerical: (a) jax's NaN-checking mode, which faults at the first NaN/Inf
produced inside any jitted computation, and (b) chex assertions validating
the solver state's shapes and finiteness at round granularity.

Enabled by ``RunConfig(debug=True)`` or the CLI ``--debug`` flag; costs one
re-execution per dispatch under NaN checking, so it is strictly a debugging
aid, never on in benchmarks.
"""

from __future__ import annotations

import chex
import jax
import numpy as np


def enable_debug_mode() -> None:
    """Turn on jax NaN/Inf checking globally (persists for the process)."""
    jax.config.update("jax_debug_nans", True)


def check_round_state(x, X, pool, bound: float) -> None:
    """chex validation of one round's state: shapes consistent, every array
    finite, certified bound a finite scalar.  Raises AssertionError."""
    chex.assert_rank(x, 1)
    chex.assert_rank(X, 2)
    n = x.shape[0]
    chex.assert_shape(X, (n, n))
    chex.assert_shape(pool.lin, (pool.capacity, pool.kmax))
    chex.assert_shape(pool.quad, (pool.capacity, pool.kmax, pool.kmax))
    chex.assert_tree_all_finite((x, X, pool.lin, pool.quad, pool.rhs,
                                 pool.active))
    if not np.isfinite(bound):
        raise AssertionError(f"non-finite certified bound: {bound}")
