"""Every selection strategy (SURVEY.md section 0.4) runs end-to-end and
improves the bound on an instance with a real SDP gap."""

import pytest

from sdpcutsel_tpu.config import CutConfig, LPConfig, RunConfig, ScorerConfig
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.loop import CutSolver

STRATEGIES = [
    "feasibility", "neural", "random", "combined", "optimality", "triangle",
]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_improves_bound(strategy):
    inst = generate_spar(12, 100, 3)
    cfg = RunConfig(
        lp=LPConfig(max_iters=6000, tol=1e-5),
        cuts=CutConfig(k=3, sel_size=10, capacity=128),
        scorer=ScorerConfig(strategy=strategy),
    )
    s = CutSolver(inst, cfg)
    hist = s.run(rounds=2)
    assert hist[0].cuts_added > 0
    bounds = [h.bound for h in hist]
    assert bounds[-1] < bounds[0] - 1e-4
    # certified bound sequence is monotone by construction
    assert all(b2 <= b1 + 1e-9 for b1, b2 in zip(bounds, bounds[1:]))


def test_unknown_strategy_raises():
    inst = generate_spar(10, 100, 1)
    cfg = RunConfig(scorer=ScorerConfig(strategy="nope"))
    with pytest.raises(ValueError, match="unknown strategy"):
        CutSolver(inst, cfg)


def test_replica_diverse_select_matches_jax_diverse_topk():
    """baseline/cpu_reference._diverse_select is the numpy twin of
    ops/topk.diverse_topk: same scores + table -> same
    selected candidates in the same order."""
    import numpy as np

    from sdpcutsel_tpu.baseline.cpu_reference import _diverse_select
    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.ops.topk import diverse_topk

    rng = np.random.default_rng(3)
    n, k, sel = 14, 3, 10
    table = combinations_table(n, k)
    # tie-heavy scores (quantized) exercise exactly the regime diversity
    # re-orders; a small alpha only breaks (near-)ties
    scores = np.round(rng.random(table.shape[0]) * 8) / 8.0
    alpha = 1e-4
    sel_cpu = _diverse_select(scores, table, sel, alpha, n)

    import jax.numpy as jnp

    _, sel_jax, valid = diverse_topk(
        jnp.asarray(scores, jnp.float32), jnp.asarray(table), sel, n, alpha)
    np.testing.assert_array_equal(sel_cpu, np.asarray(sel_jax)[np.asarray(valid)])
