import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdpcutsel_tpu.models.features import (
    candidate_features, candidate_q_features, feature_dim,
)
from sdpcutsel_tpu.models.labels import (
    _mccormick_box, exact_improvement, solve_subproblem_admm,
)
from sdpcutsel_tpu.models.scorer import (
    artifact_path, generic_scores, init_params, load_params, mlp_apply,
    neural_score_fn, save_params,
)
from sdpcutsel_tpu.models.train import sample_subproblems, make_features
from sdpcutsel_tpu.config import ScorerConfig
from sdpcutsel_tpu.cuts.enumerate import combinations_table


def test_mccormick_box():
    x = jnp.asarray([[0.3, 0.8]])
    lo, hi = _mccormick_box(x)
    np.testing.assert_allclose(np.asarray(hi[0]), [[0.3, 0.3], [0.3, 0.8]])
    np.testing.assert_allclose(
        np.asarray(lo[0]), [[0.0, 0.1], [0.1, 0.6]], atol=1e-7
    )


def test_admm_k1_analytic():
    # k=1: q>0 -> s = q*x/2 ; q<0 -> s = q*x^2/2 (X >= x^2 binds)
    Q = jnp.asarray([[[2.0]], [[-2.0]]])
    x = jnp.asarray([[0.6], [0.6]])
    s, X = solve_subproblem_admm(Q, x, iters=500)
    np.testing.assert_allclose(float(s[0]), 0.6, atol=1e-3)
    np.testing.assert_allclose(float(s[1]), -0.36, atol=1e-3)


def test_admm_feasibility_and_bounds():
    key = jax.random.PRNGKey(0)
    Q, x, X0 = sample_subproblems(key, 3, 64)
    s, X = solve_subproblem_admm(Q, x, iters=500)
    lo, hi = _mccormick_box(x)
    X = np.asarray(X)
    assert (X >= np.asarray(lo) - 1e-3).all()
    assert (X <= np.asarray(hi) + 1e-3).all()
    # s must be >= value at the PSD-feasible point xx^T
    xxT = np.asarray(x)[:, :, None] * np.asarray(x)[:, None, :]
    v_feas = 0.5 * (np.asarray(Q) * xxT).sum((1, 2))
    assert (np.asarray(s) >= v_feas - 1e-3).all()
    # PSD-ness of X - xx^T up to tolerance
    wmin = np.linalg.eigvalsh(X - xxT)[:, 0]
    assert (wmin >= -5e-3).all()


def test_exact_improvement_zero_on_psd_point():
    key = jax.random.PRNGKey(1)
    Q, x, _ = sample_subproblems(key, 3, 32)
    xxT = x[:, :, None] * x[:, None, :]
    imp = exact_improvement(Q, x, xxT, iters=400)
    assert float(jnp.max(imp)) <= 1e-3


def test_exact_improvement_positive_when_violated():
    # Q = -I at x = 0.5: without PSD, X_ii can sit at the box floor 0, but
    # X - xx^T >= 0 forces X_ii >= 0.25, so improvement = 3 * 0.25 / 2 = 0.375
    x = jnp.full((1, 3), 0.5)
    Q = -jnp.eye(3)[None]
    lo, hi = _mccormick_box(x)
    imp = exact_improvement(Q, x, lo, iters=400)
    np.testing.assert_allclose(float(imp[0]), 0.375, atol=5e-3)


def test_feature_shapes_and_scale_invariance():
    n, k = 8, 3
    table = jnp.asarray(combinations_table(n, k))
    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    Q = 0.5 * (Q + Q.T)
    triQ, scale = candidate_q_features(Q, table)
    triQ2, scale2 = candidate_q_features(3.0 * Q, table)
    np.testing.assert_allclose(np.asarray(triQ), np.asarray(triQ2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(scale2), 3 * np.asarray(scale), rtol=1e-5)
    x = jnp.asarray(rng.random(n), jnp.float32)
    X = jnp.outer(x, x)
    feats = candidate_features(triQ, x, X, table)
    assert feats.shape == (table.shape[0], feature_dim(k))


def test_scorer_save_load_roundtrip(tmp_path):
    params = init_params(3)
    p = str(tmp_path / "m.npz")
    save_params(params, p)
    loaded, found = load_params(3, path=p)
    assert found
    chk = jax.tree.map(lambda a, b: np.allclose(a, b), params, loaded)
    assert all(jax.tree.leaves(chk))


def test_neural_score_fn_runs():
    n, k = 8, 3
    table = jnp.asarray(combinations_table(n, k))
    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    fn = neural_score_fn(Q, table, ScorerConfig(strategy="neural"))
    x = jnp.asarray(rng.random(n), jnp.float32)
    X = jnp.outer(x, x)
    s = fn(x, X, jax.random.PRNGKey(0))
    assert s.shape == (table.shape[0],)
    assert bool(jnp.isfinite(s).all())


def test_harvest_dataset_qcqp_shapes():
    """QCQP harvest rows have the k-scorer's feature dim and finite,
    nonnegative exact labels (train.py harvest_dataset_qcqp)."""
    from sdpcutsel_tpu.models.train import harvest_dataset_qcqp

    k = 4
    f, l = harvest_dataset_qcqp(
        k, specs=[(12, 30, 2, 1)], rounds=1, per_round=32,
        admm_iters=40, lp_max_iters=800,
    )
    assert f.shape == (32, feature_dim(k))
    assert l.shape == (32,)
    assert np.all(np.isfinite(f)) and np.all(np.isfinite(l))
    assert np.all(l >= 0.0)


def test_neural_score_fn_gates_on_violation():
    """gate_tol masks candidates whose Z(rho) is PSD at the current point:
    they cannot emit a cut (cuts/generate.py viol_tol), so an ungated NN
    ranking stalls the QCQP loop once its top picks are all in the pool
    (qcqp/solver.py regression)."""
    n, k = 8, 3
    table = jnp.asarray(combinations_table(n, k))
    rng = np.random.default_rng(0)
    Q = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
    x = jnp.asarray(rng.random(n), jnp.float32)

    # X = xx' makes every Z(rho) PSD (rank-1 completion): all gated out.
    fn = neural_score_fn(Q, table, ScorerConfig(strategy="neural"),
                         combined=True, gate_tol=1e-4)
    s_psd = fn(x, jnp.outer(x, x), jax.random.PRNGKey(0))
    assert bool((s_psd == -jnp.inf).all())

    # X = 0 off the diagonal-dominant completion violates PSD for generic x:
    # at least one candidate must survive the gate.
    s_viol = fn(x, jnp.zeros((n, n), jnp.float32), jax.random.PRNGKey(0))
    assert bool(jnp.isfinite(s_viol).any())


# sha256 over (name, float32 bytes) of each array, in sorted-name order, of
# the weights as decoded from the flax msgpack artifacts they were converted
# from (Dense_i kernel -> W{i}, bias -> b{i})
_MSGPACK_DIGESTS = {
    2: "78d61d10dd3a6d44ee31fb5af0654cbdcd43b2a3397004c588e8b15e2c78974e",
    3: "db9a460e00719bcbcfc8e406fe086070b70763c0685c5f71eb020d62ff46c366",
    4: "723599c579335342af31feb9471a501066f02ce960357c933c2d048bb4af8850",
    5: "31ccc1ad6681595f31903eba21dc0ee63edaa69eb11562af9c2817dea27f899a",
}


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_npz_weights_equal_msgpack_values(k):
    import hashlib

    with np.load(artifact_path(k)) as z:
        arrays = {name: z[name] for name in z.files}
    assert sorted(arrays) == ["W0", "W1", "W2", "b0", "b1", "b2"]
    assert arrays["W0"].shape == (feature_dim(k), 64)
    h = hashlib.sha256()
    for name in sorted(arrays):
        assert arrays[name].dtype == np.float32
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    assert h.hexdigest() == _MSGPACK_DIGESTS[k]


def _numpy_scores(Q, x, X, table, params):
    """f64 numpy reference: features (models/features.py layout), MLP with
    ReLU, and -lambda_min(Z(rho)) by LAPACK eigvalsh."""
    Q, x, X = (np.asarray(a, np.float64) for a in (Q, x, X))
    k = table.shape[1]
    i0, i1 = np.triu_indices(k)
    Qr = Q[table[:, :, None], table[:, None, :]]
    scale = np.abs(Qr).max(axis=(1, 2))
    xr = x[table]
    Xr = X[table[:, :, None], table[:, None, :]]
    feats = np.concatenate([(Qr / np.maximum(scale, 1e-12)[:, None, None])
                            [:, i0, i1], xr, Xr[:, i0, i1]], axis=1)
    h = feats
    L = len(params) // 2
    for i in range(L):
        h = h @ np.asarray(params[f"W{i}"], np.float64) \
            + np.asarray(params[f"b{i}"], np.float64)
        if i < L - 1:
            h = np.maximum(h, 0.0)
    nn = scale * np.maximum(h[:, 0], 0.0)
    Z = np.empty((table.shape[0], k + 1, k + 1))
    Z[:, 0, 0] = 1.0
    Z[:, 0, 1:] = xr
    Z[:, 1:, 0] = xr
    Z[:, 1:, 1:] = Xr
    feas = -np.linalg.eigvalsh(Z)[:, 0]
    return nn, feas


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_generic_scores_match_numpy(k):
    """The plain generic (nn, feas) scorer — the path QCQP and the sharded
    round take for every k — against f64 numpy: MLP at Precision.HIGHEST
    agrees to f32 rounding; the 6-sweep Jacobi lambda_min to 1e-5."""
    n = 14
    rng = np.random.default_rng(k)
    Q = rng.standard_normal((n, n))
    Q = 0.5 * (Q + Q.T)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.3 * rng.standard_normal((n, n)), 0, 1)
    X = 0.5 * (X + X.T)
    table = combinations_table(n, k)[:600].copy()
    if k >= 4:
        # QCQP-style padded supports: repeat the last index in some rows
        table[::7, -1] = table[::7, -2]
    params, found = load_params(k)
    assert found
    Qj, xj, Xj = (jnp.asarray(a, jnp.float32) for a in (Q, x, X))
    tj = jnp.asarray(table)
    triQ, scale = candidate_q_features(Qj, tj)
    nn, feas = jax.jit(generic_scores)(xj, Xj, tj, triQ, scale, params)
    nn_ref, feas_ref = _numpy_scores(Q, x, X, table, params)
    np.testing.assert_allclose(np.asarray(nn), nn_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(nn_ref).max())
    np.testing.assert_allclose(np.asarray(feas), feas_ref, atol=1e-5)


def test_neural_solve_imports_no_flax():
    """A neural solve needs neither flax nor msgpack: weights are .npz and
    the MLP is plain jnp."""
    code = (
        "import sys\n"
        "from sdpcutsel_tpu.config import CutConfig, LPConfig, RunConfig, "
        "ScorerConfig\n"
        "from sdpcutsel_tpu.instances import generate_spar\n"
        "from sdpcutsel_tpu.loop import CutSolver\n"
        "cfg = RunConfig(lp=LPConfig(max_iters=500), cuts=CutConfig(k=3, "
        "sel_size=4, capacity=32), scorer=ScorerConfig(strategy='neural'))\n"
        "h = CutSolver(generate_spar(10, 100, 1), cfg).run(rounds=1)\n"
        "assert len(h) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('flax', 'msgpack'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")
