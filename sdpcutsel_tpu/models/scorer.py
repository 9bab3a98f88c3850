"""MLP cut scorers — the NN-estimated optimality strategy (headline).

One small dense MLP per submatrix dimension k (SURVEY.md section 0.6: "a few
hidden layers, ~tens of units", trained offline, shipped in-repo).  At solve
time the entire candidate batch is scored in one matmul pass.

The MLP is a plain jnp function over a params dict
{"W0", "b0", ..., "W{L}", "b{L}"} (ReLU between layers, one output unit).
Weights ship as ``.npz`` artifacts under models/artifacts/mlp_k{k}.npz
(trained by models/train.py); absent an artifact the scorer falls back to a
deterministic random init (useful for tests; quality then ~ random strategy).

Precision: every MLP product runs at ``Precision.HIGHEST`` (full f32, no TF32
or bf16 passes on any backend), so scores agree with an f32 numpy reference
to f32 rounding (tests/test_models.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ScorerConfig
from ..cuts.eigen import feasibility_scores_from_point
from .features import candidate_features, candidate_q_features, feature_dim

_ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "artifacts")
PRECISION = jax.lax.Precision.HIGHEST


def artifact_path(k: int) -> str:
    return os.path.join(_ARTIFACT_DIR, f"mlp_k{k}.npz")


def mlp_layers(params) -> list:
    """[(W0, b0), ..., (WL, bL)] in application order."""
    return [(params[f"W{i}"], params[f"b{i}"])
            for i in range(len(params) // 2)]


def init_params(k: int, hidden=(64, 64), seed: int = 0) -> dict:
    """Deterministic LeCun-normal kernels, zero biases."""
    dims = [feature_dim(k), *hidden, 1]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(dims) - 1)
    init = jax.nn.initializers.lecun_normal()
    params = {}
    for i, (key, d_in, d_out) in enumerate(zip(keys, dims[:-1], dims[1:])):
        params[f"W{i}"] = init(key, (d_in, d_out), jnp.float32)
        params[f"b{i}"] = jnp.zeros((d_out,), jnp.float32)
    return params


def mlp_apply(params, feats):
    """feats (B, d) -> predicted scale-normalized improvement (B,)."""
    layers = mlp_layers(params)
    h = feats
    for W, b in layers[:-1]:
        h = jnp.maximum(jnp.dot(h, W, precision=PRECISION) + b, 0.0)
    W, b = layers[-1]
    return (jnp.dot(h, W, precision=PRECISION) + b)[:, 0]


def save_params(params, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **{name: np.asarray(a) for name, a in params.items()})


def load_params(k: int, hidden=(64, 64), path: str | None = None,
                seed: int = 0):
    """Load the trained artifact for dimension k, or deterministic init.
    Returns (params, found)."""
    template = init_params(k, hidden, seed)
    path = path or artifact_path(k)
    if not os.path.exists(path):
        return template, False
    with np.load(path) as z:
        params = {name: jnp.asarray(z[name]) for name in z.files}
    want = {name: a.shape for name, a in template.items()}
    got = {name: a.shape for name, a in params.items()}
    if got != want:
        raise ValueError(f"{path}: layer shapes {got} do not match "
                         f"k={k}, hidden={tuple(hidden)}: {want}")
    return params, True


def generic_scores(x, X, table, triQ, scale, params, sweeps: int = 6):
    """(nn, feas) for every row of any candidate table (dense C(n,k) or the
    QCQP clique table): nn = scale * relu(MLP(features)), feas =
    -lambda_min(Z(rho)) by the struct-of-arrays Jacobi (ops/jacobi.py)."""
    feats = candidate_features(triQ, x, X, table)
    nn = scale * jnp.maximum(mlp_apply(params, feats), 0.0)
    feas = feasibility_scores_from_point(x, X, table, sweeps=sweeps)
    return nn, feas


def neural_score_fn(Q, table, cfg: ScorerConfig, combined: bool = False,
                    gate_tol: float = 0.0):
    """Build the jitted all-candidates scorer for one instance.

    score(rho) = scale(rho) * MLP(features(rho))  — the estimated bound
    improvement of cutting on rho.  With combined=True, candidates whose
    Z(rho) is not violated (feasibility score <= gate_tol) are masked out so
    the neural ranking only spends selections on violated candidates.
    Pass gate_tol = CutConfig.viol_tol to gate at the same threshold the cut
    generator uses (a candidate below it cannot emit a cut at all, so
    selecting it wastes the slot and can stall the loop once its cut is in
    the pool — see qcqp/solver.py).
    """
    k = int(table.shape[1])
    params, _ = load_params(k, tuple(cfg.hidden), cfg.weights_path, cfg.seed)
    triQ, scale = candidate_q_features(Q, table)

    @jax.jit
    def score(x, X, key):
        # without the gate XLA drops the unused lambda_min as dead code
        nn, viol = generic_scores(x, X, table, triQ, scale, params)
        return jnp.where(viol > gate_tol, nn, -jnp.inf) if combined else nn

    return score
