"""Offline NN pipeline: subproblem sampling, exact labeling, MLP training.

Re-design of the reference's TF/Keras offline stage (SURVEY.md sections 0.6,
3.2): the label "solver" is the batched ADMM small-SDP oracle in labels.py, so
the WHOLE pipeline — sampling, exact labeling of hundreds of
thousands of subproblems, and MLP training — runs on device.

Sampling distribution (matches solve-time statistics):
  Qhat  — symmetric, entries U[-1,1], rescaled to max-abs 1, random density
          mask (dense BoxQP candidates see mostly dense blocks, QCQP sparse);
  x*    — U[0,1]^k;
  X*    — mixture of McCormick vertices (LP optima sit at bounds) and uniform
          interior points of the McCormick box at x*.

Label = max(0, 1/2<Qhat, X*> - s(Qhat; x*)) — the exact optimality score.

Run:  python -m sdpcutsel_tpu.models.train --k 3 --samples 200000
"""

from __future__ import annotations

import argparse
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .features import tri_indices
from .labels import _mccormick_box, solve_subproblem_admm
from .scorer import artifact_path, init_params, mlp_apply, save_params


def sample_subproblems(key, k: int, num: int, dup_frac: float = 0.0):
    """Returns (Qhat (N,k,k), x (N,k), X (N,k,k)).

    dup_frac: fraction of samples whose LAST coordinate duplicates their
    first (row/col copies in Q, x, X) — matching the padded clique-subset
    tables the QCQP path feeds the k>=4 scorers (qcqp/chordal.py pads
    smaller subsets by repeating the last index)."""
    kq, kd, kx, kxm, kv, kc = jax.random.split(key, 6)
    Q = jax.random.uniform(kq, (num, k, k), minval=-1.0, maxval=1.0)
    Q = 0.5 * (Q + jnp.swapaxes(Q, 1, 2))
    # random density: keep each off-diagonal with prob p ~ U[0.3, 1]
    p = jax.random.uniform(kd, (num, 1, 1), minval=0.3, maxval=1.0)
    mask = jax.random.uniform(kc, (num, k, k)) < p
    mask = mask | jnp.swapaxes(mask, 1, 2) | jnp.eye(k, dtype=bool)
    Q = Q * mask
    scale = jnp.maximum(jnp.max(jnp.abs(Q), axis=(1, 2), keepdims=True), 1e-6)
    Q = Q / scale

    x = jax.random.uniform(kx, (num, k))
    lo, hi = _mccormick_box(x)
    t = jax.random.uniform(kxm, (num, k, k))
    t = 0.5 * (t + jnp.swapaxes(t, 1, 2))
    interior = lo + t * (hi - lo)
    vert_pick = jax.random.bernoulli(kv, 0.5, (num, k, k))
    vert_pick = vert_pick & jnp.swapaxes(vert_pick, 1, 2)
    vertex = jnp.where(vert_pick, hi, lo)
    use_vertex = jax.random.bernoulli(kv, 0.5, (num, 1, 1))
    X = jnp.where(use_vertex, vertex, interior)

    if dup_frac > 0.0:
        dup = jax.random.bernoulli(kc, dup_frac, (num,))
        x = jnp.where(dup[:, None] & (jnp.arange(k) == k - 1)[None, :],
                      x[:, :1], x)

        def dup_mat(M):
            M = jnp.where(dup[:, None, None]
                          & (jnp.arange(k) == k - 1)[None, :, None],
                          M[:, :1, :], M)
            return jnp.where(dup[:, None, None]
                             & (jnp.arange(k) == k - 1)[None, None, :],
                             M[:, :, :1], M)

        Q, X = dup_mat(Q), dup_mat(X)
    return Q, x, X


def make_features(Qhat, x, X):
    k = x.shape[-1]
    i0, i1 = tri_indices(k)
    return jnp.concatenate([Qhat[:, i0, i1], x, X[:, i0, i1]], axis=1)


def gen_dataset(key, k: int, num: int, admm_iters: int = 400,
                chunk: int = 65536, dup_frac: float = 0.0):
    """Exact-labeled dataset, generated in device-sized chunks."""
    feats_all, labels_all = [], []
    done = 0
    while done < num:
        key, sub = jax.random.split(key)
        m = min(chunk, num - done)
        Q, x, X = sample_subproblems(sub, k, m, dup_frac=dup_frac)
        current = 0.5 * jnp.sum(Q * X, axis=(1, 2))
        s, _ = solve_subproblem_admm(Q, x, iters=admm_iters)
        labels = jnp.maximum(current - s, 0.0)
        feats_all.append(np.asarray(make_features(Q, x, X)))
        labels_all.append(np.asarray(labels))
        done += m
    return np.concatenate(feats_all), np.concatenate(labels_all)


def harvest_dataset(k: int, instances=None, rounds: int = 4,
                    per_round: int = 4096, admm_iters: int = 400,
                    seed: int = 0, lp_max_iters: int = 10_000):
    """Exact-labeled dataset harvested from REAL cutting-plane runs.

    The reference trains on subproblems sampled from LP relaxations
    (SURVEY.md section 0.6); synthetic box sampling misses the candidate
    statistics the scorer sees at solve time (vertex-structured X*, scores
    concentrated near zero).  This runs the feasibility-strategy loop on a
    set of generated instances and, each round, exactly labels a random
    subsample of candidate blocks at the actual LP point.
    """
    from ..config import CutConfig, LPConfig, RunConfig, ScorerConfig
    from ..cuts.enumerate import combinations_table
    from ..instances.boxqp import generate_spar
    from ..loop.solver import CutSolver

    if instances is None:
        instances = [generate_spar(n, d, s)
                     for n in (20, 30) for d in (50, 100) for s in (1, 2)]
    rng = np.random.default_rng(seed)
    feats_all, labels_all = [], []
    cfg = RunConfig(
        lp=LPConfig(max_iters=lp_max_iters, tol=2e-6),
        cuts=CutConfig(k=k, sel_size=max(4, 20), capacity=1024),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    for inst in instances:
        solver = CutSolver(inst, cfg)
        table = np.asarray(combinations_table(inst.n, k))
        Qfull = jnp.asarray(inst.Q, jnp.float32)
        for _ in range(rounds):
            solver.do_round()
            x = solver.state.x
            X = solver.state.X
            sel = rng.choice(table.shape[0],
                             size=min(per_round, table.shape[0]),
                             replace=False)
            idx = jnp.asarray(table[sel])
            Qr = Qfull[idx[:, :, None], idx[:, None, :]]
            scale = jnp.maximum(jnp.max(jnp.abs(Qr), axis=(1, 2)), 1e-12)
            Qhat = Qr / scale[:, None, None]
            xr = x[idx]
            Xr = X[idx[:, :, None], idx[:, None, :]]
            current = 0.5 * jnp.sum(Qhat * Xr, axis=(1, 2))
            s, _ = solve_subproblem_admm(Qhat, xr, iters=admm_iters)
            labels = jnp.maximum(current - s, 0.0)
            feats_all.append(np.asarray(make_features(Qhat, xr, Xr)))
            labels_all.append(np.asarray(labels))
    return np.concatenate(feats_all), np.concatenate(labels_all)


def harvest_dataset_qcqp(k: int, specs=None, rounds: int = 4,
                         per_round: int = 2048, admm_iters: int = 400,
                         seed: int = 0, lp_max_iters: int = 10_000):
    """Exact-labeled dataset harvested from REAL sparse-QCQP runs.

    The k>=4 scorers serve the QCQP path, whose candidate statistics differ
    from dense BoxQP in two ways the synthetic/BoxQP harvests can't cover:
    clique-subset tables padded by index duplication (qcqp/chordal.py) and LP
    points shaped by the linearized quadratic-constraint rows.  Runs the
    feasibility-strategy QCQP loop and labels a random subsample of the
    clique-candidate blocks at each round's actual LP point.
    """
    from ..config import CutConfig, LPConfig, RunConfig, ScorerConfig
    from ..instances.qcqp import generate_qcqp
    from ..qcqp.solver import CutSolverQCQP

    if specs is None:
        specs = [(15, 30, 3, 1), (15, 30, 3, 2), (20, 25, 4, 1),
                 (20, 25, 4, 2), (25, 20, 4, 1)]
    rng = np.random.default_rng(seed)
    feats_all, labels_all = [], []
    cfg = RunConfig(
        lp=LPConfig(max_iters=lp_max_iters, tol=2e-6),
        cuts=CutConfig(k=k, sel_size=16, capacity=1024),
        scorer=ScorerConfig(strategy="feasibility"),
    )
    for spec in specs:
        inst = generate_qcqp(*spec)
        solver = CutSolverQCQP(inst, cfg)
        table = np.asarray(solver.table)[np.asarray(solver.table_valid)]
        Qfull = jnp.asarray(inst.Q0, jnp.float32)
        for _ in range(rounds):
            solver.do_round()
            x, X = solver.state.x, solver.state.X
            sel = rng.choice(table.shape[0],
                             size=min(per_round, table.shape[0]),
                             replace=False)
            idx = jnp.asarray(table[sel])
            Qr = Qfull[idx[:, :, None], idx[:, None, :]]
            scale = jnp.maximum(jnp.max(jnp.abs(Qr), axis=(1, 2)), 1e-12)
            Qhat = Qr / scale[:, None, None]
            xr = x[idx]
            Xr = X[idx[:, :, None], idx[:, None, :]]
            current = 0.5 * jnp.sum(Qhat * Xr, axis=(1, 2))
            s, _ = solve_subproblem_admm(Qhat, xr, iters=admm_iters)
            labels = jnp.maximum(current - s, 0.0)
            feats_all.append(np.asarray(make_features(Qhat, xr, Xr)))
            labels_all.append(np.asarray(labels))
    return np.concatenate(feats_all), np.concatenate(labels_all)


def train_scorer(
    k: int = 3,
    samples: int = 200_000,
    steps: int = 4000,
    batch: int = 4096,
    lr: float = 1e-3,
    hidden=(64, 64),
    seed: int = 0,
    out_path: str | None = None,
    verbose: bool = True,
    harvest: bool = True,
    harvest_rounds: int = 4,
):
    key = jax.random.PRNGKey(seed)
    key, kd = jax.random.split(key)
    t0 = time.time()
    # k>=4 scorers serve the QCQP padded tables: include duplicated-index
    # samples so those inputs are in-distribution
    feats, labels = gen_dataset(kd, k, samples,
                                dup_frac=0.25 if k >= 4 else 0.0)
    if harvest:
        hf, hl = harvest_dataset(k, rounds=harvest_rounds, seed=seed)
        feats = np.concatenate([feats, hf])
        labels = np.concatenate([labels, hl])
        perm = np.random.default_rng(seed).permutation(len(feats))
        feats, labels = feats[perm], labels[perm]
    if verbose:
        print(f"[train] dataset: {feats.shape} labeled in {time.time()-t0:.1f}s "
              f"(mean label {labels.mean():.4f}, "
              f"frac>1e-3 {(labels > 1e-3).mean():.3f})")

    n_train = int(0.95 * len(feats))
    ftr, ltr = feats[:n_train], labels[:n_train]
    fte, lte = feats[n_train:], labels[n_train:]
    if harvest and k >= 4:
        # k>=4 serves the QCQP path: harvest from real QCQP runs too
        # (clique-padded candidates at constraint-shaped LP points).  Split
        # BEFORE upweighting so repeated train rows never leak into the
        # holdout; upweight by repetition because the QCQP tables are small
        # and the synthetic pool would otherwise drown these rows.
        qf, ql = harvest_dataset_qcqp(k, rounds=harvest_rounds, seed=seed)
        qperm = np.random.default_rng(seed + 1).permutation(len(qf))
        qf, ql = qf[qperm], ql[qperm]
        q_tr = int(0.95 * len(qf))
        reps = max(1, int(0.25 * n_train / max(q_tr, 1)))
        ftr = np.concatenate([ftr] + [qf[:q_tr]] * reps)
        ltr = np.concatenate([ltr] + [ql[:q_tr]] * reps)
        tperm = np.random.default_rng(seed + 2).permutation(len(ftr))
        ftr, ltr = ftr[tperm], ltr[tperm]
        fte = np.concatenate([fte, qf[q_tr:]])
        lte = np.concatenate([lte, ql[q_tr:]])
        if verbose:
            print(f"[train] +qcqp harvest: {len(qf)} rows x{reps} into train, "
                  f"{len(qf) - q_tr} into holdout")
    n_train = len(ftr)
    ftr, ltr = jnp.asarray(ftr), jnp.asarray(ltr)
    fte, lte = jnp.asarray(fte), jnp.asarray(lte)

    params = init_params(k, hidden, seed)
    sched = optax.cosine_decay_schedule(lr, steps)
    opt = optax.adam(sched)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        idx = jax.random.randint(key, (batch,), 0, n_train)
        fb, lb = ftr[idx], ltr[idx]

        def loss_fn(p):
            pred = mlp_apply(p, fb)
            return jnp.mean((pred - lb) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    t0 = time.time()
    for i in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        if verbose and (i % 500 == 0 or i == steps - 1):
            pred = mlp_apply(params, fte)
            mse = float(jnp.mean((pred - lte) ** 2))
            var = float(jnp.var(lte))
            # rank quality matters for selection: Spearman on holdout
            rs = _spearman(np.asarray(pred), np.asarray(lte))
            print(f"[train] step {i}: loss={float(loss):.5f} "
                  f"holdout R2={1 - mse / max(var, 1e-12):.3f} spearman={rs:.3f}")

    out_path = out_path or artifact_path(k)
    save_params(params, out_path)
    pred = np.asarray(mlp_apply(params, fte))
    lte_np = np.asarray(lte)
    mse = float(np.mean((pred - lte_np) ** 2))
    # ranking quality where it matters: among genuinely improving candidates,
    # and precision of the predicted top decile at catching the true top decile
    pos = lte_np > 1e-3
    q = np.quantile(lte_np, 0.9)
    top_true = lte_np >= q
    top_pred = pred >= np.quantile(pred, 0.9)
    metrics = {
        "holdout_mse": mse,
        "holdout_r2": 1 - mse / max(float(np.var(lte_np)), 1e-12),
        "holdout_spearman": _spearman(pred, lte_np),
        "spearman_positive": (
            _spearman(pred[pos], lte_np[pos]) if pos.sum() > 10 else None
        ),
        "precision_at_top10pct": float((top_true & top_pred).sum()
                                       / max(top_true.sum(), 1)),
        "train_time_s": time.time() - t0,
        "samples": int(len(feats)),
    }
    if verbose:
        print(f"[train] saved {out_path}: {metrics}")
    return params, metrics


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / max(denom, 1e-12))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--samples", type=int, default=200_000)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    train_scorer(k=args.k, samples=args.samples, steps=args.steps,
                 seed=args.seed, out_path=args.out)


if __name__ == "__main__":
    main()
