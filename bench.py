"""Benchmark entry point. Prints one JSON line per metric:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Needs a GPU: with no GPU it exits non-zero and prints no metric.  Every line
names the device it ran on (platform, device_kind, device count).

Metrics: the flagship end-to-end rounds/s (n=125, scan mode), the batched
instance-rounds/s (8 x n=30), and candidate cuts scored per second on the
largest BoxQP size (n=125, C(125,3)=317,750 candidates/round) through the
solver's own score function; vs_baseline = that rate / the measured CPU reference rate (the numpy/LAPACK
replica's scoring path, SURVEY.md section 6).
"""

import json
import os
import sys
import time

# Pinned CPU-baseline protocol: the vs_baseline denominator must not swing
# with whatever BLAS threading the host picked.  Fix the thread count BEFORE
# numpy loads its BLAS.
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_v, "2")

import numpy as np


def _device():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def scoring_rate(n=125, k=3, repeats=20):
    """On-device scoring rate of the path CutSolver takes at n=125 under the
    suite config (neural strategy): one jitted call of the solver's own
    score function over the whole candidate table, median of ``repeats``.
    Returns candidates scored per second."""
    import jax

    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.loop import CutSolver
    from sdpcutsel_tpu.utils.profiling import timed

    solver = CutSolver(generate_spar(n, 100, 1), _suite_cfg(use_scan=False))
    score = jax.jit(solver._score_fn)
    T = n * (n - 1) * (n - 2) // 6           # candidates per pass
    rng = np.random.default_rng(0)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((n, n)), 0, 1)
    x = jax.numpy.asarray(x, jax.numpy.float32)
    X = jax.numpy.asarray(0.5 * (X + X.T), jax.numpy.float32)
    sec, _ = timed(score, x, X, jax.random.PRNGKey(0), solver._score_consts,
                   repeats=repeats)
    return T / sec


def cpu_scoring_rate(n=125, k=3, sample=30_000, repeats=5, warmup=1):
    """Reference-shaped numpy scoring (gather + batched LAPACK eigh + MLP
    matmuls) on a candidate subsample, extrapolated per-candidate.

    Median of ``repeats`` timed passes after ``warmup`` untimed ones —
    mirrors utils/profiling.timed, so the vs_baseline denominator does not
    swing with transient host load the way a single cold pass does."""
    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.instances import generate_spar

    inst = generate_spar(n, 100, 1)
    table = combinations_table(n, k)[:sample]
    rng = np.random.default_rng(0)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((n, n)), 0, 1)
    X = 0.5 * (X + X.T)

    W1 = rng.standard_normal((15, 64)); b1 = rng.standard_normal(64)
    W2 = rng.standard_normal((64, 64)); b2 = rng.standard_normal(64)
    W3 = rng.standard_normal((64, 1))

    def one_pass():
        t0 = time.perf_counter()
        xr = x[table]
        Xr = X[table[:, :, None], table[:, None, :]]
        Z = np.empty((table.shape[0], k + 1, k + 1))
        Z[:, 0, 0] = 1.0
        Z[:, 0, 1:] = xr
        Z[:, 1:, 0] = xr
        Z[:, 1:, 1:] = Xr
        np.linalg.eigvalsh(Z)  # feasibility scores
        Qr = inst.Q[table[:, :, None], table[:, None, :]]
        sc = np.abs(Qr).max((1, 2))
        iu = np.triu_indices(k)
        feats = np.concatenate(
            [Qr[:, iu[0], iu[1]] / np.maximum(sc, 1e-12)[:, None],
             xr, Xr[:, iu[0], iu[1]]], axis=1)
        h = np.maximum(feats @ W1 + b1, 0)
        h = np.maximum(h @ W2 + b2, 0)
        h @ W3  # NN scores
        return time.perf_counter() - t0

    for _ in range(warmup):
        one_pass()
    times = sorted(one_pass() for _ in range(repeats))
    return table.shape[0] / times[len(times) // 2]


def _suite_cfg(use_scan: bool):
    """The suite's recorded config (what scripts/run_suite_incremental.py
    runs): neural, sel_size=20, LP tol 2e-6, capacity 1024."""
    from sdpcutsel_tpu.config import (
        CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig,
    )

    return RunConfig(
        lp=LPConfig(max_iters=20000, tol=2e-6),
        cuts=CutConfig(k=3, sel_size=20, capacity=1024),
        scorer=ScorerConfig(strategy="neural"),
        loop=LoopConfig(use_scan=use_scan, polish_iters=0),
    )


def end_to_end_rate(n=125, rounds=10, repeats=3):
    """Full rounds/s at the flagship size — scan-mode CutSolver (all rounds
    in one dispatch), neural strategy, purge + support-diverse selection, at
    the suite config (_suite_cfg).

    Median of ``repeats`` timed solves; the timed quantity is the device
    dispatch time (RoundStats.wall_time_s, measured around
    block_until_ready inside run_scan).  The host-side f64 recertification
    of every round's bound is reported apart as ``host_recert_s_per_run``.
    Returns (rounds_per_sec, replica_rounds_per_sec, host_recert_s) where
    the denominator is the median replica in-loop rate at this n from
    results/replica_timing.jsonl, if that file exists (else None)."""
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.loop import CutSolver

    inst = generate_spar(n, 100, 1)
    cfg = _suite_cfg(use_scan=True)
    CutSolver(inst, cfg).run(rounds=rounds)          # warmup/compile
    rates, recerts = [], []
    for _ in range(repeats):
        solver = CutSolver(inst, cfg)
        t0 = time.perf_counter()
        hist = solver.run(rounds=rounds)             # incl. f64 recertify
        total = time.perf_counter() - t0
        device_s = sum(h.wall_time_s for h in hist)  # scan dispatch time
        rates.append(rounds / device_s)
        recerts.append(total - device_s)
    rates.sort()
    rate = rates[len(rates) // 2]

    replica = None
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results", "replica_timing.jsonl")
    if os.path.exists(path):
        rs = [json.loads(line)["rounds_per_s"] for line in open(path)
              if json.loads(line).get("n") == n]
        if rs:
            replica = sorted(rs)[len(rs) // 2]
    return rate, replica, sorted(recerts)[len(recerts) // 2]


def batched_scan_rate(n=30, batch=8, rounds=10, lp_iters=400, sel_size=16,
                      repeats=3):
    """Instance-batched scan-mode throughput — B instances solved concurrently through the
    sharded round machinery (parallel/round.make_sharded_scan_step), all
    rounds in ONE dispatch, neural strategy, f64-certifiable duals stacked
    per round.  Median of ``repeats`` timed dispatches."""
    import jax
    import jax.numpy as jnp

    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.parallel.mesh import make_mesh
    from sdpcutsel_tpu.parallel.round import (
        init_batched_state, make_sharded_scan_step, shard_batched_state,
    )
    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.parallel.sharding import shard_candidates

    mesh = make_mesh(data=1, cand=1)
    insts = [generate_spar(n, 100, s + 1) for s in range(batch)]
    Qb = jnp.asarray(np.stack([i.Q for i in insts]), jnp.float32)
    cb = jnp.asarray(np.stack([i.c for i in insts]), jnp.float32)
    state0 = shard_batched_state(
        init_batched_state(Qb, cb, capacity=1024, kmax=3), mesh)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)
    scan = make_sharded_scan_step(mesh, rounds=rounds, lp_iters=lp_iters,
                                  sel_size=sel_size, strategy="neural")
    out = scan(state0, table, valid)                 # warmup/compile
    jax.block_until_ready(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(scan(state0, table, valid))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    return batch * rounds / dt


def main():
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found "
                 f"{jax.devices()[0].platform!r} devices")
    enable_compile_cache()
    device = _device()
    rate_cpu = cpu_scoring_rate()
    rate_dev = scoring_rate()
    e2e, replica, recert_s = end_to_end_rate()
    batched = batched_scan_rate()
    print(json.dumps({
        "metric": "end_to_end_rounds_per_sec_n125",
        "value": round(e2e, 3),
        "unit": "suite-config rounds/s (n=125 scan mode, neural, sel_size=20,"
                " device dispatch time, median of 3; every round's bound f64-"
                "certified on host, cost reported apart)",
        "vs_baseline": (round(e2e / replica, 2) if replica else None),
        "baseline_replica_rounds_per_sec": (round(replica, 3)
                                            if replica else None),
        "host_recert_s_per_run": round(recert_s, 3),
        "device": device,
    }))
    print(json.dumps({
        "metric": "batched_instance_rounds_per_sec",
        "value": round(batched, 1),
        "unit": "instance-rounds/s/device (8 x n=30 concurrent, scan mode, "
                "neural, one dispatch for the whole batched multi-round "
                "solve; median of 3)",
        "vs_baseline": None,
        "device": device,
    }))
    print(json.dumps({
        "metric": "candidate_cuts_scored_per_sec_per_device",
        "value": round(rate_dev, 1),
        "unit": "candidates/s/device (n=125, k=3, neural scoring through "
                "the solver's score function)",
        "vs_baseline": round(rate_dev / max(rate_cpu, 1e-9), 2),
        # denominator recorded so the ratio is reproducible
        "baseline_cpu_rate_per_sec": round(rate_cpu, 1),
        "device": device,
    }))


if __name__ == "__main__":
    main()
