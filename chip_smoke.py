"""Smoke test of the cutting-plane solver on one NVIDIA GPU.

    python chip_smoke.py               # all one-card phases
    python chip_smoke.py --four-cards  # only the sharded path on 4 cards
                                       # and its one-card comparison

Runs every phase in one process and stops with a non-zero exit at the first
failed check; no phase's failure is caught.  Phases:

  device   — a GPU is required (no fallback); prints the card's name and
             power limit (nvidia-smi, in a child process without JAX).
  scoring  — the candidate scorer at n = 125 (317,750 candidates): its
             memory analysis, the GPU against the host CPU device (MLP
             precision), and its time per strategy; timings of the PDHG
             iteration (n = 125, M = 1024) and of QCQP scoring (n = 50,
             k = 4).
  main     — CutSolver on spar125-100-1 (k = 3, neural, the bench's suite
             config): 10 rounds in scan mode, then 3 per-round rounds.
  backends — spar030-100-1 solved on the GPU and on the host CPU device.
  qcqp     — CutSolverQCQP on qcqpband050-4-13-1 (k = 4, neural).
  batched  — make_sharded_scan_step on a one-card mesh, 8 x n = 30.
  four     — (--four-cards only) BoxQP and QCQP sharded scans on meshes
             2x2 and 4x1 against one card, candidate axis at n = 125: the
             same cuts in every round, bounds to f32 rounding.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, phase: str, msg: str):
    if not cond:
        raise SystemExit(f"[{phase}] FAILED: {msg}")
    log(phase, f"ok: {msg}")


def median_time(fn, *args, repeats: int = 10):
    """Median wall seconds of ``fn(*args)`` to block_until_ready, after one
    warm-up call (which compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_device(expect_count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"[device] FAILED: no GPU; JAX found "
                         f"{devs[0].platform!r} devices")
    if len(devs) < expect_count:
        raise SystemExit(f"[device] FAILED: need {expect_count} GPUs, "
                         f"have {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("device", f"jax platform={devs[0].platform} "
                  f"kind={devs[0].device_kind} count={len(devs)}")
    for line in smi.stdout.strip().splitlines():
        log("device", f"nvidia-smi: {line.strip()}")
    return devs


def _point(n: int, seed: int = 0):
    """A realistic LP point: x in [0,1], X near xx' clipped to the box."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.random(n)
    X = np.clip(np.outer(x, x) + 0.2 * rng.standard_normal((n, n)), 0, 1)
    X = 0.5 * (X + X.T)
    return jnp.asarray(x, jnp.float32), jnp.asarray(X, jnp.float32)


def phase_scoring(n: int = 125):
    import jax
    import jax.numpy as jnp

    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.instances import load_or_generate
    from sdpcutsel_tpu.models.features import candidate_q_features
    from sdpcutsel_tpu.models.scorer import generic_scores, load_params

    inst = load_or_generate(f"spar{n:03d}-100-1",
                            data_dir=os.path.join(HERE, "data", "boxqp"))
    Q = jnp.asarray(inst.Q, jnp.float32)
    params, found = load_params(3)
    check(found, "scoring", "shipped k=3 scorer weights loaded")
    x, X = _point(n)
    table = jnp.asarray(combinations_table(n, 3))
    triQ, scale = candidate_q_features(Q, table)
    T = int(table.shape[0])
    log("scoring", f"n={n}: {T} candidates")

    generic = jax.jit(lambda x, X, p: generic_scores(
        x, X, table, triQ, scale, p, sweeps=5))
    compiled = generic.lower(x, X, params).compile()
    log("scoring", f"generic scorer memory_analysis: "
                   f"{compiled.memory_analysis()}")
    nn_g, feas_g = (np.asarray(a) for a in compiled(x, X, params))
    with jax.default_device(jax.devices("cpu")[0]):
        nn_c, feas_c = (np.asarray(a) for a in generic_scores(
            x, X, table, triQ, scale, params, sweeps=5))
    scale_nn = max(np.abs(nn_c).max(), 1e-30)
    err_n = float(np.abs(nn_g - nn_c).max() / scale_nn)
    err_f = float(np.abs(feas_g - feas_c).max())
    check(err_n <= 1e-5, "scoring",
          f"GPU nn vs the CPU device: max err {err_n:.2e} of max|nn| <= "
          "1e-5 (MLP at Precision.HIGHEST: full f32, no TF32)")
    check(err_f <= 1e-5, "scoring",
          f"GPU lambda_min vs the CPU device: max abs err {err_f:.2e} <= "
          "1e-5 (f32 elementwise Jacobi)")

    outputs = {"neural(nn)": lambda o: o[0], "feasibility(feas)":
               lambda o: o[1], "combined(nn+feas)": lambda o: o}
    for out_name, pick in outputs.items():
        g = jax.jit(lambda x, X, p, pick=pick: pick(generic(x, X, p)))
        t = median_time(g, x, X, params, repeats=20)
        log("scoring", f"time {out_name:18s} {t * 1e3:8.3f} ms  "
                       f"({T / t / 1e6:8.1f}M candidates/s)")

    # the PDHG iteration and QCQP scoring (plain XLA)
    from sdpcutsel_tpu.lp.pdhg import estimate_norm, init_state, pdhg_run_fixed
    from sdpcutsel_tpu.relax.cutbuffer import append_cuts, empty_pool
    from sdpcutsel_tpu.relax.denserows import empty_dense

    M, m = 1024, 400
    rng = np.random.default_rng(1)
    quad = rng.standard_normal((m, 3, 3))
    pool = append_cuts(
        empty_pool(M, 3),
        jnp.asarray(np.sort(rng.choice(n, (m, 3)), axis=1), jnp.int32),
        jnp.asarray(rng.standard_normal((m, 3)) * 0.3, jnp.float32),
        jnp.asarray(0.5 * (quad + quad.transpose(0, 2, 1)) * 0.3,
                    jnp.float32),
        jnp.asarray(-rng.random(m) * 0.1, jnp.float32), jnp.ones((m,)))
    cx, cX = -jnp.asarray(inst.c, jnp.float32), -0.5 * Q
    st = init_state(n, M)
    dense = empty_dense(n)
    normK = estimate_norm(pool, n, 30, jnp.float32)
    iters = 1000
    t = median_time(lambda s: pdhg_run_fixed(cx, cX, pool, dense, s, normK,
                                             1.0, 0.95, iters=iters),
                    st, repeats=5)
    log("scoring", f"time pdhg iteration (plain XLA, n={n}, M={M}, "
                   f"{m} active cuts): {t / iters * 1e6:.2f} us/iteration")

    from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp
    from sdpcutsel_tpu.qcqp.chordal import (
        chordal_decomposition, clique_candidates,
    )

    qi = load_or_generate_qcqp("qcqpband050-4-13-1")
    cliques, _ = chordal_decomposition(qi.n, qi.sparsity_graph())
    qtable = jnp.asarray(clique_candidates(cliques, 4))
    p4, found4 = load_params(4)
    check(found4, "scoring", "shipped k=4 scorer weights loaded")
    qtriQ, qscale = candidate_q_features(jnp.asarray(qi.Q0, jnp.float32),
                                         qtable)
    qx, qX = _point(qi.n, 2)
    t = median_time(jax.jit(lambda x, X, p: generic_scores(
        x, X, qtable, qtriQ, qscale, p)), qx, qX, p4, repeats=20)
    log("scoring", f"time qcqp scoring (plain XLA, n={qi.n}, k=4, "
                   f"{qtable.shape[0]} clique candidates): "
                   f"{t * 1e3:.3f} ms")


def _suite_cfg(use_scan: bool):
    from sdpcutsel_tpu.config import (
        CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig,
    )

    return RunConfig(
        lp=LPConfig(max_iters=20000, tol=2e-6),
        cuts=CutConfig(k=3, sel_size=20, capacity=1024),
        scorer=ScorerConfig(strategy="neural"),
        loop=LoopConfig(use_scan=use_scan, polish_iters=0),
    )


def phase_main(name: str = "spar125-100-1", scan_rounds: int = 10,
               step_rounds: int = 3):
    import jax

    from sdpcutsel_tpu.instances import load_or_generate
    from sdpcutsel_tpu.loop import CutSolver

    data_dir = os.path.join(HERE, "data", "boxqp")
    with open(os.path.join(data_dir, "bounds.json")) as f:
        reg = json.load(f)[name]
    mc, sdp, lo = reg["mccormick"], reg["sdp"], reg["sdp_lower"]
    inst = load_or_generate(name, data_dir=data_dir)
    solver = CutSolver(inst, _suite_cfg(use_scan=True))
    t0 = time.perf_counter()
    solver.run_scan(scan_rounds)
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(step_rounds):
        solver.do_round()
    t_step = time.perf_counter() - t0
    hist = solver.history
    for h in hist:
        gap = (mc - h.bound) / (mc - sdp)
        log("main", f"round {h.round:2d} bound {h.bound:.6f} gap_closed "
                    f"{gap:.6f} lp_iters {h.lp_iters} cuts_added "
                    f"{h.cuts_added} active {h.cuts_active} "
                    f"wall {h.wall_time_s:.4f}s")
    log("main", f"wall: {scan_rounds}-round scan {t_scan:.3f}s incl. "
                f"compile and f64 certification; {step_rounds} per-round "
                f"rounds {t_step:.3f}s incl. compile")
    stats = jax.devices()[0].memory_stats() or {}
    log("main", f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    b = np.array([h.bound for h in hist])
    check(len(hist) == scan_rounds + step_rounds and np.isfinite(b).all(),
          "main", f"{len(hist)} f64-certified bounds (lp/pdhg.dual_bound_f64"
                  ", valid for any duals), all finite")
    check((np.diff(b) <= 0).all(), "main", "bounds monotone non-increasing")
    # an inexact PDHG solve certifies a hair above the LP optimum: round 0
    # (no cuts) may sit above McCormick by the LP tolerance
    check((b <= mc + 1e-4 * abs(mc)).all(), "main",
          f"bounds <= McCormick {mc:.4f} (+1e-4 rel)")
    check((b >= lo).all(), "main",
          f"bounds >= registry certified SDP lower end {lo:.4f}")
    check(sum(h.cuts_added for h in hist) > 0, "main", "cuts_added > 0")


def phase_backends(name: str = "spar030-100-1", rounds: int = 5):
    import jax

    from sdpcutsel_tpu.instances import load_or_generate
    from sdpcutsel_tpu.loop import CutSolver

    inst = load_or_generate(name, data_dir=os.path.join(HERE, "data",
                                                        "boxqp"))
    out = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            s = CutSolver(inst, _suite_cfg(use_scan=True))
            t0 = time.perf_counter()
            s.run(rounds)
            dt = time.perf_counter() - t0
        out[dev.platform] = np.array([h.bound for h in s.history])
        log("backends", f"{dev.platform} ({dev.device_kind}): bounds "
                        f"{np.round(out[dev.platform], 6).tolist()} "
                        f"({dt:.2f}s incl. compile)")
    g, c = out["gpu"], out["cpu"]
    r0 = abs(g[0] - c[0]) / abs(c[0])
    check(r0 <= 1e-5, "backends",
          f"round-0 bound agrees: rel diff {r0:.2e} <= 1e-5")
    rf = abs(g[-1] - c[-1]) / (1 + abs(c[-1]))
    check(rf < 0.02, "backends",
          f"final bound agrees within the tie-order tolerance: rel diff "
          f"{rf:.2e} < 0.02")


def phase_qcqp(name: str = "qcqpband050-4-13-1", rounds: int = 4):
    from sdpcutsel_tpu.config import (
        CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp
    from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP

    inst = load_or_generate_qcqp(name)
    cfg = RunConfig(
        lp=LPConfig(max_iters=20000, tol=2e-6),
        cuts=CutConfig(k=4, sel_size=16, capacity=1024),
        scorer=ScorerConfig(strategy="neural"),
        loop=LoopConfig(use_scan=True),
    )
    t0 = time.perf_counter()
    hist = CutSolverQCQP(inst, cfg).run(rounds)
    dt = time.perf_counter() - t0
    b = np.array([h.bound for h in hist])
    log("qcqp", f"{name} (n={inst.n}, m={inst.m}, k=4): bounds "
                f"{np.round(b, 6).tolist()} cuts_added "
                f"{[h.cuts_added for h in hist]} ({dt:.2f}s incl. compile)")
    check(np.isfinite(b).all() and (np.diff(b) <= 0).all(), "qcqp",
          "f64-certified bounds finite and monotone")


def phase_batched(n: int = 30, batch: int = 8, rounds: int = 10,
                  lp_iters: int = 400, sel_size: int = 16):
    import jax
    import jax.numpy as jnp

    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.parallel.mesh import make_mesh
    from sdpcutsel_tpu.parallel.round import (
        certify_scan_f64, init_batched_state, make_sharded_scan_step,
        shard_batched_state,
    )
    from sdpcutsel_tpu.parallel.sharding import shard_candidates

    mesh = make_mesh(data=1, cand=1)
    insts = [generate_spar(n, 100, s + 1) for s in range(batch)]
    Qb = jnp.asarray(np.stack([i.Q for i in insts]), jnp.float32)
    cb = jnp.asarray(np.stack([i.c for i in insts]), jnp.float32)
    state = shard_batched_state(
        init_batched_state(Qb, cb, capacity=1024, kmax=3), mesh)
    table, valid = shard_candidates(combinations_table(n, 3), mesh)
    scan = make_sharded_scan_step(mesh, rounds=rounds, lp_iters=lp_iters,
                                  sel_size=sel_size, strategy="neural")
    t0 = time.perf_counter()
    st, outs = scan(state, table, valid)
    jax.block_until_ready(st)
    dt = time.perf_counter() - t0
    cert = certify_scan_f64(st.Q, st.c, outs)
    log("batched", f"{batch} x n={n}, {rounds} rounds: final certified "
                   f"{np.round(cert[-1], 4).tolist()} ({dt:.2f}s incl. "
                   "compile)")
    check(cert.shape == (rounds, batch) and np.isfinite(cert).all(),
          "batched", "certify_scan_f64 finite for every (round, instance)")
    check((np.diff(cert, axis=0) <= 0).all(), "batched",
          "certified bounds monotone over the rounds")


def phase_four_cards(n: int = 125, qcqp_n: int = 125, batch: int = 4):
    import jax

    from __graft_entry__ import (
        MESH_ATOL, MESH_RTOL, boxqp_scan_bounds, mesh_delta,
        qcqp_scan_bounds,
    )
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.instances.qcqp import generate_qcqp_band
    from sdpcutsel_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    meshes = {"1x1": make_mesh(1, 1, devs[:1]),
              "2x2": make_mesh(2, 2, devs[:4]),
              "4x1": make_mesh(4, 1, devs[:4])}
    insts = [generate_spar(n, 100, s + 1) for s in range(batch)]
    # band instances share their band, so one clique table (from the full
    # band graph) is valid for every instance of the batch
    bw = 4
    fam = [generate_qcqp_band(qcqp_n, bw, 13, s + 1) for s in range(batch)]
    band = [(i, j) for i in range(qcqp_n)
            for j in range(i + 1, min(i + bw + 1, qcqp_n))]
    kw = dict(rounds=2, lp_iters=500, sel_size=8, capacity=64)
    deltas = []
    for label, fn in (
            ("boxqp", lambda mesh: boxqp_scan_bounds(mesh, insts, **kw)),
            ("qcqp", lambda mesh: qcqp_scan_bounds(mesh, fam, graph=band,
                                                   **kw))):
        res = {}
        for name, mesh in meshes.items():
            t0 = time.perf_counter()
            res[name] = fn(mesh)
            log("four", f"{label} mesh {name}: certified "
                        f"{np.round(res[name].bounds, 6).tolist()} pool "
                        f"sizes {res[name].count.tolist()} "
                        f"({time.perf_counter() - t0:.2f}s incl. compile)")
        ref = res["1x1"]
        for name in ("2x2", "4x1"):
            d = mesh_delta(res[name], ref)
            per_round = np.abs(res[name].bounds - ref.bounds).max(axis=1)
            log("four", f"{label} mesh {name} vs one card: same cuts "
                        f"{d['same_cuts']}, max |delta| {d['abs']:.3e} "
                        f"(relative {d['rel']:.3e}), per round "
                        f"{[f'{v:.3e}' for v in per_round]}")
            deltas.append((label, name, d))
    # every comparison is printed before the first failure stops the run
    for label, name, d in deltas:
        check(d["ok"], "four",
              f"{label} mesh {name} appends the same cuts as one card in "
              f"every round and its bounds agree within {MESH_ATOL:g} + "
              f"{MESH_RTOL:g} x |bound| (max |delta| {d['abs']:.2e})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its one-card "
                         "comparison")
    args = ap.parse_args()

    # the backends phase also needs the host CPU device
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    devs = phase_device(4 if args.four_cards else 1)
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    log("device", f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for phase in (phase_scoring, phase_main, phase_backends, phase_qcqp,
                      phase_batched):
            t = time.perf_counter()
            phase()
            log("time", f"{phase.__name__}: {time.perf_counter() - t:.1f}s")
    log("time", f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
