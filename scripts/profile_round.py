"""Per-stage wall-time breakdown of cutting-plane rounds at a given n.

Times, on the current backend:
  * each stage of the per-round path (norm estimate / LP solve / post-LP
    fused stage / host f64 certificate),
  * per-PDHG-iteration cost at suite capacity (fixed 1000-iteration block),
  * R rounds in per-round mode vs scan mode (LoopConfig.use_scan).

Usage: python scripts/profile_round.py [--n 125] [--rounds 10] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=125)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses

    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.loop.solver import CutSolver
    from sdpcutsel_tpu.lp.pdhg import (
        dual_bound_f64, estimate_norm, pdhg_run_fixed, solve_lp,
    )

    inst = generate_spar(args.n, 100, 1)
    cfg = RunConfig(
        lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
        cuts=CutConfig(k=3, sel_size=40, capacity=args.capacity),
        scorer=ScorerConfig(strategy="neural"),
        loop=LoopConfig(),
    )
    out = {"n": args.n, "backend": jax.default_backend(),
           "capacity": args.capacity}

    # -- stage breakdown over R per-round rounds -----------------------------
    s = CutSolver(inst, cfg)
    stage = {"norm": 0.0, "solve": 0.0, "post": 0.0, "cert": 0.0}
    # warm the compiles with one full round
    s.do_round()
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        normK = jax.block_until_ready(
            estimate_norm(s.pool, inst.n, cfg.lp.power_iters, jnp.float32))
        t1 = time.perf_counter()
        s.state, info = solve_lp(s.Q, s.c, s.pool, s.state, cfg.lp)
        jax.block_until_ready(s.state.x)
        t2 = time.perf_counter()
        s.key, sub = jax.random.split(s.key)
        if not hasattr(s, "_post_lp_jit"):
            s._post_lp_jit = jax.jit(s._post_lp)
        s.pool, yC, kept = s._post_lp_jit(
            s.state.x, s.state.X, s.pool, s.state.yC, sub, s._score_consts)
        s.state = s.state._replace(yC=yC)
        jax.block_until_ready(s.pool.count)
        t3 = time.perf_counter()
        dual_bound_f64(inst.Q, inst.c, s.pool, s.state)
        t4 = time.perf_counter()
        stage["norm"] += t1 - t0
        stage["solve"] += t2 - t1
        stage["post"] += t3 - t2
        stage["cert"] += t4 - t3
        _ = float(normK)
    out["per_round_stage_s"] = {k: round(v / args.rounds, 4)
                                for k, v in stage.items()}
    out["lp_iters_last"] = int(info["iters"])

    # -- raw PDHG iteration cost at this capacity ----------------------------
    from sdpcutsel_tpu.relax.denserows import empty_dense

    cx, cX = -s.c, -0.5 * s.Q
    normK = estimate_norm(s.pool, inst.n, 30, jnp.float32)
    blk = 1000
    st = jax.block_until_ready(
        pdhg_run_fixed(cx, cX, s.pool, empty_dense(inst.n, jnp.float32),
                       s.state, normK, 1.0, 0.95, iters=blk))
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        st = pdhg_run_fixed(cx, cX, s.pool, empty_dense(inst.n, jnp.float32),
                            st, normK, 1.0, 0.95, iters=blk)
    jax.block_until_ready(st.x)
    out["pdhg_us_per_iter"] = round(
        (time.perf_counter() - t0) / (reps * blk) * 1e6, 2)

    # -- per-round vs scan mode, fresh solvers -------------------------------
    for mode, use_scan in (("per_round", False), ("scan", True)):
        from sdpcutsel_tpu.lp.pdhg import init_state
        from sdpcutsel_tpu.relax.cutbuffer import empty_pool

        c2 = dataclasses.replace(cfg, loop=LoopConfig(use_scan=use_scan))
        sv = CutSolver(inst, c2)
        sv.run(rounds=args.rounds)  # compile warmup at the MEASURED length
        # reset solver state IN PLACE so the timed run reuses the jit caches
        sv.pool = empty_pool(c2.cuts.capacity, c2.cuts.k, jnp.float32)
        sv.state = init_state(inst.n, c2.cuts.capacity, 0, jnp.float32)
        sv.key = jax.random.PRNGKey(c2.seed)
        sv.history = []
        t0 = time.perf_counter()
        hist = sv.run(rounds=args.rounds)
        dt = time.perf_counter() - t0
        out[f"{mode}_rounds_per_s"] = round(args.rounds / dt, 3)
        out[f"{mode}_final_bound"] = round(hist[-1].bound, 4)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
