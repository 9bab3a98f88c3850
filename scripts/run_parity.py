"""Measure parity: CPU reference replica vs the JAX build's recorded suite
cells, same instance / strategy / cut budget (SURVEY.md section 6 — the
measured baseline replaces the reference's unavailable published numbers).

For each requested instance, runs the numpy+HiGHS replica
(baseline/cpu_reference.py) with the same (k, sel_size, rounds) as the suite
sweep, converts its bound sequence to % SDP gap closed using the shared
bounds registry, and appends a record to results/parity.jsonl with the
matching JAX cell's number and the JAX/CPU ratio.

    JAX_PLATFORMS=cpu \
        python scripts/run_parity.py --instances spar020-50-1,spar030-100-1
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", required=True, help="comma list")
    ap.add_argument("--strategy", default="feasibility",
                    help="replica strategy to compare (feasibility is "
                         "deterministic — identical selection rule on both "
                         "sides)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sel-size", type=int, default=20)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--suite", default="results/suite.jsonl")
    ap.add_argument("--out", default="results/parity.jsonl")
    ap.add_argument("--jax-rerun", action="store_true",
                    help="re-run the JAX build fresh (same budget) with a "
                         "final polish re-solve instead of looking up "
                         "pre-polish suite cells; runs on the default "
                         "backend (the GPU when available)")
    ap.add_argument("--polish-iters", type=int, default=60_000,
                    help="final-polish LP iteration budget for --jax-rerun")
    ap.add_argument("--diversity-alpha", type=float, default=0.0,
                    help="support-diverse selection penalty for --jax-rerun "
                         "(ops/topk.py diverse_topk; fixes top_k tie "
                         "clustering on tie-heavy strategies)")
    ap.add_argument("--replica-diversity-alpha", type=float, default=0.0,
                    help="give the REPLICA the same support-diverse "
                         "tie-breaking as the JAX side (baseline/"
                         "cpu_reference._diverse_select) — produces a "
                         "like-for-like feasibility row instead of counting "
                         "tie-clustering divergence")
    ap.add_argument("--jax-from-parity", action="store_true",
                    help="instead of re-running the JAX side, pair the fresh "
                         "replica run with the LATEST recorded rerun row in "
                         "--out matching (instance, strategy, k, rounds, "
                         "sel_size, diversity, purge) — the recorded number "
                         "is a live JAX result; only the replica changes "
                         "(used for the +replica-diverse rows)")
    ap.add_argument("--no-purge", action="store_true",
                    help="disable slack-cut purging in the --jax-rerun solve "
                         "(matches the replica, which never purges)")
    ap.add_argument("--redo", action="store_true",
                    help="re-run cells already in the output (use after a "
                         "suite refill so suite-cell rows pick up the "
                         "refreshed JAX cells)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend even for --jax-rerun (same "
                         "solver code path on the CPU backend; lets parity "
                         "cells run while another process holds the GPU)")
    args = ap.parse_args()

    import jax

    if args.cpu or not args.jax_rerun:
        # replica-only run (or forced): keep the GPU free for other processes
        jax.config.update("jax_platforms", "cpu")
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from sdpcutsel_tpu.baseline import cpu_cut_select
    from sdpcutsel_tpu.bench.suite import bounds_registry
    from sdpcutsel_tpu.instances import load_or_generate

    reg = bounds_registry(os.path.join(args.data_dir, "bounds.json"))

    jax_cells = {}
    if os.path.exists(args.suite):
        with open(args.suite) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("strategy") == args.strategy and "instance" in r:
                    # only accept cells whose recorded config matches the
                    # replica's run parameters — otherwise the ratio compares
                    # different budgets (k/sel_size default to match for
                    # legacy records that predate config logging)
                    if (r.get("k", args.k) == args.k
                            and r.get("sel_size", args.sel_size)
                            == args.sel_size):
                        jax_cells[r["instance"]] = r

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["instance"], r["strategy"],
                              r.get("k", 3),
                              bool(r.get("jax_rerun", False)),
                              float(r.get("jax_diversity_alpha", 0.0)),
                              float(r.get("cpu_diversity_alpha", 0.0))))
                except (json.JSONDecodeError, KeyError):
                    continue

    for name in args.instances.split(","):
        if (name, args.strategy, args.k, args.jax_rerun,
                args.diversity_alpha if args.jax_rerun else 0.0,
                args.replica_diversity_alpha) in done \
                and not args.redo:
            print(f"[parity] {name}: already done", flush=True)
            continue
        if name not in reg:
            print(f"[parity] {name}: no SDP bound in registry, skipping",
                  flush=True)
            continue
        inst = load_or_generate(name, data_dir=args.data_dir)
        mc, sdp = reg[name]["mccormick"], reg[name]["sdp"]

        jax_rec = None
        jax_src = None
        if args.jax_from_parity:
            if os.path.exists(args.out):
                with open(args.out) as f:
                    for line in f:
                        try:
                            r = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if (r.get("instance") == name
                                and r.get("strategy") == args.strategy
                                and r.get("k", 3) == args.k
                                and r.get("rounds") == args.rounds
                                and r.get("sel_size") == args.sel_size
                                and r.get("jax_rerun")
                                and float(r.get("jax_diversity_alpha", 0.0))
                                == args.diversity_alpha
                                and r.get("jax_purge", True)
                                == (not args.no_purge)
                                and r.get("jax_final_gap_closed")
                                is not None):
                            jax_src = r            # last matching row wins
            if jax_src is None:
                print(f"[parity] {name}: no recorded JAX rerun row to pair "
                      "with, skipping", flush=True)
                continue
        elif args.jax_rerun:
            import dataclasses

            from sdpcutsel_tpu.bench.suite import instance_gap_closed
            from sdpcutsel_tpu.config import (
                CutConfig, LoopConfig, RunConfig, ScorerConfig,
            )

            cfg = RunConfig(
                cuts=CutConfig(k=args.k, sel_size=args.sel_size,
                               purge=not args.no_purge,
                               diversity_alpha=args.diversity_alpha),
                scorer=ScorerConfig(strategy=args.strategy),
                loop=LoopConfig(rounds=args.rounds,
                                polish_iters=args.polish_iters),
            )
            jax_rec = instance_gap_closed(name, cfg, args.data_dir,
                                          rounds=args.rounds)
            print(f"[parity] {name}: jax rerun gap_closed="
                  f"{jax_rec['final_gap_closed']:.3f} "
                  f"t={jax_rec['wall_time_s']:.0f}s", flush=True)
        replica_strategy, score_fn = args.strategy, None
        if args.strategy == "neural":
            # replica runs the reference loop with the SAME trained net via
            # its custom-score hook — isolates LP/loop differences under the
            # headline selection rule
            import jax as _jax
            import jax.numpy as jnp
            import numpy as np

            from sdpcutsel_tpu.config import ScorerConfig
            from sdpcutsel_tpu.cuts.enumerate import combinations_table
            from sdpcutsel_tpu.models.scorer import neural_score_fn

            table = jnp.asarray(combinations_table(inst.n, args.k))
            fn = neural_score_fn(jnp.asarray(inst.Q, jnp.float32), table,
                                 ScorerConfig())
            key = _jax.random.PRNGKey(0)

            def score_fn(x, X, tbl, _fn=fn, _key=key):
                return np.asarray(_fn(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(X, jnp.float32), _key))

            replica_strategy = "custom"
        elif args.strategy == "optimality":
            # replica selects by the SAME exact small-SDP oracle scores via
            # the custom hook (then emits eigencuts, like the JAX strategy)
            import jax as _jax
            import jax.numpy as jnp
            import numpy as np

            from sdpcutsel_tpu.cuts.enumerate import combinations_table
            from sdpcutsel_tpu.models.labels import exact_score_fn

            table = jnp.asarray(combinations_table(inst.n, args.k))
            fn = exact_score_fn(jnp.asarray(inst.Q, jnp.float32), table)
            key = _jax.random.PRNGKey(0)

            def score_fn(x, X, tbl, _fn=fn, _key=key):
                return np.asarray(_fn(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(X, jnp.float32), _key))

            replica_strategy = "custom"
        t0 = time.perf_counter()
        hist, _ = cpu_cut_select(
            inst, k=args.k, sel_size=args.sel_size, rounds=args.rounds,
            strategy=replica_strategy, score_fn=score_fn,
            diversity_alpha=args.replica_diversity_alpha,
        )
        wall = time.perf_counter() - t0
        from sdpcutsel_tpu.loop.sdp_bound import gap_closed

        # same normalization (incl. denominator guard and [0,1] clip) as the
        # JAX suite's records
        cpu_gaps = gap_closed(mc, sdp, [h.bound for h in hist]).tolist()
        cpu_final = cpu_gaps[-1] if cpu_gaps else 0.0
        if jax_rec is not None:
            jax_final = jax_rec["final_gap_closed"]
        elif jax_src is not None:
            jax_final = jax_src["jax_final_gap_closed"]
        else:
            jax_final = jax_cells.get(name, {}).get("final_gap_closed")
        rec = {
            "instance": name,
            "strategy": args.strategy,
            "k": args.k,
            "rounds": args.rounds,
            "sel_size": args.sel_size,
            "cpu_final_gap_closed": cpu_final,
            "cpu_gap_closed": cpu_gaps,
            "jax_final_gap_closed": jax_final,
            "ratio_jax_over_cpu": (
                jax_final / cpu_final
                if jax_final is not None and cpu_final > 0 else None
            ),
            "cpu_wall_time_s": wall,
            "cpu_diversity_alpha": args.replica_diversity_alpha,
            "ts": time.time(),
        }
        if jax_rec is not None:
            import jax as _jaxb

            rec.update({
                "jax_rerun": True,
                "jax_backend": _jaxb.default_backend(),
                "jax_diversity_alpha": args.diversity_alpha,
                "jax_polish_iters": args.polish_iters,
                "jax_purge": not args.no_purge,
                "jax_gap_closed": jax_rec["gap_closed"],
                "jax_wall_time_s": jax_rec["wall_time_s"],
            })
        elif jax_src is not None:
            rec.update({
                "jax_rerun": True,
                "jax_from_recorded_row": True,
                "jax_backend": jax_src.get("jax_backend"),
                "jax_diversity_alpha": args.diversity_alpha,
                "jax_polish_iters": jax_src.get("jax_polish_iters"),
                "jax_purge": not args.no_purge,
                "jax_gap_closed": jax_src.get("jax_gap_closed"),
            })
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[parity] {name}: cpu={cpu_final:.3f} jax={jax_final} "
              f"t={wall:.0f}s", flush=True)


if __name__ == "__main__":
    main()
