"""Anchor gap-closed-vs-WALL-CLOCK at large n (SURVEY.md §0.5 second axis).

The suite records the JAX build's per-round wall times (suite.jsonl
round_times_s); this gives the CPU replica's per-round cost at n >= 100 — the
reference stack's own timing — so gap-vs-time can be compared, not just
gap-vs-rounds.  This runs the replica (numpy batched LAPACK scoring
+ HiGHS re-solves, baseline/cpu_reference.py) for a few rounds at large n,
records per-round score/LP seconds, and extrapolates rounds/s.

    JAX_PLATFORMS=cpu \
        python scripts/bench_gap_vs_time.py --instances spar100-50-1 --rounds 3

Appends one JSON line per (instance, strategy) to results/replica_timing.jsonl.
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
    ap.add_argument("--strategy", default="feasibility")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sel-size", type=int, default=40)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--out", default="results/replica_timing.jsonl")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from sdpcutsel_tpu.baseline import cpu_cut_select
    from sdpcutsel_tpu.instances import load_or_generate

    for name in args.instances.split(","):
        inst = load_or_generate(name, data_dir=args.data_dir)
        t0 = time.perf_counter()
        hist, cands_per_s = cpu_cut_select(
            inst, k=args.k, sel_size=args.sel_size, rounds=args.rounds,
            strategy=args.strategy,
        )
        wall = time.perf_counter() - t0
        rec = {
            "instance": name,
            "n": inst.n,
            "strategy": args.strategy,
            "k": args.k,
            "sel_size": args.sel_size,
            "rounds_run": len(hist),
            "bounds": [h.bound for h in hist],
            "score_time_s": [h.score_time_s for h in hist],
            "lp_time_s": [h.lp_time_s for h in hist],
            "wall_time_s": wall,
            "rounds_per_s": len(hist) / wall if wall > 0 else None,
            "replica_cands_per_s": cands_per_s,
            "ts": time.time(),
        }
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[timing] {name} {args.strategy}: {len(hist)} rounds in "
              f"{wall:.1f}s = {len(hist)/wall:.4f} rounds/s", flush=True)


if __name__ == "__main__":
    main()
