"""Incremental BoxQP suite runner (resumable).

Runs (instance x strategy) cells of the benchmark grid, skipping cells
already present in the results JSONL — so repeated invocations (e.g. under a
watchdog or a short shell timeout) make monotonic progress.  SDP reference
bounds are computed once per instance and cached in the data-dir registry.

Usage:
    python scripts/run_suite_incremental.py \
        --sizes 20,30,40,50 --densities 50,100 --seeds 1 \
        --strategies neural,feasibility,random --rounds 10 \
        --out results/suite.jsonl
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="20,30,40,50")
    ap.add_argument("--densities", default="50,100")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--strategies", default="neural,feasibility,random")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--sel-size", type=int, default=20)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--out", default="results/suite.jsonl")
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000,
                    help="final tighter LP re-solve budget (0 = off)")
    ap.add_argument("--sdp-max-rounds", type=int, default=60)
    ap.add_argument("--use-scan", action="store_true",
                    help="run all rounds in one jit dispatch "
                         "(LoopConfig.use_scan; no per-round early stop)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--redo", action="store_true",
                    help="re-run cells even if already present (appended "
                         "rows win in summarize_suite's last-row-per-cell "
                         "ingestion — used for config-default refills)")
    ap.add_argument("--max-cells", type=int, default=0,
                    help="stop after N new cells (0 = unlimited); lets runs "
                         "exit cleanly inside an external time budget instead "
                         "of being killed mid-dispatch")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache


    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    from sdpcutsel_tpu.bench.suite import instance_gap_closed
    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.utils.logging import JSONLLogger

    names = [
        f"spar{n:03d}-{d}-{s}"
        for n in (int(v) for v in args.sizes.split(","))
        for d in (int(v) for v in args.densities.split(","))
        for s in (int(v) for v in args.seeds.split(","))
    ]
    strategies = args.strategies.split(",")

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "instance" in r:
                    done.add((r["instance"], r["strategy"], r.get("k", 3)))

    logger = JSONLLogger(args.out)
    completed = 0
    for name in names:
        for strat in strategies:
            if (name, strat, args.k) in done and not args.redo:
                continue
            if args.max_cells and completed >= args.max_cells:
                print(f"[suite] cell budget reached ({completed})", flush=True)
                logger.close()
                return
            cfg = RunConfig(
                lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
                cuts=CutConfig(k=args.k, sel_size=args.sel_size, capacity=1024),
                scorer=ScorerConfig(strategy=strat),
                loop=LoopConfig(polish_iters=args.polish_iters,
                                use_scan=args.use_scan),
            )
            rec = instance_gap_closed(
                name, cfg, args.data_dir, rounds=args.rounds, logger=logger,
                sdp_max_rounds=args.sdp_max_rounds,
            )
            completed += 1
            print(f"[suite] {name} {strat}: "
                  f"final_gap_closed={rec['final_gap_closed']:.3f} "
                  f"t={rec['wall_time_s']:.1f}s", flush=True)
    logger.close()
    print("[suite] all cells complete", flush=True)


if __name__ == "__main__":
    main()
