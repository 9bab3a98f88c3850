"""Re-run one (instance, strategy) suite cell and append a fresh record —
even if a (possibly older, times-less) record already exists.  Used to
refresh large-n cells with per-round wall times for the gap-vs-time overlay
figures (summaries take the LAST record per (instance, strategy, k)).

    python scripts/rerun_cell.py spar125-100-1 neural --rounds 10 --sel-size 50
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("instance")
    ap.add_argument("strategy")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sel-size", type=int, default=50)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000)
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--out", default="results/suite.jsonl")
    ap.add_argument("--use-scan", action="store_true",
                    help="all rounds in one jit dispatch (LoopConfig.use_scan)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from sdpcutsel_tpu.bench.suite import instance_gap_closed
    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.utils.logging import JSONLLogger

    cfg = RunConfig(
        lp=LPConfig(max_iters=args.lp_max_iters),
        cuts=CutConfig(k=args.k, sel_size=args.sel_size),
        scorer=ScorerConfig(strategy=args.strategy),
        loop=LoopConfig(rounds=args.rounds, polish_iters=args.polish_iters,
                        use_scan=args.use_scan),
    )
    rec = instance_gap_closed(args.instance, cfg, args.data_dir,
                              rounds=args.rounds,
                              logger=JSONLLogger(args.out))
    print(f"[rerun] {args.instance} {args.strategy}: "
          f"final_gap_closed={rec['final_gap_closed']:.3f} "
          f"t={rec['wall_time_s']:.0f}s "
          f"rounds/s={rec['rounds_run']/sum(rec['round_times_s']):.3f}")


if __name__ == "__main__":
    main()
