"""Incremental QCQP suite runner (resumable) — sparse-QCQP counterpart of
run_suite_incremental.py (SURVEY.md section 0.7 / 3.4).

Cells are (instance, strategy, k); done cells are skipped on re-invocation.
SDP reference bounds (with the quadratic-constraint rows in the relaxation)
are cached per instance in data/qcqp/bounds.json.

    python scripts/run_qcqp_suite.py --specs 015-30-3-1,020-25-4-1 \
        --ks 4,5 --strategies neural,feasibility --rounds 8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--specs", default="015-30-3-1,020-25-4-1,025-20-4-1",
                    help="comma list of n-density-m-seed")
    ap.add_argument("--ks", default="4,5")
    ap.add_argument("--strategies", default="neural,feasibility,random")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--sel-size", type=int, default=16)
    ap.add_argument("--data-dir", default="data/qcqp")
    ap.add_argument("--out", default="results/qcqp.jsonl")
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000)
    ap.add_argument("--sdp-max-rounds", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache


    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    from sdpcutsel_tpu.config import (
        CutConfig, LPConfig, LoopConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.instances.qcqp import generate_qcqp
    from sdpcutsel_tpu.loop.sdp_bound import gap_closed
    from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP
    from sdpcutsel_tpu.utils.logging import JSONLLogger
    from sdpcutsel_tpu.utils.registry import ensure_certified_bounds

    os.makedirs(args.data_dir, exist_ok=True)
    reg_path = os.path.join(args.data_dir, "bounds.json")

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["instance"], r["strategy"], r.get("k")))
                except (json.JSONDecodeError, KeyError):
                    continue

    logger = JSONLLogger(args.out)
    for spec in args.specs.split(","):
        if spec.startswith("qcqp"):
            # full instance name (incl. band-structured qcqpbandNNN-B-M-S)
            from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp

            inst = load_or_generate_qcqp(spec)
        else:
            n, d, m, seed = (int(v) for v in spec.split("-"))
            inst = generate_qcqp(n, d, m, seed)
        # Registry miss -> certified sandwich with the validated settings,
        # persisted with sdp_rel_width (the old fallback ran a
        # loose, never-saved eigencut stall that inflated gap-closed).
        mc, sdp = ensure_certified_bounds(
            inst, reg_path, None, max_rounds=args.sdp_max_rounds)
        for k in (int(v) for v in args.ks.split(",")):
            for strat in args.strategies.split(","):
                if (inst.name, strat, k) in done:
                    continue
                cfg = RunConfig(
                    lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
                    cuts=CutConfig(k=k, sel_size=args.sel_size, capacity=1024),
                    scorer=ScorerConfig(strategy=strat),
                    loop=LoopConfig(polish_iters=args.polish_iters),
                )
                t0 = time.perf_counter()
                hist = CutSolverQCQP(inst, cfg).run(rounds=args.rounds)
                gaps = gap_closed(mc, sdp, [h.bound for h in hist])
                rec = {
                    "instance": inst.name, "strategy": strat, "k": k,
                    "sel_size": args.sel_size,
                    "mccormick": mc, "sdp": sdp,
                    "bounds": [h.bound for h in hist],
                    "gap_closed": gaps.tolist(),
                    "final_gap_closed": float(gaps[-1]) if len(gaps) else 0.0,
                    "cuts_total": hist[-1].cuts_active if hist else 0,
                    "wall_time_s": time.perf_counter() - t0,
                    "ts": time.time(),
                }
                logger.log(rec)
                print(f"[qcqp] {inst.name} k={k} {strat}: "
                      f"{rec['final_gap_closed']:.3f} "
                      f"t={rec['wall_time_s']:.1f}s", flush=True)
    logger.close()
    print("[qcqp] all cells complete", flush=True)


if __name__ == "__main__":
    main()
