"""Validate the SDP-bound registry.

For each instance in data/boxqp/bounds.json (or the names given), sandwich
the SDP value and record into the registry entry:

    sdp_lower     — certified f64 lower bound: Burer-Monteiro primal ascent
                    (loop/sdp_primal.py) + interior-anchor blend repair
    sdp_rel_width — (sdp - sdp_lower) / (1 + |sdp|): certified cap on the
                    denominator error from the eigencut stall-stop
    sdp_ok        — registry value lies in [lower - tol, upper + tol]

Two-phase economics: the BM lower bound costs seconds on CPU; the in-out
eigencut UPPER bound costs minutes on the accelerator.  So the lower bound is always
recomputed, and the upper bound is re-run (with the BM point as the in-out
anchor — see sdp_relaxation_bound) only when the registry value is wider
than --rel-target above the fresh lower bound.  Both the fresh and registry
upper bounds are valid, so the min is kept.

Usage:
    python scripts/validate_sdp_bounds.py --names spar020-100-1 --cpu
    python scripts/validate_sdp_bounds.py --min-n 80 --max-n 125   # GPU
    python scripts/validate_sdp_bounds.py --lb-only --max-n 125 --cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Locked read-merge-write lives in the package now (the old
# in-script version crashed on a first-ever entry when bounds.json did not
# exist yet); re-exported here for validate_qcqp_bounds.py and older callers.
from sdpcutsel_tpu.utils.registry import update_registry  # noqa: E402,F401


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--names", default=None, help="comma list; default all")
    ap.add_argument("--min-n", type=int, default=0)
    ap.add_argument("--max-n", type=int, default=125)
    ap.add_argument("--max-rounds", type=int, default=150)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--rel-target", type=float, default=0.03,
                    help="skip the ub re-run when registry width <= this")
    ap.add_argument("--lb-only", action="store_true",
                    help="only refresh the BM lower bound (CPU-cheap)")
    ap.add_argument("--stall-tol", type=float, default=1e-5,
                    help="in-out eigencut stall tolerance (loosen for long "
                         "deep reruns on a single stubborn instance)")
    ap.add_argument("--stall-rounds", type=int, default=15)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from sdpcutsel_tpu.config import LPConfig
    from sdpcutsel_tpu.instances import load_or_generate
    from sdpcutsel_tpu.loop.sdp_bound import (
        bm_null_directions, sdp_relaxation_bound,
    )
    from sdpcutsel_tpu.loop.sdp_primal import bm_feasible_point

    reg_path = os.path.join(args.data_dir, "bounds.json")
    with open(reg_path) as f:
        reg = json.load(f)
    names = (args.names.split(",") if args.names else sorted(reg))
    lp = LPConfig(max_iters=args.lp_max_iters, tol=2e-6)

    for name in names:
        if name not in reg:
            print(f"[validate] {name}: not in registry, skipping", flush=True)
            continue
        n = int(name[4:7])
        if not (args.min_n <= n <= args.max_n):
            continue
        inst = load_or_generate(name, data_dir=args.data_dir)
        rec = reg[name]
        t0 = time.time()

        # --- phase A: tight certified lower bound (BM + blend repair) ---
        x_in, X_in, lb = bm_feasible_point(inst.Q, inst.c)
        lb = max(lb, rec.get("sdp_lower", -float("inf")))
        sdp = rec["sdp"]
        tol = 1e-3 * (1 + abs(sdp))
        rel = (sdp - lb) / (1.0 + abs(sdp))
        fresh = {"sdp_lower": lb, "sdp_rel_width": rel,
                 "sdp_ok": bool(lb - tol <= sdp)}
        did_ub = False

        # --- phase B: in-out eigencut upper bound, only where needed ---
        # (round-5 accelerated settings: BM null-space seeding, 48 cut
        # directions per round, 2048-row buffer, host mirror, early exit at
        # the width target — see validate_sdp_bound)
        if not args.lb_only and (rel > args.rel_target or sdp < lb - tol):
            # rel=(ub-lb)/(1+ub) <= target  <=>  ub <= (lb+target)/(1-target)
            stop_ub = (lb + args.rel_target) / (1.0 - args.rel_target)
            ub, _, hist = sdp_relaxation_bound(
                inst, lp, max_rounds=args.max_rounds, anchor=(x_in, X_in),
                max_cuts_per_round=48, capacity=2048, purge_at=1500,
                stall_tol=args.stall_tol, stall_rounds=args.stall_rounds,
                seed_dirs=bm_null_directions(x_in, X_in),
                final_polish=True, stop_below=stop_ub)
            did_ub = True
            if sdp < lb - tol:
                # registry value provably NOT a valid SDP upper bound (below
                # the certified feasible value): replace with the fresh one
                fresh["sdp_prev_stale"] = sdp
                sdp = ub
            elif ub < sdp:
                # both valid upper bounds -> keep the tighter
                fresh["sdp_prev_stale"] = sdp
                sdp = min(sdp, ub)
            fresh["sdp"] = sdp
            fresh["sdp_rel_width"] = rel = (sdp - lb) / (1.0 + abs(sdp))
            fresh["sdp_ok"] = bool(lb - tol <= sdp)

        print(f"[validate] {name}: sdp={sdp:.4f} lb={lb:.4f} "
              f"rel_width={rel:.4f} ok={fresh['sdp_ok']}"
              + (" UB-RERUN" if did_ub else "")
              + (" TIGHTENED" if "sdp_prev_stale" in fresh else "")
              + f" ({time.time()-t0:.0f}s)", flush=True)
        reg = update_registry(reg_path, name, fresh)
    print("[validate] done", flush=True)


if __name__ == "__main__":
    main()
