"""Validate (and extend) the QCQP SDP-bound registry — the sparse-path
companion of validate_sdp_bounds.py (the QCQP story
needs the same gap-closed rigor as BoxQP).

For each named instance:
  * missing registry entries are CREATED: mccormick + sdp from the eigencut
    loop with the constraint rows in the relaxation (loop/sdp_bound.py);
  * the certified LOWER bound comes from the rows-aware Burer-Monteiro
    ascent (constraint rows in the augmented Lagrangian, certificate blend
    against the row-feasible 0.25-anchor);
  * when the registry value is wider than --rel-target above the fresh
    lower bound, the in-out eigencut upper bound is re-run with the BM
    point as anchor and the tighter of the two kept.

Usage:
    python scripts/validate_qcqp_bounds.py --names qcqpband050-4-13-1 --cpu
    python scripts/validate_qcqp_bounds.py   # whole registry (GPU for ub)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from validate_sdp_bounds import update_registry  # noqa: E402  (same dir)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default="data/qcqp")
    ap.add_argument("--names", default=None,
                    help="comma list; default: every registry entry")
    ap.add_argument("--max-rounds", type=int, default=100)
    ap.add_argument("--lp-max-iters", type=int, default=15000)
    ap.add_argument("--rel-target", type=float, default=0.03)
    ap.add_argument("--lb-only", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from sdpcutsel_tpu.config import LPConfig
    from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp
    from sdpcutsel_tpu.loop.sdp_bound import (
        qcqp_interior_anchor, qcqp_rows, sdp_relaxation_bound,
    )
    from sdpcutsel_tpu.loop.sdp_primal import bm_feasible_point

    os.makedirs(args.data_dir, exist_ok=True)
    reg_path = os.path.join(args.data_dir, "bounds.json")
    reg = json.load(open(reg_path)) if os.path.exists(reg_path) else {}
    names = (args.names.split(",") if args.names else sorted(reg))
    lp = LPConfig(max_iters=args.lp_max_iters, tol=2e-6)

    for name in names:
        inst = load_or_generate_qcqp(name)
        t0 = time.time()
        rows = qcqp_rows(inst) if inst.m > 0 else None
        anchor0 = qcqp_interior_anchor(inst) if inst.m > 0 else None
        x_in, X_in, lb = bm_feasible_point(inst.Q0, inst.c0, rows=rows,
                                           anchor=anchor0)

        rec = reg.get(name)
        if rec is None:
            if args.lb_only:
                print(f"[validate-qcqp] {name}: no registry entry and "
                      "--lb-only given; skipping", flush=True)
                continue
            sdp, mc, _ = sdp_relaxation_bound(
                inst, lp, max_rounds=args.max_rounds, anchor=(x_in, X_in),
                max_cuts_per_round=16, purge_at=700,
                stall_tol=5e-6, stall_rounds=12)
            fresh = {"mccormick": mc, "sdp": sdp}
            did_ub = True
        else:
            sdp = rec["sdp"]
            fresh = {}
            did_ub = False

        lb = max(lb, (rec or {}).get("sdp_lower", -float("inf")))
        tol = 1e-3 * (1 + abs(sdp))
        rel = (sdp - lb) / (1.0 + abs(sdp))
        if (not args.lb_only and not did_ub
                and (rel > args.rel_target or sdp < lb - tol)):
            ub, _, _ = sdp_relaxation_bound(
                inst, lp, max_rounds=args.max_rounds, anchor=(x_in, X_in),
                max_cuts_per_round=16, purge_at=700,
                stall_tol=5e-6, stall_rounds=12)
            did_ub = True
            if sdp < lb - tol or ub < sdp:
                fresh["sdp_prev_stale"] = sdp
                sdp = ub if sdp < lb - tol else min(sdp, ub)
                fresh["sdp"] = sdp
        rel = (sdp - lb) / (1.0 + abs(sdp))
        fresh.update({"sdp_lower": lb, "sdp_rel_width": rel,
                      "sdp_ok": bool(lb - tol <= sdp)})
        print(f"[validate-qcqp] {name}: sdp={sdp:.4f} lb={lb:.4f} "
              f"rel_width={rel:.4f} ok={fresh['sdp_ok']}"
              + (" UB-RUN" if did_ub else "")
              + f" ({time.time()-t0:.0f}s)", flush=True)
        reg = update_registry(reg_path, name, fresh)
    print("[validate-qcqp] done", flush=True)


if __name__ == "__main__":
    main()
