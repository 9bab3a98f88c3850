"""QCQP parity harness: JAX CutSolverQCQP vs the CPU replica
(baseline/cpu_reference_qcqp.py) on the same instance / strategy / k /
sel_size / rounds — the sparse-path companion of scripts/run_parity.py.

Both sides rank the IDENTICAL clique-candidate table (qcqp/chordal.py is
shared host-side preprocessing); "neural" runs the replica through its
custom-score hook with the same trained per-k net, so the comparison
isolates the LP backend + loop mechanics (PDHG vs HiGHS).  Gap-closed uses
the per-instance (mccormick, sdp) denominators from results/qcqp.jsonl when
available, else the round-0 bound and the final replica bound anchor the
improvement ratio directly.

Usage:
    python scripts/run_qcqp_parity.py --names qcqp020-25-4-1,qcqp025-25-4-2 \
        --strategies feasibility,neural --k 4 --rounds 8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--names", required=True, help="comma list of qcqp names")
    ap.add_argument("--strategies", default="feasibility,neural")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--sel-size", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--lp-max-iters", type=int, default=20000)
    ap.add_argument("--polish-iters", type=int, default=60000)
    ap.add_argument("--out", default="results/qcqp_parity.jsonl")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--sel-gate", default=None,
                    help="CutConfig.sel_gate for the JAX side (default: the "
                         "config default — 'residual'); 'cooldown' or "
                         "'none' to compare gate mechanisms")
    ap.add_argument("--cooldown", type=int, default=0,
                    help="CutConfig.sel_cooldown for the JAX side (only "
                         "meaningful with --sel-gate cooldown)")
    ap.add_argument("--steer-eps", type=float, default=0.0,
                    help="vertex steering for the JAX scoring point "
                         "(LoopConfig.steer_eps; see qcqp/solver.py)")
    ap.add_argument("--diversity-alpha", type=float, default=0.0,
                    help="support-diverse selection penalty (ops/topk.py "
                         "diverse_topk) — breaks feasibility-score ties "
                         "toward low-overlap clique subsets")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from sdpcutsel_tpu.baseline.cpu_reference_qcqp import cpu_cut_select_qcqp
    from sdpcutsel_tpu.config import (
        CutConfig, LoopConfig, LPConfig, RunConfig, ScorerConfig,
    )
    from sdpcutsel_tpu.instances.qcqp import load_or_generate_qcqp
    from sdpcutsel_tpu.qcqp.solver import CutSolverQCQP

    # per-instance gap denominators recorded by run_qcqp_suite.py
    denoms = {}
    if os.path.exists("results/qcqp.jsonl"):
        for line in open("results/qcqp.jsonl"):
            r = json.loads(line)
            if "mccormick" in r and "sdp" in r:
                denoms[r["instance"]] = (r["mccormick"], r["sdp"])

    for name in args.names.split(","):
        inst = load_or_generate_qcqp(name)
        for strat in args.strategies.split(","):
            replica_strategy, score_fn = strat, None
            if strat == "neural":
                from sdpcutsel_tpu.qcqp.chordal import (
                    chordal_decomposition, clique_candidates,
                )
                from sdpcutsel_tpu.models.scorer import neural_score_fn

                cliques, _ = chordal_decomposition(
                    inst.n, inst.sparsity_graph())
                table = jnp.asarray(clique_candidates(cliques, args.k))
                # identical gated ranking on BOTH stacks: the
                # JAX solver gates neural selection on cut-emission
                # violation (combined=True, gate_tol=viol_tol); the replica
                # must rank with the same rule or the cells measure the
                # selection fix rather than stack parity
                fn = neural_score_fn(jnp.asarray(inst.Q0, jnp.float32),
                                     table, ScorerConfig(),
                                     combined=True,
                                     gate_tol=CutConfig().viol_tol)
                key = jax.random.PRNGKey(0)

                def score_fn(x, X, tbl, _fn=fn, _key=key):
                    import numpy as np
                    return np.asarray(_fn(
                        jnp.asarray(x, jnp.float32),
                        jnp.asarray(X, jnp.float32), _key))

                replica_strategy = "custom"

            t0 = time.perf_counter()
            hist, _ = cpu_cut_select_qcqp(
                inst, k=args.k, sel_size=args.sel_size, rounds=args.rounds,
                strategy=replica_strategy, score_fn=score_fn,
            )
            rep_t = time.perf_counter() - t0
            rep_bounds = [h.bound for h in hist]

            cfg = RunConfig(
                lp=LPConfig(max_iters=args.lp_max_iters, tol=2e-6),
                cuts=CutConfig(k=args.k, sel_size=args.sel_size,
                               capacity=1024, purge=False,
                               sel_cooldown=args.cooldown,
                               diversity_alpha=args.diversity_alpha,
                               **({"sel_gate": args.sel_gate}
                                  if args.sel_gate else {})),
                scorer=ScorerConfig(strategy=strat),
                loop=LoopConfig(rounds=args.rounds,
                                polish_iters=args.polish_iters,
                                steer_eps=args.steer_eps),
            )
            t0 = time.perf_counter()
            out = CutSolverQCQP(inst, cfg).run(args.rounds)
            jax_t = time.perf_counter() - t0
            jax_bounds = [h.bound for h in out]

            mc, sdp = denoms.get(name, (rep_bounds[0], None))
            if sdp is not None:
                gd = lambda b: max(0.0, min(1.0, (mc - b) / max(mc - sdp, 1e-12)))
                rep_final, jax_final = gd(rep_bounds[-1]), gd(jax_bounds[-1])
                ratio = jax_final / max(rep_final, 1e-12)
            else:
                rep_impr = rep_bounds[0] - rep_bounds[-1]
                jax_impr = jax_bounds[0] - jax_bounds[-1]
                rep_final = jax_final = None
                ratio = jax_impr / max(rep_impr, 1e-12)
            rec = {
                "instance": name, "strategy": strat, "k": args.k,
                "sel_size": args.sel_size, "rounds": args.rounds,
                "replica_bounds": rep_bounds, "jax_bounds": jax_bounds,
                "replica_gap_closed": rep_final, "jax_gap_closed": jax_final,
                "ratio": ratio, "replica_wall_s": rep_t, "jax_wall_s": jax_t,
                "jax_diversity_alpha": args.diversity_alpha,
                "jax_backend": jax.default_backend(),
                "jax_polish_iters": args.polish_iters,
                "jax_steer_eps": args.steer_eps,
                "jax_sel_gate": args.sel_gate or CutConfig().sel_gate,
                "jax_sel_cooldown": args.cooldown,
                "ts": time.time(),
            }
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[qcqp-parity] {name} {strat}: ratio={ratio:.3f} "
                  f"replica={rep_bounds[-1]:.4f} jax={jax_bounds[-1]:.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
