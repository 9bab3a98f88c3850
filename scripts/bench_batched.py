"""Instance-batched solve benchmark (BASELINE.json config 4).

Measures cutting-plane rounds/sec with B instances solved concurrently via
the sharded round step (parallel/round.py) — on one chip this exercises the
vmapped instance batch; on a pod slice the same code shards 'data' across
chips.  Reports rounds/s and instance-rounds/s.

    python scripts/bench_batched.py --n 30 --batch 8 --rounds 6

Suite mode (BASELINE.json config 4's "full benchmark set concurrently"):
generates the 90+ instance grid (sizes x densities x seeds), buckets by n
(one static shape per compile, parallel/round.bucket_instances), and solves
every bucket's instances concurrently:

    python scripts/bench_batched.py --suite --rounds 10
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--lp-iters", type=int, default=400)
    ap.add_argument("--sel-size", type=int, default=16)
    ap.add_argument("--strategy", default="neural",
                    help="sharded scoring strategy (neural is the headline)")
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--cand", type=int, default=1, help="mesh cand axis")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--suite", action="store_true",
                    help="solve the full 90+ instance grid, bucketed by n")
    ap.add_argument("--suite-sizes", default="20,30,40,50,60,70,80,90,100,125")
    ap.add_argument("--suite-densities", default="25,50,75,100")
    ap.add_argument("--suite-seeds", default="1,2,3")
    ap.add_argument("--out", default=None, help="JSONL path for suite mode")
    ap.add_argument("--qcqp", action="store_true",
                    help="QCQP batch (BASELINE config 5): clique-candidate "
                         "table over 'cand', dense constraint rows, k=4")
    ap.add_argument("--qcqp-m", type=int, default=2,
                    help="quadratic constraints per QCQP instance")
    ap.add_argument("--qcqp-density", type=int, default=30)
    ap.add_argument("--use-scan", action="store_true",
                    help="all rounds in ONE dispatch "
                         "(parallel/round.make_sharded_scan_step) — removes "
                         "the per-round host-crossing floor")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache


    enable_compile_cache()

    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.parallel.mesh import make_mesh
    from sdpcutsel_tpu.parallel.round import (
        init_batched_state, make_sharded_round_step, shard_batched_state,
    )
    from sdpcutsel_tpu.parallel.sharding import shard_candidates

    mesh = make_mesh(data=args.data, cand=args.cand)

    if args.suite:
        import json

        from sdpcutsel_tpu.parallel.round import bucket_instances

        sizes = [int(v) for v in args.suite_sizes.split(",")]
        densities = [int(v) for v in args.suite_densities.split(",")]
        seeds = [int(v) for v in args.suite_seeds.split(",")]
        insts = [generate_spar(n, d, s)
                 for n in sizes for d in densities for s in seeds]
        total_inst = len(insts)
        total_t = 0.0
        recs = []
        for n, bucket in bucket_instances(insts).items():
            B = len(bucket)
            Qb = jnp.asarray(np.stack([i.Q for i in bucket]), jnp.float32)
            cb = jnp.asarray(np.stack([i.c for i in bucket]), jnp.float32)
            state = init_batched_state(Qb, cb, capacity=1024, kmax=3)
            state = shard_batched_state(state, mesh)
            table, valid = shard_candidates(combinations_table(n, 3), mesh)
            step = make_sharded_round_step(mesh, lp_iters=args.lp_iters,
                                           sel_size=args.sel_size,
                                           strategy=args.strategy)
            state, _ = step(state, table, valid)    # warmup/compile
            jax.block_until_ready(state)
            t0 = time.perf_counter()
            for _ in range(args.rounds):
                state, _ = step(state, table, valid)
            jax.block_until_ready(state)
            dt = time.perf_counter() - t0
            total_t += dt
            from sdpcutsel_tpu.parallel.round import certify_batched_f64

            rec = {
                "n": n, "batch": B, "rounds": args.rounds,
                "strategy": args.strategy,
                "seconds": round(dt, 3),
                "instance_rounds_per_sec": round(B * args.rounds / dt, 2),
                "mean_bound_certified_f64": float(
                    certify_batched_f64(state).mean()),
            }
            recs.append(rec)
            print(rec, flush=True)
        summary = {
            "suite_instances": total_inst,
            "rounds_each": args.rounds,
            "total_seconds_post_compile": round(total_t, 2),
            "aggregate_instance_rounds_per_sec": round(
                total_inst * args.rounds / total_t, 2) if total_t else None,
            "mesh": f"{args.data}x{args.cand}",
        }
        print(summary, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                for r in recs + [summary]:
                    f.write(json.dumps(r) + "\n")
        return

    dense = None
    if args.qcqp:
        # BASELINE config 5: shared-sparsity QCQP family, clique candidates
        # (k<=4) sharded over 'cand', constraint rows as a batched dense block
        from jax.sharding import NamedSharding, PartitionSpec as P

        from sdpcutsel_tpu.instances.qcqp import generate_qcqp_family
        from sdpcutsel_tpu.qcqp.chordal import (
            chordal_decomposition, clique_candidates,
        )
        from sdpcutsel_tpu.relax.denserows import batched_dense_from_qcqp

        fam = generate_qcqp_family(args.n, args.qcqp_density, args.qcqp_m,
                                   1, args.batch)
        cliques, _ = chordal_decomposition(args.n, fam[0].sparsity_graph())
        table_np = clique_candidates(cliques, 4)
        Qb = jnp.asarray(np.stack([i.Q0 for i in fam]), jnp.float32)
        cb = jnp.asarray(np.stack([i.c0 for i in fam]), jnp.float32)
        state = init_batched_state(Qb, cb, capacity=1024, kmax=4,
                                   m_dense=args.qcqp_m)
        state = shard_batched_state(state, mesh)
        dense = jax.tree.map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P("data"))),
            batched_dense_from_qcqp(fam),
        )
        table, valid = shard_candidates(table_np, mesh)
        step0 = make_sharded_round_step(mesh, lp_iters=args.lp_iters,
                                        sel_size=args.sel_size,
                                        strategy=args.strategy, kmax=4,
                                        m_dense=args.qcqp_m)
        step = lambda st, tb, vl: step0(st, tb, vl, dense)
    else:
        insts = [generate_spar(args.n, 100, s + 1) for s in range(args.batch)]
        Qb = jnp.asarray(np.stack([i.Q for i in insts]), jnp.float32)
        cb = jnp.asarray(np.stack([i.c for i in insts]), jnp.float32)

        state = init_batched_state(Qb, cb, capacity=1024, kmax=3)
        state = shard_batched_state(state, mesh)
        table, valid = shard_candidates(combinations_table(args.n, 3), mesh)
        step = make_sharded_round_step(mesh, lp_iters=args.lp_iters,
                                       sel_size=args.sel_size,
                                       strategy=args.strategy)

    if args.use_scan:
        from sdpcutsel_tpu.parallel.round import (
            certify_scan_f64, make_sharded_scan_step,
        )

        scan0 = make_sharded_scan_step(
            mesh, rounds=args.rounds, lp_iters=args.lp_iters,
            sel_size=args.sel_size, strategy=args.strategy,
            kmax=4 if args.qcqp else 3,
            m_dense=args.qcqp_m if args.qcqp else 0)
        scan = (lambda st: scan0(st, table, valid, dense))
        state0 = state
        state, outs = scan(state0)          # warmup/compile
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        state, outs = scan(state0)
        jax.block_until_ready(state)
        dt = time.perf_counter() - t0
        bounds = certify_scan_f64(state.Q, state.c, outs, dense=dense)
        print({
            "problem": "qcqp-k4" if args.qcqp else "boxqp-k3",
            "mode": "scan",
            "batch": args.batch, "n": args.n,
            "mesh": f"{args.data}x{args.cand}",
            "rounds_per_sec": round(args.rounds / dt, 3),
            "instance_rounds_per_sec": round(
                args.batch * args.rounds / dt, 2),
            "lp_iters_per_round": args.lp_iters,
            "mean_bound": float(bounds[-1].mean()),
            "cuts": np.asarray(state.pool.count).tolist(),
        })
        return

    # warmup / compile
    state, _ = step(state, table, valid)
    jax.block_until_ready(state)

    t0 = time.perf_counter()
    for _ in range(args.rounds):
        state, _ = step(state, table, valid)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0

    from sdpcutsel_tpu.parallel.round import certify_batched_f64

    bounds = certify_batched_f64(state, dense=dense)
    print({
        "problem": "qcqp-k4" if args.qcqp else "boxqp-k3",
        "batch": args.batch, "n": args.n, "mesh": f"{args.data}x{args.cand}",
        "rounds_per_sec": round(args.rounds / dt, 3),
        "instance_rounds_per_sec": round(args.batch * args.rounds / dt, 2),
        "lp_iters_per_round": args.lp_iters,
        "mean_bound": float(bounds.mean()),
        "cuts": np.asarray(state.pool.count).tolist(),
    })


if __name__ == "__main__":
    main()
