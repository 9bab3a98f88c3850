"""Multi-host sharded solve entry point (P3 bring-up, SURVEY.md section 5.8).

One process per host, each driving all of that host's GPUs.  Every host runs
this script with the same arguments plus its own --process-id; the processes
join one JAX runtime (parallel/distributed.py), form a ('data' x 'cand') mesh
whose 'data' axis spans the hosts (parallel/mesh.py), and run the production
sharded round step (parallel/round.py) for --rounds rounds over an instance
batch sharded across hosts.  Process 0 prints one JSON line with certified
f64 bounds.

Two GPU hosts (process 0's host reachable as host0):

    python scripts/run_multihost.py --coordinator host0:29871 \
        --num-processes 2 --process-id 0 --data 2 --cand 4 --rounds 5
    python scripts/run_multihost.py --coordinator host0:29871 \
        --num-processes 2 --process-id 1 --data 2 --cand 4 --rounds 5

Without a cluster (two local CPU processes, gloo collectives, 2x4 virtual
mesh — what tests/test_multihost.py automates):

    python scripts/run_multihost.py --cpu --local-devices 4 \
        --coordinator 127.0.0.1:29871 --num-processes 2 --process-id 0 ... &
    python scripts/run_multihost.py --cpu --local-devices 4 \
        --coordinator 127.0.0.1:29871 --num-processes 2 --process-id 1 ...
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="virtual CPU devices per process (--cpu testing)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--cand", type=int, default=4)
    ap.add_argument("--lp-iters", type=int, default=400)
    ap.add_argument("--sel-size", type=int, default=4)
    ap.add_argument("--strategy", default="neural")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.local_devices:
            flags = os.environ.get("XLA_FLAGS", "")
            if "xla_force_host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    f"{flags} --xla_force_host_platform_device_count="
                    f"{args.local_devices}").strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from sdpcutsel_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from sdpcutsel_tpu.parallel import distributed as dist

    dist.initialize(args.coordinator, args.num_processes, args.process_id)
    pid = jax.process_index()
    print(f"[p{pid}] processes={jax.process_count()} "
          f"local={jax.local_device_count()} global={jax.device_count()}",
          flush=True)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from sdpcutsel_tpu.cuts.enumerate import combinations_table
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.parallel.mesh import make_mesh
    from sdpcutsel_tpu.parallel.round import (
        BatchedRoundState, certify_batched_f64, init_batched_state,
        make_sharded_round_step,
    )
    from sdpcutsel_tpu.parallel.sharding import pad_table

    mesh = make_mesh(data=args.data, cand=args.cand)

    # identical deterministic instance batch on every host; put_global shards
    # the 'data' axis so each host's devices hold only their instances
    insts = [generate_spar(args.n, 100, s + 1) for s in range(args.batch)]
    Qb = np.stack([i.Q for i in insts]).astype(np.float32)
    cb = np.stack([i.c for i in insts]).astype(np.float32)
    state_host = init_batched_state(jnp.asarray(Qb), jnp.asarray(cb),
                                    capacity=128, kmax=3)
    state = jax.tree.map(
        lambda leaf: dist.put_global(np.asarray(leaf), mesh, P("data")),
        state_host,
    )
    tbl, val = pad_table(combinations_table(args.n, 3), mesh.shape["cand"])
    table = dist.put_global(tbl, mesh, P("cand", None))
    valid = dist.put_global(val, mesh, P("cand"))

    step = make_sharded_round_step(mesh, lp_iters=args.lp_iters,
                                   sel_size=args.sel_size,
                                   strategy=args.strategy)
    info = None
    for _ in range(args.rounds):
        state, info = step(state, table, valid)
    jax.block_until_ready(state)

    # host-side consensus on the result: gather every 'data' shard, then
    # recertify each instance's bound in f64 on host
    # collectives below must run on EVERY process (process_allgather blocks
    # until all hosts join) — only the final print is rank-0-only
    full = dist.fetch_tree(state)
    lp_iters = dist.fetch_tree(info["lp_iters"])
    cert = certify_batched_f64(jax.tree.map(jnp.asarray, full))
    dist.sync("rounds-done")
    if pid == 0:
        print(json.dumps({
            "mesh": f"{args.data}x{args.cand}",
            "processes": jax.process_count(),
            "strategy": args.strategy,
            "rounds": args.rounds,
            "bounds_f32": np.asarray(full.bound).round(4).tolist(),
            "bounds_certified_f64": np.round(cert, 4).tolist(),
            "cuts": np.asarray(full.pool.count).tolist(),
            "lp_iters": np.asarray(lp_iters).tolist(),
        }), flush=True)


if __name__ == "__main__":
    main()
