"""Fill data/boxqp/optima.json with best-known feasible objectives (lower
bounds) for every instance in the suite grid — the analogue of the
reference's known-optima table (SURVEY.md R8).  Pure numpy on host; safe to
run while the GPU is busy.

    JAX_PLATFORMS=cpu python scripts/fill_optima.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default="data/boxqp")
    ap.add_argument("--sizes", default="20,30,40,50,60,70,80,90,100,125")
    ap.add_argument("--densities", default="25,50,75,100")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--starts", type=int, default=24)
    args = ap.parse_args()

    from sdpcutsel_tpu.instances import load_or_generate
    from sdpcutsel_tpu.instances.local_optima import best_known_solution

    path = os.path.join(args.data_dir, "optima.json")
    reg = {}
    if os.path.exists(path):
        with open(path) as f:
            reg = json.load(f)

    names = [
        f"spar{n:03d}-{d}-{s}"
        for n in (int(v) for v in args.sizes.split(","))
        for d in (int(v) for v in args.densities.split(","))
        for s in (int(v) for v in args.seeds.split(","))
    ]
    for name in names:
        if name in reg:
            continue
        inst = load_or_generate(name, data_dir=args.data_dir)
        _, f = best_known_solution(inst.Q, inst.c, starts=args.starts)
        reg[name] = {"best_known": f, "method": "multistart-coordinate-ascent",
                     "starts": args.starts}
        with open(path, "w") as fh:
            json.dump(reg, fh, indent=1, sort_keys=True)
        print(f"[optima] {name}: best_known={f:.6f}", flush=True)


if __name__ == "__main__":
    main()
