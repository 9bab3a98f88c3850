"""Render results/parity.jsonl into a markdown table grouped by
(strategy, mode) — BASELINE.md's parity claims are regenerated by this
script so they stay reproducible from the live results file.

Modes: "suite-cell" rows compare against recorded (pre-polish, purge-on)
suite cells; "rerun" rows re-ran the JAX build fresh with final polish,
optionally purge matched to the replica (no-purge) and/or support-diverse
selection (diversity alpha).

    python scripts/summarize_parity.py [results/parity.jsonl]
"""

import json
import sys
from collections import defaultdict


def main(path="results/parity.jsonl"):
    latest = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "instance" not in r:
                continue
            if r.get("jax_rerun"):
                mode = "rerun"
                if not r.get("jax_purge", True):
                    mode += " no-purge"
                if r.get("jax_diversity_alpha", 0.0) > 0:
                    mode += " diverse"
            else:
                mode = "suite-cell"
            if r.get("cpu_diversity_alpha", 0.0) > 0:
                # replica got the JAX build's support-diverse tie-breaking:
                # a genuinely like-for-like row
                mode += " +replica-diverse"
            r["_mode"] = mode
            # last row per cell wins (suite-cell rows are re-recorded after
            # grid refills so they track the CURRENT suite config)
            latest[(r["instance"], r["strategy"], r.get("k", 3), mode,
                    r.get("rounds"))] = r
    groups = defaultdict(list)
    for r in latest.values():
        groups[(r["strategy"], r.get("k", 3), r["_mode"])].append(r)

    # A ratio far ABOVE 1 is not "parity passing" — it means the stacks
    # behave differently (e.g. the triangle interior-vs-vertex selection
    # divergence, ARCHITECTURE.md).  Count those separately so a 2.9x cell
    # can't silently launder a behavioral mismatch as a pass.
    DIVERGENT_ABOVE = 1.5
    print("| strategy | k | mode | cells | ratio JAX/replica "
          "(min / mean / max) | cells >= 0.95 | divergent (> "
          f"{DIVERGENT_ABOVE}x) |")
    print("|---|---|---|---|---|---|---|")
    for (strategy, k, mode), rows in sorted(groups.items()):
        ratios = [r["ratio_jax_over_cpu"] for r in rows
                  if r.get("ratio_jax_over_cpu") is not None]
        if not ratios:
            continue
        ok = sum(1 for x in ratios if 0.95 <= x <= DIVERGENT_ABOVE)
        div = sum(1 for x in ratios if x > DIVERGENT_ABOVE)
        print(f"| {strategy} | {k} | {mode} | {len(ratios)} | "
              f"{min(ratios):.3f} / {sum(ratios)/len(ratios):.3f} / "
              f"{max(ratios):.3f} | {ok}/{len(ratios)} | {div} |")

    print()
    print("Per-cell detail (rerun rows):")
    print("| instance | strategy | k | mode | replica | JAX | ratio |")
    print("|---|---|---|---|---|---|---|")
    for (strategy, k, mode), rows in sorted(groups.items()):
        if not mode.startswith("rerun"):
            continue
        for r in sorted(rows, key=lambda x: x["instance"]):
            if r.get("ratio_jax_over_cpu") is None:
                continue
            print(f"| {r['instance']} | {strategy} | {k} | {mode} | "
                  f"{100*r['cpu_final_gap_closed']:.1f}% | "
                  f"{100*r['jax_final_gap_closed']:.1f}% | "
                  f"{r['ratio_jax_over_cpu']:.3f} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
