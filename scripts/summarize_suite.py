"""Render results/suite.jsonl into a per-(instance, k) strategy table
(markdown).  BASELINE.md's headline suite numbers are regenerated by this
script — they must always be reproducible from the live results file.

    python scripts/summarize_suite.py [results/suite.jsonl]
"""

import json
import os
import sys


def load(path, registry="data/boxqp/bounds.json"):
    """Load suite rows, recomputing gap-closed against the LIVE bounds
    registry: the validation sweep (scripts/validate_sdp_bounds.py) can
    tighten stall-stopped SDP values after a suite run was recorded, and the
    headline table must use the tightened denominators.  Rows keep their raw
    bound trajectories, so the recompute is exact."""
    reg = {}
    if registry and os.path.exists(registry):
        reg = json.load(open(registry))
    rows = {}
    strategies = []
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "instance" not in r:
                continue
            if r.get("k") is None:
                # legacy rows predating config logging were moved to
                # suite_legacy_knone.jsonl; reject any
                # stragglers rather than letting them form a shadow cell
                # space next to the keyed cells
                continue
            e = reg.get(r["instance"])
            if (e and "bounds" in r
                    and abs(e["sdp"] - r.get("sdp", e["sdp"])) > 1e-9):
                mc, sdp = e["mccormick"], e["sdp"]
                denom = max(mc - sdp, 1e-12)
                r["sdp"], r["mccormick"] = sdp, mc
                r["gap_closed"] = [
                    min(1.0, max(0.0, (mc - b) / denom)) for b in r["bounds"]
                ]
                r["final_gap_closed"] = r["gap_closed"][-1]
            key = (r["instance"], r.get("k", 3))
            rows.setdefault(key, {})[r["strategy"]] = r
            if r["strategy"] not in strategies:
                strategies.append(r["strategy"])
    return rows, strategies


def main(path="results/suite.jsonl"):
    rows, strategies = load(path)

    print("| instance | k | gap (MC-SDP) | " + " | ".join(strategies) + " |")
    print("|---" * (len(strategies) + 3) + "|")
    sums = {s: [] for s in strategies}
    ordering_ok = ordering_total = 0
    for name, k in sorted(rows):
        recs = rows[(name, k)]
        any_r = next(iter(recs.values()))
        gap = any_r["mccormick"] - any_r["sdp"]
        cells = []
        for s in strategies:
            if s in recs:
                v = recs[s]["final_gap_closed"]
                if k == 3:  # headline means are the k=3 grid
                    sums[s].append(v)
                cells.append(f"{100*v:.1f}%")
            else:
                cells.append("—")
        if "neural" in recs and "feasibility" in recs:
            ordering_total += 1
            nv = recs["neural"]["final_gap_closed"]
            fv = recs["feasibility"]["final_gap_closed"]
            # saturated cells (feasibility already >= 0.98: both strategies
            # near-exhaust the gap, differences are noise) and sub-1pp ties
            # do not discriminate between selection rules
            if nv >= fv or fv >= 0.98 or fv - nv < 0.01:
                ordering_ok += 1
        print(f"| {name} | {k} | {gap:.1f} | " + " | ".join(cells) + " |")
    means = [
        f"{100*sum(v)/len(v):.1f}% (n={len(v)})" if v else "—"
        for v in (sums[s] for s in strategies)
    ]
    print("| **mean (k=3)** | | | " + " | ".join(means) + " |")
    print(f"\nneural >= feasibility (or cell saturated/tied within 1pp) on "
          f"{ordering_ok}/{ordering_total} (instance, k) cells")

    # by-density means (k=3): low-density cells saturate near 100% for every
    # strategy and would inflate a single pooled mean
    by_d = {}
    for (name, k), recs in rows.items():
        if k != 3:
            continue
        d = int(name.split("-")[1])
        for s, r in recs.items():
            by_d.setdefault(d, {}).setdefault(s, []).append(
                r["final_gap_closed"])
    print("\n| density | " + " | ".join(strategies) + " |")
    print("|---" * (len(strategies) + 1) + "|")
    for d in sorted(by_d):
        cells = []
        for s in strategies:
            v = by_d[d].get(s)
            cells.append(f"{100*sum(v)/len(v):.1f}% (n={len(v)})" if v
                         else "—")
        print(f"| {d}% | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main(*sys.argv[1:])
