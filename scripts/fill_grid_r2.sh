#!/bin/bash
# Round-2 continuation of the 120-name BoxQP grid fill (SURVEY.md §0.1 / R8).  Breadth-first: prioritize NEW instances (neural +
# feasibility — the pair that confirms the paper's ordering per instance)
# over the random control, which is already measured on 42 cells at n<=40.
# The incremental runner skips completed (instance, strategy, k) cells, so
# this script is kill-and-relaunch safe.
set -u
cd "$(dirname "$0")/.."
LOG=results/fill_grid.log
run() {
  echo "[fill_grid_r2] $(date +%T) python scripts/run_suite_incremental.py $*" >> "$LOG"
  python scripts/run_suite_incremental.py "$@" >> "$LOG" 2>&1
}
# band A: k=2 cells (SURVEY.md §0.3: k in {2,3} for dense BoxQP) — fast, fills
# the "zero k=2 suite cells" gap first
run --sizes 20,30,40,50 --densities 100 --seeds 1 --k 2 --sel-size 20 \
    --strategies neural,feasibility
# band B: finish n=40,50 (all densities x seeds)
run --sizes 40,50 --densities 25,50,75,100 --seeds 1,2,3 --sel-size 20 \
    --strategies neural,feasibility
# band C: n=60,70
run --sizes 60,70 --densities 25,50,75,100 --seeds 1,2,3 --sel-size 20 \
    --strategies neural,feasibility
# band D: large n
run --sizes 80,90,100 --densities 25,50,75,100 --seeds 1,2,3 --sel-size 40 \
    --strategies neural,feasibility
# band E: n=125
run --sizes 125 --densities 25,50,75,100 --seeds 1,2,3 --sel-size 50 \
    --strategies neural,feasibility
# band F: backfill the random control on the newly added mid-size instances
run --sizes 40,50,60,70 --densities 25,50,75,100 --seeds 1,2,3 --sel-size 20 \
    --strategies random
echo "[fill_grid_r2] $(date +%T) ALL BANDS COMPLETE" >> "$LOG"
