"""Experiment-driver script smoke tests (SURVEY.md R4): the resumable suite
runner, the parity harness, and the replica-timing harness run end-to-end on
a tiny instance with starved budgets, write well-formed JSONL, and skip
completed cells on re-invocation."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env,
        capture_output=True, text=True, timeout=900,
    )


@pytest.fixture(scope="module")
def tiny_registry(tmp_path_factory):
    """A data dir seeded with spar012-100-3 bounds (computed cheaply)."""
    d = tmp_path_factory.mktemp("boxqp_data")
    from sdpcutsel_tpu.config import LPConfig
    from sdpcutsel_tpu.instances import load_or_generate
    from sdpcutsel_tpu.loop.sdp_bound import sdp_relaxation_bound
    from sdpcutsel_tpu.lp.oracle import solve_mccormick_highs

    inst = load_or_generate("spar012-100-3", data_dir=str(d))
    mc, _, _ = solve_mccormick_highs(inst.Q, inst.c)
    sdp, _, _ = sdp_relaxation_bound(inst, LPConfig(max_iters=4000, tol=1e-5),
                                     max_rounds=8)
    with open(d / "bounds.json", "w") as f:
        json.dump({"spar012-100-3": {"mccormick": float(mc),
                                     "sdp": float(sdp)}}, f)
    return str(d)


def test_run_parity_script_end_to_end(tiny_registry, tmp_path):
    out = tmp_path / "parity.jsonl"
    args = ["scripts/run_parity.py", "--instances", "spar012-100-3",
            "--strategy", "feasibility", "--rounds", "2", "--sel-size", "6",
            "--data-dir", tiny_registry, "--suite", str(tmp_path / "none"),
            "--out", str(out), "--jax-rerun", "--no-purge",
            "--polish-iters", "2000"]
    r = _run(args, REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in open(out)]
    assert len(rows) == 1
    rec = rows[0]
    assert rec["instance"] == "spar012-100-3"
    assert rec["k"] == 3
    assert rec["jax_backend"] == "cpu"
    assert rec["ratio_jax_over_cpu"] is not None
    assert 0.2 <= rec["ratio_jax_over_cpu"] <= 5.0

    # re-invocation skips the completed cell (resumability)
    r2 = _run(args, REPO)
    assert r2.returncode == 0
    assert "already done" in r2.stdout
    assert len([json.loads(l) for l in open(out)]) == 1


def test_suite_incremental_script_resumable(tiny_registry, tmp_path):
    out = tmp_path / "suite.jsonl"
    args = ["scripts/run_suite_incremental.py", "--sizes", "12",
            "--densities", "100", "--seeds", "3", "--strategies",
            "feasibility", "--rounds", "2", "--sel-size", "6",
            "--data-dir", tiny_registry, "--out", str(out),
            "--lp-max-iters", "4000", "--polish-iters", "0",
            "--sdp-max-rounds", "8", "--cpu"]
    r = _run(args, REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in open(out) if "instance" in json.loads(l)]
    assert len(rows) == 1
    assert rows[0]["round_times_s"]
    assert 0.0 <= rows[0]["final_gap_closed"] <= 1.0

    r2 = _run(args, REPO)
    assert r2.returncode == 0
    rows2 = [json.loads(l) for l in open(out) if "instance" in json.loads(l)]
    assert len(rows2) == 1  # skipped, not duplicated


def test_bench_gap_vs_time_script(tiny_registry, tmp_path):
    out = tmp_path / "replica_timing.jsonl"
    r = _run(["scripts/bench_gap_vs_time.py", "--instances", "spar012-100-3",
              "--strategy", "feasibility", "--rounds", "2", "--sel-size", "6",
              "--data-dir", tiny_registry, "--out", str(out)], REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(open(out).readline())
    assert rec["rounds_run"] == 2
    assert len(rec["score_time_s"]) == 2
    assert rec["rounds_per_s"] > 0
