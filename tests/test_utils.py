import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from sdpcutsel_tpu.lp.pdhg import PDHGState, init_state
from sdpcutsel_tpu.relax.cutbuffer import CutPool, empty_pool
from sdpcutsel_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from sdpcutsel_tpu.utils.logging import JSONLLogger
from sdpcutsel_tpu.utils.profiling import ScoringThroughput, timed


def test_checkpoint_roundtrip(tmp_path):
    pool = empty_pool(8, 3)
    pool = pool._replace(rhs=pool.rhs.at[0].set(-0.5),
                         count=jnp.asarray(1, jnp.int32))
    st = init_state(5, 8)
    key = jax.random.PRNGKey(7)
    hist = [{"round": 0, "bound": 12.5}]
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, pool, st, key, hist, {"instance": "x"})

    pd, sd, k2, h2, meta = load_checkpoint(path)
    pool2 = CutPool(**{f: jnp.asarray(v) for f, v in pd.items()})
    st2 = PDHGState(**{f: jnp.asarray(v) for f, v in sd.items()})
    assert float(pool2.rhs[0]) == -0.5 and int(pool2.count) == 1
    np.testing.assert_array_equal(np.asarray(st2.x), np.asarray(st.x))
    np.testing.assert_array_equal(np.asarray(k2), np.asarray(key))
    assert h2 == hist and meta["instance"] == "x"


def test_jsonl_logger(tmp_path):
    p = str(tmp_path / "log.jsonl")
    with JSONLLogger(p) as lg:
        lg.log({"a": 1}, extra_field=2.5)
        lg.log({"b": "x"})
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["a"] == 1 and lines[0]["extra_field"] == 2.5
    assert "ts" in lines[1]


def test_timed_and_throughput():
    f = jax.jit(lambda x: x * 2)
    sec, out = timed(f, jnp.ones(4), repeats=3)
    assert sec >= 0 and float(out[0]) == 2.0
    t = ScoringThroughput(n_chips=2)
    t.add(1000, 0.5)
    assert t.per_sec_per_chip == 1000 / 0.5 / 2


def test_cli_solve_smoke(tmp_path):
    from sdpcutsel_tpu.cli import main

    rc = main([
        "solve", "spar012-100-3", "--cpu", "--strategy", "feasibility",
        "--rounds", "2", "--sel-size", "6", "--capacity", "64",
        "--lp-max-iters", "4000",
        "--data-dir", str(tmp_path),
    ])
    assert rc == 0
    assert os.path.exists(tmp_path / "bounds.json")


def test_sdp_bound_tight_instance_stops_immediately():
    """n=10 generator instances have integral McCormick optima (X = xx'),
    so the SDP loop must certify lam_min >= -tol in round 0."""
    from sdpcutsel_tpu.config import LPConfig
    from sdpcutsel_tpu.instances import generate_spar
    from sdpcutsel_tpu.loop.sdp_bound import sdp_relaxation_bound

    inst = generate_spar(10, 100, 1)
    sdp, mc, hist = sdp_relaxation_bound(
        inst, LPConfig(max_iters=6000, tol=2e-6), max_rounds=5, capacity=64
    )
    assert len(hist) == 1
    assert abs(sdp - mc) < 1e-6


def test_plots_render_all(tmp_path):
    """Figure renderer handles suite records, skips foreign record shapes."""
    import json

    from sdpcutsel_tpu.bench.plots import render_all

    path = tmp_path / "suite.jsonl"
    rec = {
        "instance": "spar010-100-1", "strategy": "neural",
        "gap_closed": [0.0, 0.4, 0.6], "final_gap_closed": 0.6,
        "round_times_s": [0.5, 0.3, 0.3],
        "mccormick": 10.0, "sdp": 5.0,
    }
    foreign = {"instance": "spar010-100-1", "note": "parity row"}
    summary = {"summary": {"neural": {"mean_gap_closed": 0.6}}}
    path.write_text("\n".join(json.dumps(r) for r in (rec, foreign, summary)))
    out = tmp_path / "figs"
    n = render_all(str(path), str(out))
    assert n == 3  # rounds + time figures + the summary bar chart
    assert (out / "gap_vs_rounds_spar010-100-1.svg").exists()
    assert (out / "gap_vs_time_spar010-100-1.svg").exists()
    assert (out / "suite_summary.svg").exists()


def test_config_apply_overrides():
    from sdpcutsel_tpu.config import RunConfig, apply_overrides

    cfg = apply_overrides(RunConfig(), [
        "lp.check_every=50", "cuts.purge=false", "scorer.hidden=32,32",
        "seed=7", "lp.tol=1e-7",
    ])
    assert cfg.lp.check_every == 50 and cfg.lp.tol == 1e-7
    assert cfg.cuts.purge is False
    assert cfg.scorer.hidden == (32, 32)
    assert cfg.seed == 7

    import pytest

    with pytest.raises(ValueError):
        apply_overrides(RunConfig(), ["lp.tol"])
    with pytest.raises(AttributeError):
        apply_overrides(RunConfig(), ["lp.nonexistent=1"])


def test_compile_cache_helper_keeps_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and sets no
    other directory (JAX reads the variable itself)."""
    from sdpcutsel_tpu.utils import compile_cache

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_helper_defaults_to_checkout(monkeypatch):
    """Unset, the cache is the fixed .jax_cache directory of the checkout,
    which .gitignore lists."""
    from sdpcutsel_tpu.utils import compile_cache

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
