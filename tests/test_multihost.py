"""Multi-host bring-up proof (P3, SURVEY.md section 5.8) without a cluster:
two local CPU processes join one JAX runtime via jax.distributed.initialize
(gloo collectives) and run the production sharded round step over a 2 x 4
mesh whose 'data' axis crosses the process boundary."""

import json
import os
import socket
import subprocess
import sys

import pytest

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts", "run_multihost.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cpu_mesh():
    port = _free_port()
    procs = []
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # script sets its own device count
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, _SCRIPT, "--cpu", "--local-devices", "4",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--n", "10", "--batch", "4", "--rounds", "1",
             "--lp-iters", "200", "--strategy", "feasibility"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-3000:]}"

    # process 0 prints the JSON result line with certified bounds
    result = None
    for line in outs[0].splitlines():
        if line.startswith("{"):
            result = json.loads(line)
    assert result is not None, f"no JSON result in:\n{outs[0][-3000:]}"
    assert result["processes"] == 2
    assert result["mesh"] == "2x4"
    assert len(result["bounds_certified_f64"]) == 4
    import numpy as np

    assert np.isfinite(result["bounds_certified_f64"]).all()
