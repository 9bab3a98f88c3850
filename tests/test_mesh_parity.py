"""Sharded batched scans against the one-device scan of the same instances
(__graft_entry__.mesh_delta): every mesh must append the same cuts in every
round and certify the same bounds to f32 rounding, and a fault in the
candidate exchange must fail that check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import (
    MESH_ATOL, MESH_RTOL, ScanResult, boxqp_scan_bounds, dryrun_multichip,
    mesh_delta, qcqp_scan_bounds,
)
from sdpcutsel_tpu.instances import generate_spar
from sdpcutsel_tpu.instances.qcqp import generate_qcqp_family
from sdpcutsel_tpu.parallel.mesh import make_mesh

N = 12


@pytest.fixture(scope="module")
def boxqp():
    insts = [generate_spar(N, 100, s + 1) for s in range(8)]
    return insts, boxqp_scan_bounds(make_mesh(1, 1), insts)


@pytest.fixture(scope="module")
def qcqp():
    fam = generate_qcqp_family(N, 30, 2, 1, 4)
    return fam, qcqp_scan_bounds(make_mesh(1, 1), fam)


@pytest.mark.parametrize("data,cand", [(2, 2), (4, 1), (1, 4), (2, 4),
                                       (8, 1)])
def test_boxqp_scan_matches_one_device(boxqp, data, cand):
    insts, ref = boxqp
    res = boxqp_scan_bounds(make_mesh(data, cand), insts)
    d = mesh_delta(res, ref)
    assert (res.count[1:] > 0).all()
    assert d["same_cuts"] and d["ok"], d


@pytest.mark.parametrize("data,cand", [(2, 2), (4, 1), (1, 4)])
def test_qcqp_scan_matches_one_device(qcqp, data, cand):
    fam, ref = qcqp
    res = qcqp_scan_bounds(make_mesh(data, cand), fam)
    d = mesh_delta(res, ref)
    assert (res.count[1:] > 0).all()
    assert d["same_cuts"] and d["ok"], d


def _drop_second_shard(monkeypatch):
    """Make the 'cand' all_gather lose the second shard's local winners:
    their scores arrive as -inf, as if that shard never sent them."""
    real = jax.lax.all_gather

    def dropping(x, axis_name, **kw):
        g = real(x, axis_name, **kw)
        S = x.shape[0]
        if (axis_name == "cand" and g.shape[0] >= 2 * S
                and jnp.issubdtype(g.dtype, jnp.floating)):
            g = g.at[S:2 * S].set(-jnp.inf)
        return g

    monkeypatch.setattr(jax.lax, "all_gather", dropping)


@pytest.mark.parametrize("problem", ["boxqp", "qcqp"])
def test_dropped_shard_fails_check(request, monkeypatch, problem):
    data, ref = request.getfixturevalue(problem)
    run = boxqp_scan_bounds if problem == "boxqp" else qcqp_scan_bounds
    _drop_second_shard(monkeypatch)
    res = run(make_mesh(1, 4), data)
    d = mesh_delta(res, ref)
    assert not d["same_cuts"] and not d["ok"], d
    # the bounds alone already exceed the limit
    assert (np.abs(res.bounds - ref.bounds)
            > MESH_ATOL + MESH_RTOL * np.abs(ref.bounds)).any(), d
    # round 0 is solved before any selection, so it still agrees
    assert d["round0_abs"] <= MESH_ATOL + MESH_RTOL * np.abs(ref.bounds).max()


def _result(bounds=(100.0, 90.0), idx_shift=0, count_shift=0):
    b = np.asarray(bounds, np.float64)[:, None]
    idx = np.full((len(bounds) + 1, 1, 4, 3), -1)
    idx[1:, 0, :2] = [[0, 1, 2], [1, 2, 3]]
    idx[2, 0, 0, 0] += idx_shift
    count = np.array([[0], [2], [2]]) + count_shift
    return ScanResult(b, idx, count)


@pytest.mark.parametrize("res,ok", [
    (_result(), True),
    (_result(bounds=(100.0 + 0.5 * (MESH_ATOL + 100 * MESH_RTOL), 90.0)),
     True),
    (_result(bounds=(100.0, 90.0 - 2 * (MESH_ATOL + 90 * MESH_RTOL))),
     False),
    (_result(idx_shift=1), False),
    (_result(count_shift=1), False),
    (_result(bounds=(100.0, np.nan)), False),
], ids=["equal", "within", "beyond", "other_cut", "other_count", "nan"])
def test_mesh_delta_limit(res, ok):
    assert mesh_delta(res, _result())["ok"] is ok


def test_dryrun_multichip_on_four_devices(capsys):
    dryrun_multichip(4)
    assert "dryrun_multichip ok: mesh=(2x2)" in capsys.readouterr().out
