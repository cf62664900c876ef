"""The port's mesh drills (``resilience/chaos.py``: ``MeshChaos``,
``parse_mesh_faults``) and ``MeshLeader.run_supervised``, mirroring
``tests/test_mesh_chaos.py``: the JAX grammar's accepted and refused
strings (held against the JAX package's parser), clauses that fire once,
a drop (re-run the level), a kill (restore the last snapshot) and a delay
(no recovery) in one crawl, bit-identical to a fault-free run and to the
JAX package's colocated driver, trusted and secure; a kill before the
first checkpoint (restart); and exhausted recoveries re-raising.  Shapes
of ``tests/test_mesh.py`` (L = 6, d = 2, n = 32) on 2 × 4 logical CPU
shards."""

import random

import jax
import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.parallel import mesh as tmesh
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.resilience.chaos import (MeshChaos, MeshFaultError,
                                                       MeshFaultSpec, parse_mesh_faults)

jchaos, jibdcf, jbits, jdriver = torch_ref.reference(
    "fuzzyheavyhitters_tpu.resilience.chaos", "fuzzyheavyhitters_tpu.ops.ibdcf",
    "fuzzyheavyhitters_tpu.utils.bits", "fuzzyheavyhitters_tpu.protocol.driver")

CPU = torch.device("cpu")


def test_parse_mesh_faults_grammar():
    spec = "mesh:drop@level=3;mesh:kill@level=5;mesh:delay@level=1,ms=50"
    faults = parse_mesh_faults(spec)
    assert [f.action for f in faults] == ["drop", "kill", "delay"]
    assert faults[0].at_level == 3
    assert faults[2].ms == 50
    assert [(f.action, f.at_level, f.ms) for f in faults] == [
        (f.action, f.at_level, f.ms) for f in jchaos.parse_mesh_faults(spec)]
    assert parse_mesh_faults("") == [] and parse_mesh_faults(None) == []


@pytest.mark.parametrize("bad", [
    "mesh:drop",  # no trigger
    "mesh:drop@ms=5",  # missing level=
    "mesh:explode@level=1",  # unknown action
    "plane:drop@level=1",  # wrong link
    "mesh:drop@level=-1",  # negative level
    "mesh:drop@level=1,when=2",  # unknown argument
    "garbage",
])
def test_parse_mesh_faults_rejects_malformed(bad):
    with pytest.raises(ValueError):
        jchaos.parse_mesh_faults(bad)
    with pytest.raises(ValueError):
        parse_mesh_faults(bad)


def test_mesh_chaos_clauses_fire_once():
    """A fired clause does not trigger again on the re-run of its level."""

    class R:  # a runner stand-in
        frontier = object()
        _children = None

    events = []
    chaos = MeshChaos([MeshFaultSpec("drop", 2)], emit=lambda e, **kw: events.append((e, kw)))
    chaos.before_level(R(), 0)  # below the trigger: nothing
    with pytest.raises(MeshFaultError) as ei:
        chaos.before_level(R(), 2)
    assert not ei.value.state_lost
    chaos.before_level(R(), 2)  # the re-run proceeds
    assert chaos.fired == [("drop", 2)]
    assert events == [("resilience.mesh_chaos_fired", {"action": "drop", "level": 2})]
    r = R()
    with pytest.raises(MeshFaultError) as ei:
        MeshChaos([MeshFaultSpec("kill", 0)]).before_level(r, 3)
    assert ei.value.state_lost and r.frontier is None


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    L, d, n = 6, 2, 32
    centers = rng.integers(0, 1 << L, size=(3, d))
    pts = centers[rng.integers(0, 3, size=n)] + rng.integers(-1, 2, size=(n, d))
    pts = np.clip(pts, 0, (1 << L) - 1)
    bits = np.array([[jbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = jibdcf.gen_l_inf_ball(bits, 2, rng, engine="np")
    tk = [tibdcf.keys_from_numpy(type(k)(*(np.asarray(a) for a in k)), CPU) for k in (k0, k1)]
    with jax.default_device(jax.devices("cpu")[0]), torch_ref.installed():
        s0, s1 = jdriver.make_servers(k0, k1)
        res = jdriver.Leader(s0, s1, n_dims=d, data_len=L, f_max=128).run(nreqs=n,
                                                                         threshold=0.1)
    return tk, n, _as_dict(res)


def _as_dict(res):
    return {tuple(int(v) for v in row): int(c) for row, c in zip(res.decode_ints(), res.counts)}


def _leader(tk, secure=False, events=None):
    runner = tmesh.MeshRunner(tmesh.make_mesh(devices=[CPU] * 8), *tk, f_max=128,
                              secure_exchange=secure,
                              session=tdriver.session_material(random.Random(9))
                              if secure else None)
    emit = None if events is None else (lambda e, **kw: events.append((e, kw)))
    return tmesh.MeshLeader(runner, emit=emit)


def test_mesh_drop_and_kill_recover_bit_identical(batch):
    """One crawl with a dropped shard (level re-run), a killed participant
    (snapshot restore) and a delay (no recovery): the hitters equal the
    fault-free run's and the JAX driver's, the counters name the recoveries."""
    tk, n, oracle = batch
    assert oracle
    lead = _leader(tk)
    res_ff = lead.run_supervised(n, 0.1, checkpoint_every=2)
    assert lead.counters["recoveries"] == 0 and lead.counters["crawl_checkpoints"] == 2
    chaos = MeshChaos(parse_mesh_faults(
        "mesh:delay@level=1,ms=20;mesh:drop@level=2;mesh:kill@level=4"))
    events = []
    lead2 = _leader(tk, events=events)
    res = lead2.run_supervised(n, 0.1, checkpoint_every=2, chaos=chaos)
    assert _as_dict(res) == _as_dict(res_ff) == oracle
    np.testing.assert_array_equal(res.paths, res_ff.paths)
    np.testing.assert_array_equal(res.counts, res_ff.counts)
    assert set(chaos.fired) == {("delay", 1), ("drop", 2), ("kill", 4)}
    c = lead2.counters
    assert (c["recoveries"], c["shards_rerun"], c["levels_rerun"]) == (2, 1, 1)
    # the faults fire before a level's fetch, and the kill's restore lands
    # on the snapshot after level 3: one fetch a level
    assert c["device_fetches"] == 6 and c["crawl_checkpoints"] == 2
    assert [kw["state_lost"] for e, kw in events if e == "resilience.mesh_recover"] == [
        False, True]
    assert lead2.survivors == lead.survivors


def test_mesh_kill_before_first_checkpoint_restarts(batch):
    tk, n, oracle = batch
    lead = _leader(tk)
    chaos = MeshChaos(parse_mesh_faults("mesh:kill@level=1"))
    res = lead.run_supervised(n, 0.1, checkpoint_every=4, chaos=chaos)
    assert _as_dict(res) == oracle
    assert lead.counters["recoveries"] == 1 and lead.counters["levels_rerun"] == 1


@pytest.mark.parametrize("eq_ot4", [True, False])
def test_mesh_secure_recovers_bit_identical(batch, eq_ot4, monkeypatch):
    """The secure crawl (the 1-of-16 table, or the GC) under a drop and a
    kill: fresh shares on the re-runs, the same reconstructed hitters."""
    monkeypatch.setattr(tsecure, "EQ_OT4", eq_ot4)
    tk, n, oracle = batch
    lead = _leader(tk, secure=True)
    chaos = MeshChaos(parse_mesh_faults("mesh:drop@level=1;mesh:kill@level=3"))
    res = lead.run_supervised(n, 0.1, checkpoint_every=2, chaos=chaos)
    assert _as_dict(res) == oracle
    assert lead.counters["recoveries"] == 2


def test_mesh_exhausted_recoveries_reraise(batch):
    tk, n, _ = batch
    lead = _leader(tk)
    chaos = MeshChaos([MeshFaultSpec("drop", 0) for _ in range(9)])
    with pytest.raises(MeshFaultError):
        lead.run_supervised(n, 0.1, max_recoveries=3, chaos=chaos)
    assert lead.counters["recoveries"] == 4
