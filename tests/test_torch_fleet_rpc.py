"""The PyTorch port's collector fleet end to end on the CPU, against the
never-migrated run, tolerance zero (the flows of ``torch_fleet_flows.py``,
the JAX ``tests/test_fleet.py`` shapes):

(a) a trusted windowed collection live-migrated mid-stream, window 0
    sealed on pair A and window 1 half submitted, then both windows crawled
    on pair B: port pairs and mixed pairs (A's server 0 the JAX package's,
    B's the port's, and the reverse for server 1, so each server's export
    crosses packages), under the port's and the JAX ``WindowedIngest``;
(b) a malicious window migrated after its seal: the destination crawl
    opens the identical challenge root and the forger stays excluded;
(c) a ``host:kill`` clause kills pair A; the probe marks it dead and the
    collection fails over to B from its ingest checkpoint and the journal;
(d) one named collection migrated off a pair that keeps crawling another.

Each run's hitters, paths and counts equal the never-migrated run's, and
the journal replay lands every submission once (the destination answers
the exported ones as duplicates).  The secure legs are
``test_torch_fleet_secure.py``."""

import numpy as np
import pytest
import torch

import torch_fleet_flows as F

MIXED = (("jax", "port"), ("port", "jax"))
PORT = (("port", "port"), ("port", "port"))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_migrated(fig, replayed, key="default"):
    """What every live migration leaves: the export carried both windows,
    every journaled submission replayed and answered as a duplicate on the
    destination, the source's pools gone, the counters and placements."""
    assert fig["stats"] == {"windows": [0, 1], "replayed": replayed}
    assert all(d >= replayed for d in fig["dup_submits"])
    assert fig["replays"] >= 2 * replayed
    assert fig["src_pools"] == [{}, {}]
    assert [st["fleet"]["session_exports"] for st in fig["src_status"]] == [1, 1]
    assert [st["fleet"]["session_imports"] for st in fig["dest_status"]] == [1, 1]
    for st in fig["dest_status"]:
        assert st["fleet"]["boot_id"] == st["boot_id"]
        assert set(st["fleet"]["load"]) == {"stall_fill_ratio", "max_progress_age_s"}
    assert fig["placed"] == "A"
    assert fig["placer"] == {"placement_decisions": 2, "session_migrations": 1,
                             "session_failovers": 0, "migration_inflight_since": 0.0}
    assert fig["directory"]["placements"] == {key: "B"}


@pytest.mark.parametrize("leader", ["port", "jax"])
@pytest.mark.parametrize("pairs", [PORT, MIXED], ids=["port-pairs", "mixed-pairs"])
def test_trusted_migration_mid_stream_bit_identical(tmp_path, pairs, leader):
    kw = F.cfg_kw("trusted")
    results, fig = F.move_flow(tmp_path, *pairs, leader, kw, F.PLANS["two"], "migrate")
    assert results == F.control(kw, "two")
    assert all(r[0] for r in results.values())
    check_migrated(fig, replayed=9)


@pytest.mark.parametrize("pairs,leader", [(PORT, "port"), (MIXED, "jax")],
                         ids=["port-pairs-port-leader", "mixed-pairs-jax-leader"])
def test_malicious_migration_replays_the_identical_challenge(tmp_path, pairs, leader):
    """Window 0 sealed on A commits its challenge root there; migrated, it
    crawls on B, whose two servers commit that same root (a replay of the
    challenge, never a second opening of the slabs); the forger alone is
    excluded and the hitters are the never-migrated run's."""
    kw = F.cfg_kw("malicious")
    results, fig = F.move_flow(tmp_path, *pairs, leader, kw, F.PLANS["one"], "migrate")
    assert results == F.control(kw, "one")
    root = np.array(fig["seal0"]["sk_root"], np.uint32).tolist()
    assert fig["roots"] == [root, root]
    want_alive = [i != F.FORGER for i in range(F.N)]
    assert fig["alive"] == [want_alive, want_alive]
    check_migrated(fig, replayed=15)


@pytest.mark.parametrize("pairs,leader", [(PORT, "port"), (MIXED, "jax"), (PORT, "jax")],
                         ids=["port-pairs-port-leader", "mixed-pairs-jax-leader",
                              "port-pairs-jax-leader"])
def test_host_kill_failover_resumes_on_survivor_bit_identical(tmp_path, pairs, leader):
    """A ``host:kill@window=0`` clause fires and pair A dies after window
    0's seal (its ingest checkpoint banked) with three of window 1's
    submissions landed; the bounded probe marks A dead, B alive, and the
    collection fails over to B from A's level -1 blob in the shared store
    and the journal.  The checkpointed submissions replay as duplicates,
    the journal's tail lands fresh."""
    kw = F.cfg_kw("trusted")
    results, fig = F.move_flow(tmp_path, *pairs, leader, kw, F.PLANS["two"], "failover")
    assert results == F.control(kw, "two")
    assert fig["fired"] == [("kill", 0)] and fig["died"] == ["A"]
    assert fig["stats"] == {"imported": True, "replayed": 9}
    assert all(d >= 6 for d in fig["dup_submits"])
    assert [st["fleet"]["session_imports"] for st in fig["dest_status"]] == [1, 1]
    # the first placement, the survivor's, the failover's
    assert fig["placer"] == {"placement_decisions": 3, "session_migrations": 0,
                             "session_failovers": 1, "migration_inflight_since": 0.0}
    assert fig["directory"]["placements"] == {"default": "B"}
    assert fig["directory"]["pairs"]["A"]["alive"] is False
    assert fig["directory"]["pairs"]["B"]["alive"] is True


def test_named_collection_migrates_off_a_pair_that_keeps_crawling_another(tmp_path):
    """Collection ``tb`` migrates from A to B while ``ta`` crawls its own
    window on A: ``tb`` equals its never-migrated run, ``ta`` its own, and
    A's retire of ``tb`` leaves ``ta``'s pools and checkpoints alone."""
    kw = F.cfg_kw("trusted")
    results, fig = F.move_flow(tmp_path, *PORT, "port", kw, F.PLANS["two"], "migrate",
                               collection="tb", neighbour="ta")
    assert results == F.control(kw, "two")
    assert fig["neighbour"] == F.control(kw, "one")[0]
    assert fig["neighbour_pools"] == [[0], [0]]
    check_migrated(fig, replayed=9, key="tb")
    for st in fig["dest_status"]:
        assert st["collection"] == "tb" and sorted(st["sessions"]["per_session"]) == ["tb"]
