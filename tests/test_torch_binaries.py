"""The port's socket deployment as real OS processes: two
``fuzzyheavyhitters_torch.bin.server`` processes and a ``bin.leader`` with
``--device cpu --seed`` on the rides config at 32 clients (the run shape of
``tests/test_binaries_e2e.py``), trusted and secure, spawned by
``chip_smoke.socket_run`` (the card's socket phase) on free ports, the
leader with ``FHH_SUPERVISE=0`` and its default warmup.  The
leader's heavy-hitter CSV and hitter lines must equal ``bin.mesh.run``'s
for the same seed; the servers must report their run on SIGTERM and exit 0.
Once more at ``crawl_radix_bits: 2`` with the leader in the test's process
(``socket_run(warm_buckets=...)``, the card's phase 16), warming the
buckets given.  And under the leader's default, the supervised crawl, with
a checkpoint directory a server, server 1 SIGKILLed at its first
checkpoint and started again (``socket_run(supervise=True, kill=True)``,
the card's phase 18)."""

import io
import os

import numpy as np
import pytest
import torch

import chip_smoke
from fuzzyheavyhitters_torch.bin import mesh
from fuzzyheavyhitters_torch.utils import config as tconfig

N_REQS = 32
SEED = 5
CFG = {
    "data_len": 16, "n_dims": 2, "ball_size": 2, "addkey_batch_size": 16, "num_sites": 4,
    "threshold": 0.06, "zipf_exponent": 1.03, "distribution": "rides", "f_max": 512,
    "backend": "cpu", "server0": "", "server1": "",  # socket_run takes free ports
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are tiny, and the suite's other
    workers share the cores (many threads each slow every test tens of times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("secure", [False, True], ids=["trusted", "secure"])
def test_socket_binaries_match_mesh(tmp_path, monkeypatch, secure):
    cfg = tconfig.Config(**CFG, secure_exchange=secure)
    # one intra-op thread per process: three processes beside the suite's
    # other workers would otherwise oversubscribe the cores many times over
    run = chip_smoke.socket_run("socket", cfg, N_REQS, SEED, str(tmp_path),
                                env={"OMP_NUM_THREADS": "1", "FHH_SUPERVISE": "0"})
    # the leader warmed both servers (FHH_WARMUP unset runs it) before its crawl
    assert run["warmup"]["f_buckets"][-1] == CFG["f_max"]
    with open(os.path.join(run["work"], "data", "ride_heavy_hitters.csv")) as f:
        got_csv = f.read()
    got = {e["value"]: e["count"] for e in run["hitters"]}

    (tmp_path / "mesh").mkdir()
    monkeypatch.chdir(tmp_path / "mesh")  # the same synthetic rides points
    res = mesh.run(cfg, N_REQS, device="cpu", seed=SEED, csv_path=str(tmp_path / "mesh.csv"),
                   out=io.StringIO()).result
    assert res.paths.shape[0] >= 1  # a non-degenerate scenario
    assert got_csv == (tmp_path / "mesh.csv").read_text()
    assert got == {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}

    exits = run["exits"]
    phases = {"fss", "gc_ot", "field", "otext", "b2a", "garble", "eval"}
    for sid, ex in enumerate(exits):
        assert ex["server"] == sid and ex["levels"] == CFG["data_len"]
        assert set(ex["seconds"]) == phases
        assert ex["data_bytes_sent"] > 0 and ex["data_bytes_recv"] > 0
        assert ex["control_bytes_recv"] > 0 and ex["control_bytes_sent"] > 0
        assert set(ex["launches"].values()) == {0}  # the CPU runs the plain versions
        assert (ex["seconds"]["otext"] > 0) == secure
    # what one server sent, the other received
    assert exits[0]["data_bytes_sent"] == exits[1]["data_bytes_recv"]
    assert exits[1]["data_bytes_sent"] == exits[0]["data_bytes_recv"]
    assert np.isfinite(list(exits[0]["seconds"].values())).all()


def test_socket_leader_in_process_warms_given_buckets(tmp_path, monkeypatch):
    """``socket_run(warm_buckets=...)``, the card's warmed socket phase: the
    leader is ``bin.leader.run`` in this process, its warmup over the given
    buckets only (one shape each on a whole-level crawl), and its hitters
    those of the processes' leader, so ``bin.mesh.run``'s."""
    cfg = tconfig.Config(**CFG, crawl_radix_bits=2)
    monkeypatch.delenv("FHH_WARMUP", raising=False)
    run = chip_smoke.socket_run("warm", cfg, N_REQS, SEED, str(tmp_path),
                                env={"OMP_NUM_THREADS": "1"}, warm_buckets=[1, 4])
    assert run["warmup"]["f_buckets"] == [1, 4]
    assert run["warmup"]["shapes"] == [2, 2]
    (tmp_path / "mesh").mkdir()
    monkeypatch.chdir(tmp_path / "mesh")
    res = mesh.run(cfg, N_REQS, device="cpu", seed=SEED, csv_path=str(tmp_path / "mesh.csv"),
                   out=io.StringIO()).result
    assert res.paths.shape[0] >= 1
    assert {e["value"]: e["count"] for e in run["hitters"]} == {
        str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
    with open(os.path.join(run["work"], "data", "ride_heavy_hitters.csv")) as f:
        assert f.read() == (tmp_path / "mesh.csv").read_text()
    assert [ex["levels"] for ex in run["exits"]] == [CFG["data_len"] // 2] * 2


def test_socket_binaries_supervised_by_default_survive_a_kill(tmp_path, monkeypatch):
    """``FHH_SUPERVISE`` unset: the leader checkpoints both servers (each
    with its ``FHH_CKPT_DIR``) every 4 levels; server 1's process is
    SIGKILLed at its first checkpoint and started again on its ports and
    directory, restores, and the hitters are ``bin.mesh.run``'s."""
    import chip_smoke as cs

    cfg = tconfig.Config(**CFG)
    monkeypatch.delenv("FHH_SUPERVISE", raising=False)
    run = cs.socket_run("supervised", cfg, N_REQS, SEED, str(tmp_path),
                        env={"OMP_NUM_THREADS": "1", **cs.SUPERVISED_ENV}, supervise=True,
                        kill=True)
    (tmp_path / "mesh").mkdir()
    monkeypatch.chdir(tmp_path / "mesh")
    res = mesh.run(cfg, N_REQS, device="cpu", seed=SEED, csv_path=str(tmp_path / "mesh.csv"),
                   out=io.StringIO()).result
    assert res.paths.shape[0] >= 1
    assert {e["value"]: e["count"] for e in run["hitters"]} == {
        str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
    crawl = run["crawl"]
    assert crawl["supervised"] and crawl["crawl_checkpoints"] == 3
    assert crawl["recoveries"] >= 1 and crawl["levels_rerun"] >= 1
    assert run["killed"]["rc"] == -9 and os.path.exists(run["killed"]["restored_blob"])
    s0, s1 = run["exits"]  # s1: the process started again
    assert s0["ckpt_writes"] == 3 and s0["add_keys"] == s1["add_keys"] == 2
    assert s1["restores"] == 1 and s1["levels_done"] == CFG["data_len"] - 4
    assert s0["boot_id"] != s1["boot_id"]
    restored = [e for e in run["events"]["leader"] if e["event"] == "resilience.restored"]
    assert [e["level"] for e in restored] == [3]
