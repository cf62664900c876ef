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
the card's phase 18), once more in malicious mode, where that first
checkpoint is the init blob."""

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
    phases = {"fss", "gc_ot", "field", "otext", "b2a", "garble", "eval", "sketch"}
    for sid, ex in enumerate(exits):
        assert ex["server"] == sid and ex["levels"] == CFG["data_len"]
        assert set(ex["seconds"]) == phases
        assert ex["seconds"]["sketch"] == 0 and ex["sketch_verifies"] == 0  # not malicious
        assert ex["alive_clients"] == N_REQS
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


def test_socket_binaries_malicious_supervised_survive_a_kill(tmp_path, monkeypatch):
    """``malicious: true`` over the three processes: the leader makes each
    client's sketch keys after its ibDCF keys (``sketch_gen``), the servers
    bank the init checkpoint (level -1) before any sketch check, server 1
    is SIGKILLed at its first checkpoint and started again; every honest
    client stays alive and the hitters are ``bin.mesh.run``'s on the same
    config without ``malicious`` (which ``bin.mesh`` refuses).  The first
    checkpoint is the init blob, so the kill lands before any round and the
    leader rolls both servers back to level -1 and replays from level 0."""
    import chip_smoke as cs

    cfg = tconfig.Config(**CFG, malicious=True)
    monkeypatch.delenv("FHH_SUPERVISE", raising=False)
    run = cs.socket_run("malicious", cfg, N_REQS, SEED, str(tmp_path),
                        env={"OMP_NUM_THREADS": "1", **cs.SUPERVISED_ENV}, supervise=True,
                        kill=True)
    (tmp_path / "mesh").mkdir()
    monkeypatch.chdir(tmp_path / "mesh")
    res = mesh.run(tconfig.Config(**CFG), N_REQS, device="cpu", seed=SEED,
                   csv_path=str(tmp_path / "mesh.csv"), out=io.StringIO()).result
    assert {e["value"]: e["count"] for e in run["hitters"]} == {
        str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
    crawl = run["crawl"]
    assert crawl["supervised"] and crawl["alive"] == N_REQS and crawl["recoveries"] >= 1
    gen = [e for e in run["events"]["leader"] if e["event"] == "sketch_gen"]
    assert len(gen) == 1 and gen[0]["n_keys"] == N_REQS and gen[0]["bytes_per_server"] > 0
    killed_ck = [e["level"] for e in run["events"]["server1_killed"]
                 if e["event"] == "resilience.server_checkpoint"]
    assert killed_ck[0] == -1  # the init blob, killed at
    s0, s1 = run["exits"]
    assert s0["alive_clients"] == s1["alive_clients"] == N_REQS
    assert s1["restores"] == 1 and s0["sketch_verifies"] >= CFG["data_len"]
    assert s0["seconds"]["sketch"] > 0 and s0["sketch_advance_s"] > 0
    assert [e["level"] for e in run["events"]["leader"]
            if e["event"] == "resilience.restored"] == [-1]
    assert [e["level"] for e in run["events"]["server1"]
            if e["event"] == "resilience.server_restore"] == [-1]


def test_socket_binaries_stream_windows(tmp_path):
    """``FHH_WINDOWS=2``: the leader submits its clients through the
    servers' admission gate (server 0 decides, server 1 mirrors) into two
    windows, seals each (banking an ingest-only checkpoint in each server's
    ``FHH_CKPT_DIR``) and crawls it while the next fills; each window's
    hitter lines equal the in-process crawl of that window's clients."""
    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver

    cfg = tconfig.Config(**CFG)
    run = chip_smoke.socket_run("windows", cfg, N_REQS, SEED, str(tmp_path),
                                env={"OMP_NUM_THREADS": "1", "FHH_WINDOWS": "2",
                                     **chip_smoke.SOCKET_ENV}, ckpt=True)
    ck = leader_bin.client_keys(cfg, N_REQS, torch.device("cpu"), SEED)
    per_w = N_REQS // 2
    ev = run["events"]["leader"]
    for w in range(2):
        sl = slice(w * per_w, (w + 1) * per_w)
        k0, k1 = (ibdcf.keys_from_numpy(ibdcf.IbDcfKeyBatch(*(a[sl] for a in k)), "cpu")
                  for k in (ck.keys0, ck.keys1))
        lead = driver.Leader(*driver.make_servers(k0, k1), n_dims=cfg.n_dims,
                             data_len=cfg.data_len, f_max=cfg.f_max)
        res = lead.run(nreqs=per_w, threshold=cfg.threshold)
        want = {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
        assert want and {e["value"]: e["count"] for e in run["hitters"]
                         if e["window"] == w} == want
        (win,) = [e for e in ev if e["event"] == "ingest.window" and e["window"] == w]
        assert win["keys"] == per_w and win["subs"] == per_w // CFG["addkey_batch_size"]
        (done,) = [e for e in ev if e["event"] == "window.done" and e["window"] == w]
        assert done["recoveries"] == 0 and done["seal_to_hitters_s"] >= done["crawl_s"] * 0
    assert run["crawl"]["windows"] == 2 and run["crawl"]["ingest_admitted"] == N_REQS
    for ex in run["exits"]:
        assert ex["windows_sealed"] == 2 and ex["pool_admitted_keys"] == N_REQS
        assert ex["levels"] == 2 * CFG["data_len"] and ex["ckpt_writes"] == 2
        assert ex["add_keys"] == 0 and ex["seal_to_hitters_s"] is not None


# -- the switches the port refuses by name (the JAX binaries read them) -------

_SWITCHES = [("FHH_RUN_REPORT", "report.json", "the run report"),
             ("FHH_METRICS_PORT", "9100", "the metrics exporter"),
             ("FHH_TRACE_DIR", "traces", "distributed tracing"),
             ("FHH_PROFILE", "prof", "the profiler hooks"),
             ("FHH_LOG_STREAM", "stdout", "the log sinks"),
             ("FHH_LOG_LEVEL", "debug", "log severity filtering"),
             ("FHH_LOG_FORMAT", "human", "log formats other than json"),
             ("FHH_HEARTBEAT_S", "5", "the heartbeat"),
             ("FHH_ALERT_STALL_S", "30", "alerting"),
             ("FHH_ALERT_HBM_FRAC", "0.9", "alerting"),
             ("FHH_DEBUG_GUARDS", "1", "the lock-discipline sanitizer"),
             ("FHH_DEBUG_TAINT", "1", "the taint sanitizer")]


def _main(binary):
    from fuzzyheavyhitters_torch.bin import leader, server

    return {"leader": lambda cfg: leader.main(["-c", cfg, "-n", "4", "--device", "cpu"]),
            "server": lambda cfg: server.main(["-c", cfg, "--server_id", "0", "--device",
                                               "cpu"]),
            "mesh": lambda cfg: mesh.main(["-c", cfg, "-n", "4", "--device", "cpu"])}[binary]


def _clear_switches(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("FHH_RUN_", "FHH_METRICS_", "FHH_TRACE_", "FHH_PROFILE", "FHH_LOG_",
                         "FHH_HEARTBEAT_", "FHH_ALERT_", "FHH_DEBUG_")):
            monkeypatch.delenv(k)


@pytest.mark.parametrize("binary", ["leader", "server", "mesh"])
@pytest.mark.parametrize("var,val,layer", _SWITCHES, ids=[v for v, _, _ in _SWITCHES])
def test_unported_switch_is_refused_by_name(tmp_path, monkeypatch, binary, var, val, layer):
    """Each observability and sanitizer switch of the JAX binaries is
    refused at start-up, by name and with the part of the port that will
    bring it, before the config is read or anything is started."""
    _clear_switches(monkeypatch)
    monkeypatch.setenv(var, val)
    part = "sanitizers" if var.startswith("FHH_DEBUG_") else "observability"
    with pytest.raises(NotImplementedError, match=f"{var}={val}: {layer}.* is not ported "
                       f"to PyTorch yet; it belongs to .*{part}"):
        _main(binary)(str(tmp_path / "absent.json"))


@pytest.mark.parametrize("binary", ["leader", "server", "mesh"])
def test_json_log_format_is_accepted(tmp_path, monkeypatch, binary):
    """``FHH_LOG_FORMAT=json`` is what the port prints: the binary goes on
    to read its config (absent here)."""
    _clear_switches(monkeypatch)
    monkeypatch.setenv("FHH_LOG_FORMAT", "json")
    monkeypatch.setenv("FHH_ALERT_STALL_S", "")  # set but empty asks for nothing
    with pytest.raises(FileNotFoundError):
        _main(binary)(str(tmp_path / "absent.json"))


@pytest.mark.parametrize("where", ["leader", "server", "CollectorServer", "RpcLeader"])
def test_debug_guards_config_is_refused(tmp_path, monkeypatch, where):
    """``debug_guards: true`` arms the JAX server's and leader's sanitizer:
    the port's binaries and their classes refuse it by name."""
    import json

    from fuzzyheavyhitters_torch.protocol import leader_rpc, rpc

    _clear_switches(monkeypatch)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(CFG, server0="127.0.0.1:1", server1="127.0.0.1:2",
                                    debug_guards=True)))
    cfg = tconfig.load_config(str(path))
    run = {"leader": lambda: _main("leader")(str(path)),
           "server": lambda: _main("server")(str(path)),
           "CollectorServer": lambda: rpc.CollectorServer(0, cfg, "cpu"),
           "RpcLeader": lambda: leader_rpc.RpcLeader(cfg, None, None)}[where]
    with pytest.raises(NotImplementedError, match="debug_guards: true: the lock-discipline "
                       "sanitizer.* is not ported to PyTorch yet"):
        run()
