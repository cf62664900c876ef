"""The port's mesh in two processes over gloo on the CPU, one mesh row each
(2 × 4 logical shards in all): the scenario of
``tests/test_mesh_multiprocess.py`` through ``MeshRunner.from_process_local``
(``tests/torch_mp_worker.py``), trusted and secure, whose hitters must equal
the JAX package's colocated driver on the same keys, with no tensor of the
peer party's keys in either process; the same under ``run_supervised``
with a kill after the first checkpoint, whose snapshots must equal the
one-process runner's; and ``bin.mesh --processes 2`` on
``configs/config.json``, trusted and secure, whose hitters must equal the
one-process single-card crawl, again with no peer keys held.  (The JAX package's two-process test xfails
on this host's CPU backend; this one runs.)"""

import io
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch
import torch_mp_worker
import torch_ref
from fuzzyheavyhitters_torch.bin import mesh as tmesh_bin
from fuzzyheavyhitters_torch.parallel import mesh as tmesh
from fuzzyheavyhitters_torch.resilience.chaos import MeshChaos, parse_mesh_faults
from fuzzyheavyhitters_torch.utils import config as tconfig

jibdcf, jbits, jdriver = torch_ref.reference(
    "fuzzyheavyhitters_tpu.ops.ibdcf", "fuzzyheavyhitters_tpu.utils.bits",
    "fuzzyheavyhitters_tpu.protocol.driver")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "torch_mp_worker.py")
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(argv_of, cwd):
    """Run two processes (``argv_of(pid, coordinator)``) to their end;
    returns their standard outputs."""
    # one intra-op thread a process: the suite runs beside other workers, and
    # two spinning thread pools that wait on each other's messages starve
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(argv_of(pid, coord), env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"process failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def oracle():
    """The JAX package's colocated trusted driver on the workers' scenario."""
    rng = np.random.default_rng(7)
    L, d, n = 6, 2, 32
    centers = rng.integers(0, 1 << L, size=(3, d))
    pts = centers[rng.integers(0, 3, size=n)] + rng.integers(-1, 2, size=(n, d))
    pts = np.clip(pts, 0, (1 << L) - 1)
    bits = np.array([[jbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = jibdcf.gen_l_inf_ball(bits, 2, rng, engine="np")
    with jax.default_device(jax.devices("cpu")[0]), torch_ref.installed():
        s0, s1 = jdriver.make_servers(k0, k1)
        res = jdriver.Leader(s0, s1, n_dims=d, data_len=L, f_max=128).run(nreqs=n,
                                                                         threshold=0.1)
    return sorted([[int(v) for v in row] + [int(c)]
                   for row, c in zip(res.decode_ints(), res.counts)])


@pytest.mark.parametrize("secure", [False, True])
def test_two_process_mesh_matches_jax_driver(oracle, secure, tmp_path):
    got = _worker_results(_pair(lambda pid, coord: [
        sys.executable, _WORKER, str(pid), coord, "1" if secure else "0"], tmp_path))
    assert oracle
    for pid, o in enumerate(got):
        assert o["pid"] == pid and o["held_rows"] == [pid]
        assert o["hitters"] == oracle, o
        assert o["own_keys_held"] and not o["peer_keys_held"]
    assert got[0]["bytes"] == got[1]["bytes"][::-1]  # what one sent the other received


def _worker_results(outs):
    return [json.loads([ln for ln in o.splitlines() if ln.startswith("RESULT ")][-1][7:])
            for o in outs]


@pytest.mark.parametrize("secure", [False, True])
def test_two_process_supervised_snapshots_match_one_process(oracle, secure, tmp_path):
    """``run_supervised`` on two processes, the participant killed after
    the first checkpoint: each process's snapshots (both rows, swapped once)
    equal the one-process runner's on the same keys and faults, and the
    restored crawl finds the oracle's hitters."""
    got = _worker_results(_pair(lambda pid, coord: [
        sys.executable, _WORKER, str(pid), coord, "1" if secure else "0", "supervised"],
        tmp_path))
    keys, n = torch_mp_worker.scenario_keys()
    runner = tmesh.MeshRunner(tmesh.make_mesh(devices=[torch.device("cpu")] * 8), *keys,
                              f_max=128, min_bucket=8)
    snaps = []
    take = runner.snapshot
    runner.snapshot = lambda: snaps.append(take()) or snaps[-1]
    lead = tmesh.MeshLeader(runner)
    lead.run_supervised(n, 0.1, checkpoint_every=2,
                        chaos=MeshChaos(parse_mesh_faults(torch_mp_worker.SUPERVISED_FAULTS)))
    want = [torch_mp_worker.snapshot_digest(s) for s in snaps]
    assert len(want) == 2  # after levels 1 and 3 (level 3 again after the restore)
    for pid, o in enumerate(got):
        assert o["held_rows"] == [pid] and o["hitters"] == oracle, o
        assert o["snapshots"] == want
        assert o["counters"]["recoveries"] == 1 and o["counters"]["levels_rerun"] == 1
        assert not o["peer_keys_held"]


def _events(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("secure", [False, True])
def test_bin_mesh_two_processes_match_one(secure, tmp_path):
    """``bin.mesh --devices 8 --processes 2``: both processes print the
    hitters of the single-card trusted crawl at the same seed (a secure
    crawl reconstructs the trusted counts), report the bytes they moved
    through the process group, and hold no root seed of the peer party's
    keys when the crawl begins."""
    with open(os.path.join(_REPO, "configs", "config.json")) as f:
        raw = dict(json.load(f), secure_exchange=secure)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(raw))
    n, seed = 300, 1
    outs = _pair(lambda pid, coord: [
        sys.executable, _WORKER, "bin", "-c", str(cfg_path),
        "-n", str(n), "--device", "cpu", "--seed", str(seed), "--devices", "8",
        "--processes", "2", "--process_id", str(pid), "--coordinator", coord,
        "--csv", str(tmp_path / f"hh{pid}.csv")], tmp_path)
    buf = io.StringIO()
    one = tmesh_bin.run(tconfig.Config(**dict(raw, secure_exchange=False)), n, device="cpu",
                        seed=seed, csv_path=str(tmp_path / "one.csv"), out=buf)
    ev_one = _events(buf.getvalue())
    want = [e for e in ev_one if e["event"] == "hitter"]
    assert want and not next(e for e in ev_one if e["event"] == "crawl.done")["mesh"]
    moved = []
    for pid, out in enumerate(outs):
        ev = _events(out)
        assert [e for e in ev if e["event"] == "hitter"] == want
        place = next(e for e in ev if e["event"] == "mesh.placement")
        assert place["held_rows"] == [pid] and place["processes"] == 2
        done = next(e for e in ev if e["event"] == "crawl.done")
        assert done["mesh"] and done["hitters"] == len(want)
        moved.append(done["group_bytes"])
        held = json.loads([ln for ln in out.splitlines() if ln.startswith("HOLDINGS ")][-1][9:])
        assert held == {"own_keys_held": True, "peer_keys_held": False}
    assert moved[0]["sent"] == moved[1]["received"] > 0
    assert os.path.exists(tmp_path / "hh0.csv") and not os.path.exists(tmp_path / "hh1.csv")
    assert len(one.result.counts) == len(want)
