"""The PyTorch port's whole trusted crawl against the JAX package's
in-process ``driver.Leader``: the same sampled points and the same keys
(carried across with ``keys_from_numpy``) must give identical hitter paths
and counts, in both PRG bit modes, for a zipf ``n_dims=1`` and a
rides-shaped ``n_dims=2`` workload.  Also: the port's ``bin/mesh`` end to
end on the CPU, the config and device refusals."""

import io
import json

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch import workloads as tworkloads
from fuzzyheavyhitters_torch.bin import mesh as tmesh
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.utils import config as tconfig
from fuzzyheavyhitters_torch.utils import resolve_device

jworkloads, jcovid, jibdcf, jprg, jdriver, jconfig = torch_ref.reference(
    "fuzzyheavyhitters_tpu.workloads", "fuzzyheavyhitters_tpu.workloads.covid",
    "fuzzyheavyhitters_tpu.ops.ibdcf", "fuzzyheavyhitters_tpu.ops.prg",
    "fuzzyheavyhitters_tpu.protocol.driver", "fuzzyheavyhitters_tpu.utils.config")

_BASE = dict(
    ball_size=2, addkey_batch_size=100, num_sites=20, threshold=0.05,
    zipf_exponent=1.03, server0="127.0.0.1:8000", server1="127.0.0.1:8001",
)
WORKLOADS = {
    # zipf site strings, n_dims 1 (the config-4 shape at a small size)
    "zipf": dict(_BASE, data_len=16, n_dims=1, threshold=0.015, distribution="zipf"),
    # configs/config.json's rides shape: i16 lat/lon, n_dims 2
    "rides": dict(_BASE, data_len=16, n_dims=2, ball_size=1, threshold=0.075,
                  distribution="rides"),
}


@pytest.fixture
def bit_mode(request, monkeypatch):
    monkeypatch.setattr(jprg, "DERIVED_BITS", request.param)
    monkeypatch.setattr(tprg, "DERIVED_BITS", request.param)
    return request.param


@pytest.mark.parametrize("bit_mode", [False, True], indirect=True)
@pytest.mark.parametrize("workload", ["zipf", "rides"])
def test_crawl_matches_jax_driver(bit_mode, workload):
    raw = WORKLOADS[workload]
    n = 200
    jpts = jworkloads.sample_points(jconfig.Config(**raw), n, np.random.default_rng(3))
    tpts = tworkloads.sample_points(tconfig.Config(**raw), n, np.random.default_rng(3))
    np.testing.assert_array_equal(tpts, jpts)
    k0, k1 = jibdcf.gen_l_inf_ball(jpts, raw["ball_size"], np.random.default_rng(4),
                                   engine="np")
    d, L = raw["n_dims"], raw["data_len"]
    js0, js1 = jdriver.make_servers(k0, k1)
    jres = jdriver.Leader(js0, js1, n_dims=d, data_len=L, f_max=1024).run(
        nreqs=n, threshold=raw["threshold"])
    ts0, ts1 = tdriver.make_servers(tibdcf.keys_from_numpy(k0, "cpu"),
                                    tibdcf.keys_from_numpy(k1, "cpu"))
    tlead = tdriver.Leader(ts0, ts1, n_dims=d, data_len=L, f_max=1024)
    tres = tlead.run(nreqs=n, threshold=raw["threshold"])
    assert jres.paths.shape[0] > 0
    np.testing.assert_array_equal(tres.paths, jres.paths)
    np.testing.assert_array_equal(tres.counts, np.asarray(jres.counts, np.int64))
    np.testing.assert_array_equal(tres.decode_ints(), jres.decode_ints())
    assert len(tlead.timings["expand"]) == L


def test_f_max_overflow_raises_like_jax():
    raw = WORKLOADS["rides"]
    n = 120
    pts = tworkloads.sample_points(tconfig.Config(**raw), n, np.random.default_rng(0))
    k0, k1 = jibdcf.gen_l_inf_ball(pts, 1, np.random.default_rng(1), engine="np")
    js = jdriver.make_servers(k0, k1)
    with pytest.raises(ValueError) as jerr:
        jdriver.Leader(*js, n_dims=2, data_len=16, f_max=2).run(nreqs=n, threshold=0.01)
    ts = tdriver.make_servers(tibdcf.keys_from_numpy(k0, "cpu"),
                              tibdcf.keys_from_numpy(k1, "cpu"))
    with pytest.raises(ValueError) as terr:
        tdriver.Leader(*ts, n_dims=2, data_len=16, f_max=2).run(nreqs=n, threshold=0.01)
    assert str(terr.value) == str(jerr.value)


def _brute_force_counts(points, ball, paths):
    """Clients whose saturated L∞ ball holds each hitter, by integer
    arithmetic on the decoded values (independent of the FSS)."""
    L = points.shape[-1]
    w = 1 << np.arange(L - 1, -1, -1)
    v = (points.astype(np.int64) * w).sum(-1)  # [N, d]
    lo, hi = np.clip(v - ball, 0, None), np.clip(v + ball, None, (1 << L) - 1)
    x = (paths.astype(np.int64) * w).sum(-1)  # [H, d]
    inside = (lo[None] <= x[:, None]) & (x[:, None] <= hi[None])
    return inside.all(-1).sum(1)


def test_mesh_binary_cpu_rides(tmp_path, capsys):
    cfg_path = tmp_path / "rides.json"
    cfg_path.write_text(json.dumps(WORKLOADS["rides"]))
    csv_path = tmp_path / "hh.csv"
    tmesh.main(["--config", str(cfg_path), "-n", "150", "--device", "cpu",
                "--seed", "9", "--csv", str(csv_path)])
    events = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds[:3] == ["sampling", "keygen.report", "crawl.done"]
    hitters = [e for e in events if e["event"] == "hitter"]
    assert hitters and len(hitters) == events[2]["hitters"]
    assert len(csv_path.read_text().splitlines()) == len(hitters) + 1
    # the run() form returns what a caller needs to check the answer
    run = tmesh.run(tconfig.Config(**WORKLOADS["rides"]), 150, device="cpu",
                    seed=9, csv_path=str(tmp_path / "b.csv"), out=io.StringIO())
    np.testing.assert_array_equal(
        run.result.counts, _brute_force_counts(run.points, 1, run.result.paths))
    assert [int(h["count"]) for h in hitters] == run.result.counts.tolist()


@pytest.mark.parametrize("field,value", [
    ("secure_exchange", True), ("malicious", True), ("crawl_radix_bits", 2)])
def test_config_refuses_later_slices(field, value):
    raw = dict(WORKLOADS["zipf"], **{field: value})
    if field != "malicious":  # ported; with the malicious sketch it still raises
        assert getattr(tconfig.Config(**raw), field) == value
        raw["malicious"] = True
    with pytest.raises(NotImplementedError, match="not ported to PyTorch yet"):
        tconfig.Config(**raw)


def test_refusals_of_unported_paths(tmp_path, monkeypatch):
    # covid is ported: the JAX package's sampler on the caller's seed
    covid_raw = dict(WORKLOADS["rides"], distribution="covid", data_len=64)
    pts = tworkloads.sample_points(tconfig.Config(**covid_raw), 4, np.random.default_rng(0))
    assert pts.shape == (4, 2, 64) and pts.dtype == bool
    np.testing.assert_array_equal(pts, jcovid.sample_covid_locations(
        tworkloads.COVID_CSV, tworkloads.CENTROIDS_CSV, 4,
        fuzz_factor=float(tworkloads.AUG_LEN), seed=0))
    with pytest.raises(ValueError, match="data_len 64, n_dims 2"):
        tworkloads.sample_points(
            tconfig.Config(**dict(WORKLOADS["rides"], distribution="covid")), 4,
            np.random.default_rng(0))
    cfg_path = tmp_path / "z.json"
    cfg_path.write_text(json.dumps(WORKLOADS["zipf"]))
    with pytest.raises(NotImplementedError, match="multi-process and multi-card"):
        tmesh.main(["--config", str(cfg_path), "-n", "4", "--processes", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.run(tconfig.Config(**WORKLOADS["zipf"]), 4, out=io.StringIO())
    assert resolve_device("cpu").type == "cpu"
