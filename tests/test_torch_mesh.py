"""The PyTorch port's device mesh (``parallel/mesh.py``) against the JAX
package's, byte for byte (tolerance 0: the protocol is bitwise).

The port's ``MeshRunner`` runs on 2 × 4 and 2 × 1 logical CPU shards, the
JAX one on the conftest's eight virtual CPU devices (2 × 4), on the
scenario of ``tests/test_mesh.py`` (L = 6, d = 2, n = 32; the same keys in
both packages).  Held: the trusted per-level counts, the hitters and the
``snapshot`` dict, a mid-crawl snapshot restored into a fresh runner; the
secure ``level_count_shares`` words under base-OT material fixed in both
packages, for the 1-of-2^S branch at d = 1 and the GC branch at d = 2
(``EQ_OT4`` off), in both garbler directions and both fields; whole secure
crawls; ``field_psum`` near 2^64 and across the 2^255 wrap; the odd-count
and non-dividing refusals.  The JAX results are computed once per module."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tfields
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.parallel import mesh as tmesh
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jmesh, jibdcf, jbits, jsecure, jfields, jdriver = torch_ref.reference(
    "fuzzyheavyhitters_tpu.parallel.mesh", "fuzzyheavyhitters_tpu.ops.ibdcf",
    "fuzzyheavyhitters_tpu.utils.bits", "fuzzyheavyhitters_tpu.protocol.secure",
    "fuzzyheavyhitters_tpu.ops.fields", "fuzzyheavyhitters_tpu.protocol.driver")

CPU = torch.device("cpu")
THRESHOLD = 0.1


def _scenario(seed, L, d, n, ball):
    """tests/test_mesh.py's clustered points and the JAX package's keys, with
    the same keys carried into the port."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 1 << L, size=(3, d))
    pts = centers[rng.integers(0, 3, size=n)] + rng.integers(-1, 2, size=(n, d))
    pts = np.clip(pts, 0, (1 << L) - 1)
    bits = np.array([[jbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, k1 = jibdcf.gen_l_inf_ball(bits, ball, rng, engine="np")
    tk = [tibdcf.keys_from_numpy(type(k)(*(np.asarray(a) for a in k)), CPU) for k in (k0, k1)]
    return {"L": L, "d": d, "n": n, "jkeys": (k0, k1), "tkeys": tk}


@pytest.fixture(scope="module")
def sc2():
    return _scenario(7, 6, 2, 32, 2)


@pytest.fixture(scope="module")
def sc1():
    return _scenario(11, 5, 1, 32, 1)


def _recording(runner, name, log):
    """Wrap ``runner.<name>`` to keep each call's level and result."""
    fn = getattr(runner, name)

    def call(level, *a, **kw):
        out = fn(level, *a, **kw)
        log.append((level, np.asarray(out)))
        return out

    setattr(runner, name, call)


def _hitters(res):
    return {tuple(int(v) for v in row): int(c) for row, c in zip(res.decode_ints(), res.counts)}


def _partial(leader, levels, n):
    """Run the first ``levels`` levels of a crawl through the leader's own
    level step (either package's)."""
    leader.r.tree_init()
    leader.paths = np.zeros((1, leader.r.n_dims, 0), bool)
    leader.n_nodes = 1
    for level in range(levels):
        assert leader._run_one_level(level, n, THRESHOLD) is not None


@pytest.fixture(scope="module")
def jax_trusted(sc2):
    m = jmesh.make_mesh(devices=jax.devices("cpu"))
    assert m.shape == {"servers": 2, "data": 4}
    with torch_ref.installed():
        r = jmesh.MeshRunner(m, *sc2["jkeys"], f_max=128)
        log = []
        _recording(r, "level_counts", log)
        res = jmesh.MeshLeader(r).run(nreqs=sc2["n"], threshold=THRESHOLD)
        final = {k: np.asarray(v) for k, v in r.snapshot().items()}
        lead = jmesh.MeshLeader(jmesh.MeshRunner(m, *sc2["jkeys"], f_max=128))
        _partial(lead, 3, sc2["n"])
        mid = {k: np.asarray(v) for k, v in lead.r.snapshot().items()}
        mid_paths = lead.paths.copy()
    return {"hitters": _hitters(res), "paths": res.paths, "counts": res.counts, "log": log,
            "final": final, "mid": mid, "mid_paths": mid_paths}


def _assert_snap_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("k", [4, 1])
def test_trusted_mesh_matches_jax(sc2, jax_trusted, k):
    m = tmesh.make_mesh(devices=[CPU] * (2 * k))
    assert m.shape == {"servers": 2, "data": k}
    r = tmesh.MeshRunner(m, *sc2["tkeys"], f_max=128)
    log = []
    _recording(r, "level_counts", log)
    res = tmesh.MeshLeader(r).run(nreqs=sc2["n"], threshold=THRESHOLD)
    assert jax_trusted["hitters"]  # a non-degenerate scenario
    assert _hitters(res) == jax_trusted["hitters"]
    np.testing.assert_array_equal(res.paths, jax_trusted["paths"])
    np.testing.assert_array_equal(res.counts, jax_trusted["counts"])
    assert [lv for lv, _ in log] == [lv for lv, _ in jax_trusted["log"]]
    for (_, got), (_, want) in zip(log, jax_trusted["log"]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    _assert_snap_equal(r.snapshot(), jax_trusted["final"])


def test_snapshot_and_restore_match_jax(sc2, jax_trusted):
    """A snapshot three levels in equals the JAX runner's; restoring the JAX
    package's snapshot into a fresh port runner (2 × 2 shards) and going on
    gives the JAX crawl's hitters."""
    m = tmesh.make_mesh(devices=[CPU] * 8)
    lead = tmesh.MeshLeader(tmesh.MeshRunner(m, *sc2["tkeys"], f_max=128))
    _partial(lead, 3, sc2["n"])
    _assert_snap_equal(lead.r.snapshot(), jax_trusted["mid"])
    fresh = tmesh.MeshLeader(tmesh.MeshRunner(tmesh.make_mesh(devices=[CPU] * 4),
                                              *sc2["tkeys"], f_max=128))
    fresh.r.restore(jax_trusted["mid"])
    _assert_snap_equal(fresh.r.snapshot(), jax_trusted["mid"])
    fresh.paths, fresh.n_nodes = jax_trusted["mid_paths"].copy(), lead.n_nodes
    for level in range(3, sc2["L"]):
        kept = fresh._run_one_level(level, sc2["n"], THRESHOLD)
    got = {tuple(int(v) for v in row): int(c) for row, c in
           zip(tdriver.CrawlResult(fresh.paths, kept).decode_ints(), kept)}
    assert got == jax_trusted["hitters"]


def _fixed_material(monkeypatch, mat):
    """Make the JAX runner's secure set-up draw ``mat``: its two sessions'
    s bits and base-OT seeds, then the session seed."""
    sessions = iter(mat["sessions"])
    cur = {}

    def fresh_s_bits(*_):
        cur["s"] = next(sessions)
        return cur["s"][0]

    monkeypatch.setattr(jmesh.otext, "fresh_s_bits", fresh_s_bits)
    monkeypatch.setattr(jmesh.baseot, "exchange", lambda s_bits, *_: cur["s"][1:])
    monkeypatch.setattr(jmesh._secrets, "token_bytes",
                        lambda nb: np.asarray(mat["sec_seed"], "<u4").tobytes())


# (level, field, last): both garbler directions in both fields
SHARE_CALLS = [(0, "FE62", False), (1, "FE62", False), (2, "F255", True), (3, "F255", True)]


@pytest.mark.parametrize("branch", ["ot2s_d1", "gc_d2"])
def test_secure_share_words_match_jax(sc1, sc2, branch, monkeypatch):
    """``level_count_shares`` byte-equal under the same session material:
    the per-shard seed tweaks, the garbler row's derived seeds, the session
    counters advanced by the per-shard batch, ``field_psum`` and the
    replication all show in these words."""
    sc = sc1 if branch == "ot2s_d1" else sc2
    eq_ot4 = branch == "ot2s_d1"
    monkeypatch.setattr(jsecure, "EQ_OT4", eq_ot4)
    monkeypatch.setattr(tsecure, "EQ_OT4", eq_ot4)
    assert tsecure._ot4_use(2 * sc["d"]) == eq_ot4
    mat = tdriver.session_material(random.Random(17))
    _fixed_material(monkeypatch, mat)
    with torch_ref.installed():
        jr = jmesh.MeshRunner(jmesh.make_mesh(devices=jax.devices("cpu")), *sc["jkeys"],
                              f_max=64, secure_exchange=True)
        jr.tree_init()
        want = [np.asarray(jr.level_count_shares(lv, getattr(jfields, f), last=last))
                for lv, f, last in SHARE_CALLS]
    tr = tmesh.MeshRunner(tmesh.make_mesh(devices=[CPU] * 8), *sc["tkeys"], f_max=64,
                          secure_exchange=True, session=mat)
    tr.tree_init()
    for (lv, f, last), w in zip(SHARE_CALLS, want):
        got = tr.level_count_shares(lv, getattr(tfields, f), last=last)
        assert got.dtype == w.dtype and got.shape == w.shape, (lv, f)
        np.testing.assert_array_equal(got, w, err_msg=f"level {lv} {f}")
    # the garbler's fresh seeds per call: the same level twice differs
    a, b = (tr.level_count_shares(1) for _ in range(2))
    assert not np.array_equal(a, b)


@pytest.fixture(scope="module")
def jax_oracles(sc1, sc2):
    """The JAX package's colocated trusted driver on both scenarios."""
    out = {}
    with jax.default_device(jax.devices("cpu")[0]), torch_ref.installed():
        for name, sc, f_max in (("d1", sc1, 64), ("d2", sc2, 128)):
            s0, s1 = jdriver.make_servers(*sc["jkeys"])
            lead = jdriver.Leader(s0, s1, n_dims=sc["d"], data_len=sc["L"], f_max=f_max)
            out[name] = _hitters(lead.run(nreqs=sc["n"], threshold=THRESHOLD))
    return out


@pytest.mark.parametrize("branch", ["ot2s_d1", "ot2s_d2", "gc_d2"])
def test_secure_mesh_crawl_matches_jax_driver(sc1, sc2, jax_oracles, branch, monkeypatch):
    """Whole secure crawls on 2 × 4 shards reconstruct the JAX driver's
    trusted hitters (the 1-of-2^S table at S = 2 and 4, the GC at S = 4)."""
    sc, f_max = (sc1, 64) if branch == "ot2s_d1" else (sc2, 128)
    monkeypatch.setattr(tsecure, "EQ_OT4", branch != "gc_d2")
    r = tmesh.MeshRunner(tmesh.make_mesh(devices=[CPU] * 8), *sc["tkeys"], f_max=f_max,
                         secure_exchange=True, session=tdriver.session_material(random.Random(3)))
    res = tmesh.MeshLeader(r).run(nreqs=sc["n"], threshold=THRESHOLD)
    want = jax_oracles["d1" if branch == "ot2s_d1" else "d2"]
    assert want and _hitters(res) == want


def _jax_psum(jfield, stacked):
    f = jax.vmap(lambda x: jmesh.field_psum(jfield, x, "data"), axis_name="data")
    return np.asarray(f(jnp.asarray(stacked)))[0]


@pytest.mark.parametrize("k", [2, 4, 8])
def test_field_psum_matches_jax(k):
    rng = np.random.default_rng(100 + k)
    # FE62 words near 2^64 (lazily reduced words reach past p)
    top = np.uint64(2**64 - 1)
    v = top - rng.integers(0, 2**20, size=(k, 5, 3), dtype=np.uint64)
    v[:, 0] = rng.integers(0, 2**63, size=(k, 3), dtype=np.uint64)
    want = _jax_psum(jfields.FE62, v)
    got = tmesh.field_psum(tfields.FE62, torch.from_numpy(v.view(np.int64)), 0)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # F255 values just below p, so the k-way sum crosses 2^255 (and 2^256)
    p = (1 << 255) - 19
    vals = [[p - 1 - int(rng.integers(0, 1000)) if (i + j) % 3 else
             int(rng.integers(0, 2**62)) for j in range(4)] for i in range(k)]
    limbs = np.array([[[(x >> (32 * t)) & 0xFFFFFFFF for t in range(8)] for x in row]
                      for row in vals], np.uint32)
    want = _jax_psum(jfields.F255, limbs)
    got = tmesh.field_psum(tfields.F255, words_from_numpy(limbs, CPU), 0)
    np.testing.assert_array_equal(words_to_numpy(got), want)
    back = [sum(int(w) << (32 * t) for t, w in enumerate(row)) for row in want]
    assert back == [sum(vals[i][j] for i in range(k)) % p for j in range(4)]


def test_refusals(sc2):
    with pytest.raises(ValueError, match="even device count"):
        tmesh.make_mesh(devices=[CPU] * 3)
    with pytest.raises(AssertionError, match="even"):
        jmesh.make_mesh(devices=jax.devices("cpu")[:3])
    with pytest.raises(ValueError, match="client count 32 must divide the data axis 3"):
        tmesh.MeshRunner(tmesh.make_mesh(devices=[CPU] * 6), *sc2["tkeys"], f_max=128)
    with pytest.raises(ValueError, match="two-process"):
        tmesh.MeshRunner.from_process_local(tmesh.make_mesh(devices=[CPU] * 2),
                                            sc2["tkeys"][0], f_max=128)
    with pytest.raises(RuntimeError, match="without secure_exchange"):
        r = tmesh.MeshRunner(tmesh.make_mesh(devices=[CPU] * 2), *sc2["tkeys"], f_max=128)
        r.tree_init()
        r.level_count_shares(0)
