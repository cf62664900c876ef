"""The PyTorch port's covid workload against the JAX package's.

The sampler (``workloads/covid.py``) is held bit-identical to the JAX
``sample_covid_locations`` for the same seed, in both of its branches (the
uniform-county fallback and a case CSV) with and without jitter, and its f64
bit codec on edge values.  A covid crawl (data_len 64, n_dims 2: the one
workload whose paths decode through Python ints) on the CPU must give the
JAX driver's hitters on the same points and keys, and the counts of an
interval oracle in u64 space (cases of the JAX suite's
``test_covid_crawl_end_to_end``).  The port's ``bin/mesh`` runs a covid
config end to end, its counts equal to ``chip_smoke.plaintext_counts``.
"""

import io

import numpy as np
import pytest

import chip_smoke
import torch_ref
from fuzzyheavyhitters_torch import workloads as tworkloads
from fuzzyheavyhitters_torch.bin import mesh as tmesh
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops import prg as tprg
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import config as tconfig
from fuzzyheavyhitters_torch.workloads import covid as tcovid

jcovid, jibdcf, jprg, jdriver = torch_ref.reference(
    "fuzzyheavyhitters_tpu.workloads.covid", "fuzzyheavyhitters_tpu.ops.ibdcf",
    "fuzzyheavyhitters_tpu.ops.prg", "fuzzyheavyhitters_tpu.protocol.driver")

CENTROIDS = tworkloads.CENTROIDS_CSV  # shipped, with a UTF-8 BOM


def _case_csv(path, rng, rows=400):
    """A small case file: FIPS in column 5, some rows of unknown counties
    and some too short to hold the column."""
    fips = sorted(tcovid.load_centroids(CENTROIDS))
    lines = ["case_month,res_state,state_fips,res_county,county,county_fips,age"]
    for i in range(rows):
        if i % 7 == 3:
            lines.append("2020-04,XX,99,NOWHERE,n,99999,0")
        elif i % 11 == 5:
            lines.append("2020-04,XX")
        else:
            f = fips[int(rng.integers(len(fips)))]
            lines.append(f"2020-04,ST,{f[:2]},C{i},c, {f} ,{i % 90}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("fuzz", [None, 8.0])
@pytest.mark.parametrize("branch", ["fallback", "case_csv"])
def test_sample_covid_locations_matches_jax(tmp_path, branch, fuzz):
    case = str(tmp_path / "absent.csv")
    if branch == "case_csv":
        case = _case_csv(tmp_path / "cases.csv", np.random.default_rng(5))
    for seed in (0, 7):
        want = jcovid.sample_covid_locations(case, CENTROIDS, 300, fuzz_factor=fuzz,
                                             seed=seed)
        got = tcovid.sample_covid_locations(case, CENTROIDS, 300, fuzz_factor=fuzz,
                                            rng=np.random.default_rng(seed))
        assert got.shape == (300, 2, 64) and got.dtype == bool
        np.testing.assert_array_equal(got, want)
        # a seed in place of a generator draws the same points
        np.testing.assert_array_equal(
            tcovid.sample_covid_locations(case, CENTROIDS, 300, fuzz_factor=fuzz, rng=seed),
            want)
    if branch == "case_csv":
        with pytest.raises(ValueError, match="valid samples"):
            tcovid.sample_covid_locations(case, CENTROIDS, 10_000, rng=0)


@pytest.mark.parametrize("value", [0.0, -0.0, 90.0, -90.0, -97.74, -180.0, 1e-310])
def test_f64_bit_codec_matches_jax(value):
    got = tcovid.f64_to_bool_vec(value)
    np.testing.assert_array_equal(got, jcovid.f64_to_bool_vec(value))
    back = tcovid.bool_vec_to_f64(got)
    assert back == jcovid.bool_vec_to_f64(got) == value
    assert np.signbit(back) == np.signbit(value)


def test_centroids_and_jitter_match_jax():
    got, want = tcovid.load_centroids(CENTROIDS), jcovid.load_centroids(CENTROIDS)
    assert got == want and all(k.isdigit() for k in got)  # the BOM is not in a key
    for lat, lon in ((30.26, -97.74), (64.8, -147.7), (89.99, 179.99)):
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        assert tcovid.uniform_in_square(lat, lon, 8.0, a) == \
            jcovid.uniform_in_square(lat, lon, 8.0, b)


def _oracle(pts, ball, threshold):
    """Hitters by a direct interval test on the u64 patterns (saturating
    ball per dim), as the JAX suite's covid crawl test checks them."""
    n = pts.shape[0]
    ints = [[int("".join("1" if b else "0" for b in pts[i, d]), 2) for d in range(2)]
            for i in range(n)]
    top = (1 << 64) - 1
    lo = [[max(0, v - ball) for v in row] for row in ints]
    hi = [[min(top, v + ball) for v in row] for row in ints]
    cand = {(x + dx, y + dy) for x, y in ints for dx in range(-ball, ball + 1)
            for dy in range(-ball, ball + 1)
            if 0 <= x + dx <= top and 0 <= y + dy <= top}
    thresh = max(1, int(threshold * n))
    want = {}
    for x, y in cand:
        c = sum(lo[i][0] <= x <= hi[i][0] and lo[i][1] <= y <= hi[i][1] for i in range(n))
        if c >= thresh:
            want[(x, y)] = c
    return want


@pytest.fixture
def bit_mode(request, monkeypatch):
    monkeypatch.setattr(jprg, "DERIVED_BITS", request.param)
    monkeypatch.setattr(tprg, "DERIVED_BITS", request.param)
    return request.param


@pytest.mark.parametrize("bit_mode", [False, True], indirect=True)
def test_covid_crawl_matches_jax_driver(tmp_path, bit_mode):
    cpath = tmp_path / "county_centroids.csv"
    cpath.write_text("fips_code,latitude,longitude\n"
                     "01001,32.53,-86.64\n06037,34.05,-118.24\n48453,30.26,-97.74\n")
    n, L, ball, threshold = 24, 64, 1, 0.2
    pts = tcovid.sample_covid_locations(str(tmp_path / "absent.csv"), str(cpath), n,
                                        fuzz_factor=None, rng=3)
    np.testing.assert_array_equal(pts, jcovid.sample_covid_locations(
        str(tmp_path / "absent.csv"), str(cpath), n, fuzz_factor=None, seed=3))
    k0, k1 = jibdcf.gen_l_inf_ball(pts, ball, np.random.default_rng(4), engine="np")
    jres = jdriver.Leader(*jdriver.make_servers(k0, k1), n_dims=2, data_len=L,
                          f_max=64, min_bucket=64).run(nreqs=n, threshold=threshold)
    ts = tdriver.make_servers(tibdcf.keys_from_numpy(k0, "cpu"),
                              tibdcf.keys_from_numpy(k1, "cpu"))
    tres = tdriver.Leader(*ts, n_dims=2, data_len=L, f_max=64).run(
        nreqs=n, threshold=threshold)
    np.testing.assert_array_equal(tres.paths, jres.paths)
    np.testing.assert_array_equal(tres.counts, np.asarray(jres.counts, np.int64))
    got = {tuple(int(v) for v in row): int(c)
           for row, c in zip(tres.decode_ints(), tres.counts)}
    assert got == _oracle(pts, ball, threshold)
    assert len(got) >= 3 * 9  # every hot county with its 3 x 3 ulp ball
    lats = {round(tcovid.bool_vec_to_f64(tbits.int_to_bits(64, x)), 2) for x, _ in got}
    assert lats == {32.53, 34.05, 30.26}
    # the smoke script's recount decodes 64-bit paths without truncation
    np.testing.assert_array_equal(chip_smoke.plaintext_counts(pts, ball, tres.paths),
                                  tres.counts)


def test_mesh_binary_cpu_covid(tmp_path):
    raw = dict(data_len=64, n_dims=2, ball_size=1, addkey_batch_size=100, num_sites=20,
               threshold=0.01, zipf_exponent=1.03, server0="127.0.0.1:8000",
               server1="127.0.0.1:8001", distribution="covid")
    n = 40
    run = tmesh.run(tconfig.Config(**raw), n, device="cpu", seed=9,
                    csv_path=str(tmp_path / "hh.csv"), out=io.StringIO())
    # bin/mesh draws the points first from its seed: the JAX sampler's points
    np.testing.assert_array_equal(run.points, jcovid.sample_covid_locations(
        tworkloads.COVID_CSV, CENTROIDS, n, fuzz_factor=float(tworkloads.AUG_LEN), seed=9))
    res = run.result
    # threshold 1 client: every client's jittered point and its ulp ball
    assert res.paths.shape[0] >= n * 9 // 2
    np.testing.assert_array_equal(res.counts, chip_smoke.plaintext_counts(
        run.points, 1, res.paths))
    assert res.decode_ints().dtype == object
    assert set(tuple(int(v) for v in row) for row in res.decode_ints()) == set(
        _oracle(run.points, 1, 0.01))


@pytest.mark.parametrize("L", [16, 62])
def test_plaintext_recount_paths_agree(L):
    """``chip_smoke.plaintext_counts`` counts in int64 up to L = 62 and in
    Python integers past it: both give the same counts on the same points
    and hitters (the Python-integer path sees them behind 64 - L leading
    zero bits), and both equal a per-client count of |v - x| <= ball in
    every dimension, with clients at both ends of the range."""
    rng = np.random.default_rng(L)
    n, d, ball, top = 400, 2, 3, (1 << L) - 1
    vals = rng.integers(0, top, size=(n, d), endpoint=True)
    vals[:20] = rng.integers(0, ball, size=(20, d), endpoint=True)
    vals[20:40] = top - rng.integers(0, ball, size=(20, d), endpoint=True)
    hits = np.clip(vals[rng.choice(n, 60)] + rng.integers(-ball - 1, ball + 1, size=(60, d),
                                                           endpoint=True), 0, top)
    bits = lambda v: ((v[..., None] >> np.arange(L - 1, -1, -1)) & 1).astype(bool)
    pad = lambda b: np.concatenate([np.zeros(b.shape[:-1] + (64 - L,), bool), b], axis=-1)
    want = (np.abs(vals[None] - hits[:, None]) <= ball).all(-1).sum(1)
    assert want.max() > 1
    np.testing.assert_array_equal(chip_smoke.plaintext_counts(bits(vals), ball, bits(hits)), want)
    np.testing.assert_array_equal(
        chip_smoke.plaintext_counts(pad(bits(vals)), ball, pad(bits(hits))), want)
