"""The PyTorch port's streaming crawl against the JAX package, on the CPU,
tolerance zero (the protocol is bitwise):

(a) ``collect.expand_share_bits_from_cw`` and ``advance_from_cw`` equal the
    JAX functions on the same numpy inputs (the JAX states, interleaved on
    its CPU engine, carried over by ``to_planar``), for ``node_chunk`` 1, a
    chunk that tiles the bucket, one that does not, and the whole bucket;
(b) a streamed ``driver.Leader`` (``stream_window`` 4, so windows roll
    over) equals the cached one and the JAX streamed leader level by level:
    survivors, counts, paths and frontiers;
(c) ``min_bucket`` changes no hitters; chunked host keygen gives the keys
    of one whole-batch keygen; the refusals of streaming mode; host keys
    crawl on the card unless a device is named; a streamed crawl leaves no
    frontier behind; the cw windows hand out every level."""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch import workloads as tworkloads
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.utils import config as tconfig

jcollect, jdriver, jibdcf = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.collect", "fuzzyheavyhitters_tpu.protocol.driver",
    "fuzzyheavyhitters_tpu.ops.ibdcf")

L, N = 12, 200
RAW = dict(data_len=L, n_dims=1, ball_size=2, addkey_batch_size=100, num_sites=20,
           threshold=0.015, zipf_exponent=1.03, server0="127.0.0.1:1",
           server1="127.0.0.1:2", distribution="zipf")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_KEYS = {}


def _jax_keys(d=1):
    """The JAX package's numpy keys of N zipf (d = 1) or uniform (d = 2)
    clients, and the sampled points."""
    if d not in _KEYS:
        rng = np.random.default_rng(3)
        if d == 1:
            pts = tworkloads.sample_points(tconfig.Config(**RAW), N, rng)
        else:
            pts = rng.integers(0, 2, size=(N, 2, L)).astype(bool)
            pts[: N // 2] = pts[0]  # a hot point, so the crawl keeps nodes
        _KEYS[d] = pts, jibdcf.gen_l_inf_ball(pts, 2, np.random.default_rng(4), engine="np")
    return _KEYS[d]


def _states_np(rng, F, n, d):
    """Random interleaved frontier states (the JAX CPU engine's layout)."""
    return jibdcf.EvalState(
        seed=rng.integers(0, 2**32, size=(F, n, d, 2, 4), dtype=np.uint32),
        bit=rng.integers(0, 2, size=(F, n, d, 2)).astype(bool),
        y_bit=rng.integers(0, 2, size=(F, n, d, 2)).astype(bool))


def _level_cw(keys_np, level):
    jcw = (keys_np.cw_seed[..., level, :], keys_np.cw_bits[..., level, :],
           keys_np.cw_y_bits[..., level, :])
    tcw = tcollect.level_cw_planar(tibdcf.keys_from_numpy(keys_np, "cpu"), level)
    return jcw, tcw


def _planar(states_np):
    return tcollect.states_from_numpy(
        jibdcf.EvalState(*(np.asarray(a) for a in states_np)), "cpu")


def _assert_states(got, want):
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)


# -- (a) the two entry points into the expand kernel ----------------------------


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("want_children", [True, False])
def test_expand_share_bits_from_cw_matches_jax(d, want_children):
    _, (k0, _) = _jax_keys(d)
    rng = np.random.default_rng(10 + d)
    F = 4
    st = _states_np(rng, F, N, d)
    jcw, tcw = _level_cw(k0, 7)
    with torch_ref.installed():
        jf = jcollect.Frontier(states=st, alive=np.arange(F) < 3)
        jp, jch = jcollect.expand_share_bits_from_cw(jcw, jf, want_children)
    tf = tcollect.Frontier(states=_planar(st), alive=torch.arange(F) < 3)
    tp, tch = tcollect.expand_share_bits_from_cw(tcw, tf, want_children)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    assert (tch is None) == (jch is None) == (not want_children)
    if want_children:  # [2, 4, d, 2, F, N] -> the JAX engine's [F, N, d, 2, dir, 4]
        np.testing.assert_array_equal(
            tch.seed.permute(4, 5, 2, 3, 0, 1).numpy().view(np.uint32), np.asarray(jch.seed))
        fl = tch.flags.permute(2, 3, 0, 1).numpy()
        np.testing.assert_array_equal(np.stack([fl & 1, (fl >> 1) & 1], -1).astype(bool),
                                      np.asarray(jch.bit))
        np.testing.assert_array_equal(np.stack([(fl >> 2) & 1, (fl >> 3) & 1], -1).astype(bool),
                                      np.asarray(jch.y_bit))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("node_chunk", [None, 1, 2, 3, 8], ids=lambda c: f"chunk{c}")
def test_advance_from_cw_matches_jax(d, node_chunk):
    """Bucket F' = 8 from F = 4 parents: chunk 2 tiles it, 3 does not (the
    whole bucket), 1 is one parent slot at a time."""
    _, (k0, _) = _jax_keys(d)
    rng = np.random.default_rng(20 + d)
    F, F2, n_alive = 4, 8, 6
    st = _states_np(rng, F, N, d)
    parent = np.zeros(F2, np.int32)
    parent[:n_alive] = rng.integers(0, F, n_alive)
    pat_bits = np.zeros((F2, d), bool)
    pat_bits[:n_alive] = rng.integers(0, 2, size=(n_alive, d)).astype(bool)
    jcw, tcw = _level_cw(k0, 5)
    with torch_ref.installed():
        jf = jcollect.Frontier(states=jibdcf.EvalState(*(a.copy() for a in st)),
                               alive=np.arange(F) < F)
        jout = jcollect.advance_from_cw(jcw, jf, parent, pat_bits, n_alive, node_chunk)
    tf = tcollect.Frontier(states=_planar(st), alive=torch.arange(F) < F)
    tout = tcollect.advance_from_cw(tcw, tf, torch.from_numpy(parent.astype(np.int64)),
                                    torch.from_numpy(pat_bits), n_alive, node_chunk)
    _assert_states(tout.states, _planar(jout.states))
    np.testing.assert_array_equal(tout.alive.numpy(), np.asarray(jout.alive))
    # and the cached advance gives the same frontier
    _, ch = tcollect.expand_share_bits_from_cw(tcw, tf)
    cached = tcollect.advance_from_children(ch, torch.from_numpy(parent.astype(np.int64)),
                                            torch.from_numpy(pat_bits), n_alive)
    _assert_states(tout.states, cached.states)


# -- (b) the streamed crawl ------------------------------------------------------


def _port_leader(keys_np, stream, **kw):
    tk = [tibdcf.keys_from_numpy(k, "cpu") for k in keys_np]
    if stream:
        tk = [tibdcf.host_keys(k) for k in tk]
    return tdriver.Leader(*tdriver.make_servers(*tk, "cpu"), n_dims=1, data_len=L, f_max=64,
                          **kw)


@pytest.mark.parametrize("chunk", [None, 2], ids=["whole", "chunk2"])
def test_streamed_crawl_matches_cached_and_jax_level_by_level(chunk):
    _, keys = _jax_keys(1)
    cached = _port_leader(keys, False)
    streamed = _port_leader(keys, True, stream_chunk=chunk, stream_window=4)
    with torch_ref.installed():
        jlead = jdriver.Leader(*jdriver.make_servers(*keys), n_dims=1, data_len=L, f_max=64,
                               stream=True, stream_chunk=chunk, stream_window=4)
        jlead.tree_init()
    cached.tree_init()
    streamed.tree_init()
    for level in range(L):
        n_c = cached.run_level(level, N, RAW["threshold"])
        n_s = streamed.run_level(level, N, RAW["threshold"])
        with torch_ref.installed():
            n_j = jlead.run_level(level, N, RAW["threshold"])
        assert n_c == n_s == n_j > 0
        np.testing.assert_array_equal(streamed.paths, cached.paths)
        np.testing.assert_array_equal(streamed.paths, jlead.paths)
        np.testing.assert_array_equal(streamed._last_counts, cached._last_counts)
        np.testing.assert_array_equal(streamed._last_counts, jlead._last_counts)
        if level < L - 1:
            for sc, ss, sj in zip((cached.server0, cached.server1),
                                  (streamed.server0, streamed.server1),
                                  (jlead.server0, jlead.server1)):
                _assert_states(ss.frontier.states, sc.frontier.states)
                _assert_states(ss.frontier.states, _planar(sj.frontier.states))
    assert streamed.buckets == cached.buckets and max(cached.buckets) > 1


def test_streamed_run_equals_jax_streamed_run():
    _, keys = _jax_keys(1)
    with torch_ref.installed():
        jres = jdriver.Leader(*jdriver.make_servers(*keys), n_dims=1, data_len=L, f_max=64,
                              stream=True, stream_chunk=1, stream_window=4,
                              min_bucket=4).run(N, RAW["threshold"])
    res = _port_leader(keys, True, stream_chunk=1, stream_window=4, min_bucket=4).run(
        N, RAW["threshold"])
    assert res.paths.shape[0] > 0
    np.testing.assert_array_equal(res.paths, jres.paths)
    np.testing.assert_array_equal(res.counts, np.asarray(jres.counts, np.int64))


# -- (c) min_bucket, chunked keygen, refusals --------------------------------------


@pytest.mark.parametrize("stream", [False, True], ids=["cached", "streamed"])
@pytest.mark.parametrize("min_bucket", [2, 16, 64])
def test_min_bucket_changes_no_hitters(min_bucket, stream):
    _, keys = _jax_keys(1)
    want = _port_leader(keys, False).run(N, RAW["threshold"])
    lead = _port_leader(keys, stream, min_bucket=min_bucket, stream_window=5)
    got = lead.run(N, RAW["threshold"])
    np.testing.assert_array_equal(got.paths, want.paths)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert min(lead.buckets) == min_bucket
    assert tcollect.bucket_for(3, 64, min_bucket) == max(4, min_bucket)
    assert tcollect.bucket_for(3, 64, min_bucket) == jcollect.bucket_for(3, 64, min_bucket)


@pytest.mark.parametrize("chunk", [64, 200, 512])
def test_chunked_host_keygen_equals_one_keygen(chunk):
    pts, _ = _jax_keys(2)
    whole = tibdcf.gen_l_inf_ball(pts, 2, np.random.default_rng(5), device="cpu")
    host = tibdcf.gen_l_inf_ball_host(pts, 2, np.random.default_rng(5), device="cpu",
                                      chunk=chunk)
    for k, h in zip(whole, host):
        for a, b in zip(tibdcf.host_keys(k), h, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert h.data_len == L and h.cws.shape == (L, 4, 4, N)
    assert host[0].cws is host[1].cws  # the parties share their correction words
    # one window of levels is one contiguous slice of the host keys
    assert host[0].cws[4:8].is_contiguous() and host[0].cwf[4:8].is_contiguous()


def test_stream_refusals():
    _, keys = _jax_keys(1)
    sessions = tdriver.SecureSessions(snd=(), rcv=(), sec_seed=np.zeros(4, np.uint32))
    with pytest.raises(ValueError, match="trusted exchange only"):
        _port_leader(keys, True, secure=sessions)
    tk = [tibdcf.keys_from_numpy(k, "cpu") for k in keys]
    s0, _ = tdriver.make_servers(tibdcf.host_keys(tk[0]), tibdcf.host_keys(tk[1]), "cpu")
    _, s1 = tdriver.make_servers(*tk)
    with pytest.raises(TypeError, match="HostKeys"):
        tdriver.Leader(s0, s1, n_dims=1, data_len=L)
    assert _port_leader(keys, True).stream and not _port_leader(keys, False).stream


def test_host_keys_without_a_device_need_a_card(monkeypatch):
    """Host keys carry no crawl device: with none named the crawl is the
    card's, and with no card that raises instead of crawling on the CPU."""
    _, keys = _jax_keys(1)
    tk = [tibdcf.keys_from_numpy(k, "cpu") for k in keys]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tdriver.make_servers(*(tibdcf.host_keys(k) for k in tk))
    s0, _ = tdriver.make_servers(*(tibdcf.host_keys(k) for k in tk), "cpu")
    assert s0.alive_keys.device.type == "cpu"
    s0, _ = tdriver.make_servers(*tk)  # device keys crawl where they are
    assert s0.alive_keys.device.type == "cpu"


@pytest.mark.parametrize("threshold", [RAW["threshold"], 0.9], ids=["last_level", "dies_out"])
def test_streamed_crawl_leaves_no_frontier(threshold):
    _, keys = _jax_keys(1)
    lead = _port_leader(keys, True, stream_chunk=2, stream_window=4)
    res = lead.run(N, threshold)
    assert (res.paths.shape[0] > 0) == (threshold < 0.5)
    for s in (lead.server0, lead.server1):
        assert s.frontier is None and s.children is None


def test_cw_windows_hand_out_every_level():
    """Windows roll over and are taken up again: each level's cw is the
    host keys' level."""
    _, keys = _jax_keys(1)
    h = tibdcf.host_keys(tibdcf.keys_from_numpy(keys[0], "cpu"))
    up = tdriver.CwWindows(h, 5, "cpu")
    for level in list(range(L)) + [3, L - 1, 0]:
        cws, cwf = up.at(level)
        assert torch.equal(cws, h.cws[level]) and torch.equal(cwf, h.cwf[level])
