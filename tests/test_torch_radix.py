"""Radix-2^k level fusion of the PyTorch port (``collect``'s radix section,
``secure.child_strings_radix``, ``driver.Leader(radix=k)``) against the JAX
package on the CPU, tolerance zero:

(a) the tables — masks, string positions, subtree positions, the radix-1
    visit order, the fused pattern bits — and the ``check_radix`` refusals
    equal the JAX package's for (d, k) in {(1, 2), (1, 3), (2, 2)};
(b) the fused expand (r passes of the expand kernel's plain version): the
    radix word and the child cache equal the JAX ``expand_share_bits_radix``
    at each pair and at a tail r, and ``advance_from_children_radix`` the
    JAX advance;
(c) ``driver.Leader(radix=k)`` equals the JAX ``driver.Leader(radix=k)`` and
    the port at k = 1 on a data_len no k divides, with ``f_max`` capping the
    bucket and ``f_max`` overflowing; checkpoints resume across packages at
    one k and are refused across radices both ways; the streamed crawl and
    the in-process secure crawl refuse k > 1.

The socket deployment at radix is held in ``test_torch_radix_rpc.py``."""

import os

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.protocol import secure as tsecure

jcollect, jsecure, jdriver, jibdcf = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.collect", "fuzzyheavyhitters_tpu.protocol.secure",
    "fuzzyheavyhitters_tpu.protocol.driver", "fuzzyheavyhitters_tpu.ops.ibdcf")

PAIRS = [(1, 2), (1, 3), (2, 2)]
L, N, T = 7, 40, 0.2  # no k of PAIRS divides L


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the tables -------------------------------------------------------------


@pytest.mark.parametrize("d,k", PAIRS)
def test_tables_match_jax(d, k):
    assert tcollect.radix_subtree_nodes(k) == jcollect.radix_subtree_nodes(k)
    assert tcollect.max_dims_for_radix(k) == jcollect.max_dims_for_radix(k)
    for got, want in (
            (tcollect.pattern_masks_radix(d, k), jcollect.pattern_masks_radix(d, k)),
            (tsecure._string_positions_radix(d, k), jsecure._string_positions_radix(d, k)),
            (tcollect.radix_pattern_order(d, k), jcollect.radix_pattern_order(d, k))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for step in range(k):
        np.testing.assert_array_equal(tcollect._radix_positions(d, k, step),
                                      jcollect._radix_positions(d, k, step))
    pat = np.random.default_rng(d * 10 + k).integers(0, 1 << (d * k), size=50)
    np.testing.assert_array_equal(tcollect.pattern_to_bits_radix(pat, d, k),
                                  jcollect.pattern_to_bits_radix(pat, d, k))
    # radix 1 is the radix-1 layout
    np.testing.assert_array_equal(tcollect.pattern_masks_radix(d, 1), tcollect.pattern_masks(d))
    np.testing.assert_array_equal(tcollect.pattern_to_bits_radix(pat % (1 << d), d, 1)[:, 0],
                                  tcollect.pattern_to_bits(pat % (1 << d), d))
    np.testing.assert_array_equal(tcollect.radix_pattern_order(d, 1), np.arange(1 << d))


@pytest.mark.parametrize("d,k", [(3, 2), (2, 3), (1, 4), (1, 0), (9, 1)])
def test_check_radix_refuses_like_jax(d, k):
    with pytest.raises(ValueError) as want:
        jcollect.check_radix(d, k)
    with pytest.raises(ValueError) as got:
        tcollect.check_radix(d, k)
    assert str(got.value) == str(want.value)


# -- (b) the fused expand ---------------------------------------------------------------


def _frontier(d, F, seed):
    """A random interleaved frontier (the JAX CPU engine's layout) of F
    slots, the last one dead, and the port's plane-major copy of it."""
    rng = np.random.default_rng(seed)
    st = jibdcf.EvalState(seed=rng.integers(0, 2**32, size=(F, N, d, 2, 4), dtype=np.uint32),
                          bit=rng.integers(0, 2, size=(F, N, d, 2)).astype(bool),
                          y_bit=rng.integers(0, 2, size=(F, N, d, 2)).astype(bool))
    alive = np.arange(F) < F - 1
    port = tcollect.Frontier(states=tcollect.states_from_numpy(st, "cpu"),
                             alive=torch.from_numpy(alive))
    return jcollect.Frontier(states=st, alive=alive), port


def _points(d, seed=3):
    """N clients: three hot points of 12 clients each, the rest random."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 1 << L, size=(3, d))
    ints = np.concatenate([np.repeat(hot, 12, axis=0), rng.integers(0, 1 << L, size=(N - 36, d))])
    return ((ints[..., None] >> np.arange(L - 1, -1, -1)) & 1).astype(bool)


def _keys(d, seed=4):
    return jibdcf.gen_l_inf_ball(_points(d), 1, np.random.default_rng(seed), engine="np")


def _cache_as_jax(children, r):
    """The port's radix cache (the last pass's PlanarChildren over F·2^(r-1)
    virtual rows) in the JAX layout: seed [F, N, d, 2, 2^r, 4] and bits
    [F, N, d, 2, 2^r], subtree leaf ``dir·2^(r-1) + m``."""
    _, _, d, _, R, n = children.seed.shape
    M = 1 << (r - 1)
    F = R // M
    seed = children.seed.view(2, 4, d, 2, F, M, n).permute(4, 6, 2, 3, 0, 5, 1)
    fl = children.flags.view(d, 2, F, M, n).permute(2, 4, 0, 1, 3)  # [F, N, d, 2, M]
    bit = torch.stack([(fl >> s) & 1 for s in (0, 1)], dim=4) != 0
    y = torch.stack([(fl >> s) & 1 for s in (2, 3)], dim=4) != 0
    return (seed.reshape(F, n, d, 2, 2 * M, 4).numpy().view(np.uint32),
            bit.reshape(F, n, d, 2, 2 * M).numpy(), y.reshape(F, n, d, 2, 2 * M).numpy())


@pytest.mark.parametrize("d,k,r", [(1, 2, 2), (1, 3, 3), (2, 2, 2), (1, 3, 2)],
                         ids=["d1k2", "d1k3", "d2k2", "d1k3-tail2"])
def test_fused_expand_and_advance_match_jax(d, k, r):
    keys = _keys(d)
    tkeys = tibdcf.keys_from_numpy(keys[0], "cpu")
    jf, tf = _frontier(d, 4, seed=d * 10 + r)
    level = L - r if r < k else 1  # a tail round ends the tree
    with torch_ref.installed():
        jp, jch = jcollect.expand_share_bits_radix(keys[0], jf, level, r)
    tp, tch = tcollect.expand_share_bits_radix(tkeys, tf, level, r)
    assert tp.dtype == torch.int32 and tp.shape == (4, N)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    for got, want in zip(_cache_as_jax(tch, r), (jch.seed, jch.bit, jch.y_bit)):
        np.testing.assert_array_equal(got, np.asarray(want))
    word, none = tcollect.expand_share_bits_radix(tkeys, tf, level, r, want_children=False)
    assert none is None and torch.equal(word, tp)
    # survivors of every live slot, in several patterns each
    rng = np.random.default_rng(r)
    parent = np.sort(rng.integers(0, 3, size=6)).astype(np.int32)
    pat_bits = tcollect.pattern_to_bits_radix(rng.integers(0, 1 << (d * r), size=6), d, r)
    with torch_ref.installed():
        jfr = jcollect.advance_from_children_radix(jch, parent, pat_bits, 5, r)
    tfr = tcollect.advance_from_children_radix(
        tch, torch.from_numpy(parent.astype(np.int64)), torch.from_numpy(pat_bits), 5, r)
    inter = tcollect.to_interleaved(tfr.states)
    np.testing.assert_array_equal(inter.seed.numpy().view(np.uint32), np.asarray(jfr.states.seed))
    np.testing.assert_array_equal(inter.bit.numpy(), np.asarray(jfr.states.bit))
    np.testing.assert_array_equal(inter.y_bit.numpy(), np.asarray(jfr.states.y_bit))
    np.testing.assert_array_equal(tfr.alive.numpy(), np.asarray(jfr.alive))


@pytest.mark.parametrize("d,k", PAIRS)
def test_fused_round_is_r_radix1_levels(d, k):
    """The fused word holds, at depth t, the share bits radix 1 computes at
    level + t on the depth-t frontier: its strings agree with the JAX
    strings, and its counts with the sequential crawl's deepest counts."""
    keys = _keys(d)
    tkeys = tibdcf.keys_from_numpy(keys[0], "cpu")
    jf, tf = _frontier(d, 2, seed=5)
    tp, _ = tcollect.expand_share_bits_radix(tkeys, tf, 0, k)
    with torch_ref.installed():
        jp, _ = jcollect.expand_share_bits_radix(keys[0], jf, 0, k)
        want = np.asarray(jsecure.child_strings_radix(jp, d, k))
    np.testing.assert_array_equal(tsecure.child_strings_radix(tp, d, k).numpy(), want)
    np.testing.assert_array_equal(tsecure.child_strings_radix(tp, d, 1).numpy(),
                                  tsecure.child_strings(tp, d).numpy())


# -- (c) the in-process driver -------------------------------------------------------


def _port_leader(keys, d, k=1, f_max=64, **kw):
    tk = [tibdcf.keys_from_numpy(x, "cpu") for x in keys]
    return tdriver.Leader(*tdriver.make_servers(*tk), n_dims=d, data_len=L, f_max=f_max,
                          radix=k, **kw)


def _jax_leader(keys, d, k=1, f_max=64):
    return jdriver.Leader(*jdriver.make_servers(*keys), n_dims=d, data_len=L, f_max=f_max,
                          radix=k)


def _same(got, want):
    np.testing.assert_array_equal(got.paths, np.asarray(want.paths))
    np.testing.assert_array_equal(np.asarray(got.counts, np.int64),
                                  np.asarray(want.counts, np.int64))


# the smallest f_max each pair's crawl fits: not a power of two, so it caps a bucket
TIGHT = {1: 9, 2: 27}


@pytest.mark.parametrize("d,k", PAIRS)
def test_driver_matches_jax_and_radix1(d, k):
    keys = _keys(d)
    for f_max in (64, TIGHT[d]):
        with torch_ref.installed():
            want = _jax_leader(keys, d, k, f_max).run(N, T)
        lead = _port_leader(keys, d, k, f_max)
        got = lead.run(N, T)
        assert got.paths.shape == (TIGHT[d], d, L)
        _same(got, want)
        _same(got, _port_leader(keys, d, 1, f_max).run(N, T))
        assert len(lead.buckets) == -(-L // k)  # one round per k levels, a shorter tail
    # one slot fewer than the survivors raises, at the same round, with the same text
    with pytest.raises(ValueError) as want_err, torch_ref.installed():
        _jax_leader(keys, d, k, TIGHT[d] - 1).run(N, T)
    with pytest.raises(ValueError) as got_err:
        _port_leader(keys, d, k, TIGHT[d] - 1).run(N, T)
    assert str(got_err.value) == str(want_err.value)
    assert "surviving nodes exceed f_max" in str(got_err.value)


def test_driver_died_out_crawl_keeps_the_round_depth():
    keys = _keys(1)
    got = _port_leader(keys, 1, 3).run(N, 0.99)
    with torch_ref.installed():
        want = _jax_leader(keys, 1, 3).run(N, 0.99)
    assert got.paths.shape == np.asarray(want.paths).shape == (0, 1, 3)


class _Stop(Exception):
    pass


def _run_stopped(lead, path):
    write = lead.checkpoint

    def checkpoint(*a, **kw):
        write(*a, **kw)
        raise _Stop

    lead.checkpoint = checkpoint
    with pytest.raises(_Stop), torch_ref.installed():
        lead.run(N, T, checkpoint_path=str(path), checkpoint_every=2)


@pytest.mark.parametrize("first,then", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_checkpoint_resumes_across_packages_at_one_radix(first, then, tmp_path):
    d, k = 1, 2
    keys = _keys(d)
    make = {"port": lambda: _port_leader(keys, d, k), "jax": lambda: _jax_leader(keys, d, k)}
    path = tmp_path / "crawl.npz"
    _run_stopped(make[first](), path)
    with np.load(path) as z:  # every = min(2, L // 2): the round based at 0 ends on 2
        assert int(z["radix"]) == k and int(z["level"]) == 0
    lead = make[then]()
    with torch_ref.installed():
        got = lead.run(N, T, checkpoint_path=str(path), checkpoint_every=2, resume=True)
        want = _jax_leader(keys, d, k).run(N, T)
    _same(got, want)
    assert not os.path.exists(path)
    if then == "port":
        assert len(lead.timings["expand"]) == 3  # rounds based at 2, 4 and the tail 6


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_checkpoint_refused_across_radices(writer, reader, tmp_path):
    d = 1
    keys = _keys(d)
    path = tmp_path / "crawl.npz"
    make = {"port": lambda k: _port_leader(keys, d, k), "jax": lambda k: _jax_leader(keys, d, k)}
    _run_stopped(make[writer](2), path)
    for k in (1, 3):
        lead = make[reader](k)
        with pytest.raises(ValueError, match=f"checkpoint crawl radix 2 != leader "
                           f"crawl_radix_bits {k}"), torch_ref.installed():
            lead.run(N, T, checkpoint_path=str(path), checkpoint_every=2, resume=True)
    assert os.path.exists(path)


def test_streamed_and_secure_crawls_refuse_radix():
    keys = _keys(1)
    tk = [tibdcf.keys_from_numpy(x, "cpu") for x in keys]
    host = [tibdcf.host_keys(x) for x in tk]
    with pytest.raises(ValueError, match="streaming crawl mode pins crawl_radix_bits=1"):
        tdriver.Leader(*tdriver.make_servers(*host, "cpu"), n_dims=1, data_len=L, radix=2)
    sessions = tdriver.SecureSessions(snd=(), rcv=(), sec_seed=np.zeros(4, np.uint32))
    with pytest.raises(ValueError, match="in-process secure crawl pins crawl_radix_bits=1.*"
                       "fused secure levels run over the socket deployment"):
        tdriver.Leader(*tdriver.make_servers(*tk), n_dims=1, data_len=L, secure=sessions,
                       radix=2)
    with pytest.raises(ValueError, match="supports at most 2 dim"):
        tdriver.Leader(*tdriver.make_servers(*tk), n_dims=3, data_len=L, radix=2)
