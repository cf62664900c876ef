"""Checkpoint and resume of the PyTorch port's in-process crawl
(``driver.Leader.run(checkpoint_path, checkpoint_every, resume)``,
``checkpoint``, ``restore``, ``_key_fingerprint``) against the JAX
package's, on the CPU, tolerance zero:

(a) the key fingerprint is byte for byte the JAX package's, from device
    keys and from host keys, and moves when any single client's cw moves
    (ball 1 against ball 2 too);
(b) a crawl stopped after its checkpoint and resumed by a fresh leader ends
    with the uninterrupted crawl's hitters: port -> port, JAX -> port, port
    -> JAX, and streaming; the file has the JAX package's keys and dtypes;
(c) every refusal leaves the live state untouched; the short-crawl cadence
    clamp; a completed crawl removes its file."""

import os

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch import workloads as tworkloads
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.protocol import driver as tdriver
from fuzzyheavyhitters_torch.utils import config as tconfig

jdriver, jibdcf = torch_ref.reference("fuzzyheavyhitters_tpu.protocol.driver",
                                      "fuzzyheavyhitters_tpu.ops.ibdcf")

L, N, T = 10, 120, 0.04
RAW = dict(data_len=L, n_dims=1, ball_size=2, addkey_batch_size=100, num_sites=12,
           threshold=T, zipf_exponent=1.03, server0="127.0.0.1:1",
           server1="127.0.0.1:2", distribution="zipf")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_PTS = {}


def _points(d=1):
    if d not in _PTS:
        rng = np.random.default_rng(6)
        if d == 1:
            _PTS[d] = tworkloads.sample_points(tconfig.Config(**RAW), N, rng)
        else:
            _PTS[d] = rng.integers(0, 2, size=(N, 2, L)).astype(bool)
    return _PTS[d]


def _keys(d=1, ball=2, seed=7):
    """The JAX package's numpy keys of both parties."""
    return jibdcf.gen_l_inf_ball(_points(d), ball, np.random.default_rng(seed), engine="np")


def _port(keys, form="device", d=1, **kw):
    tk = [tibdcf.keys_from_numpy(k, "cpu") for k in keys]
    if form == "host":
        tk = [tibdcf.host_keys(k) for k in tk]
        kw.setdefault("stream_window", 3)
        kw.setdefault("stream_chunk", 2)
    return tdriver.Leader(*tdriver.make_servers(*tk, "cpu"), n_dims=d, data_len=L, f_max=64,
                          **kw)


def _jax(keys, d=1, **kw):
    return jdriver.Leader(*jdriver.make_servers(*keys), n_dims=d, data_len=L, f_max=64, **kw)


class Stop(Exception):
    pass


def _stop_after_checkpoint(lead):
    """Make ``lead``'s first checkpoint the last thing its crawl does."""
    write = lead.checkpoint

    def checkpoint(*a, **k):
        write(*a, **k)
        raise Stop

    lead.checkpoint = checkpoint


def _run_stopped(lead, path, **kw):
    _stop_after_checkpoint(lead)
    with pytest.raises(Stop), torch_ref.installed():
        lead.run(N, T, checkpoint_path=str(path), **kw)
    assert os.path.exists(path)


def _same_result(got, want):
    assert want.paths.shape[0] > 0
    np.testing.assert_array_equal(got.paths, want.paths)
    np.testing.assert_array_equal(np.asarray(got.counts, np.int64),
                                  np.asarray(want.counts, np.int64))


_WANT = {}


def _uninterrupted():
    if "r" not in _WANT:
        with torch_ref.installed():
            _WANT["r"] = _jax(_keys()).run(N, T)
    return _WANT["r"]


# -- (a) the key fingerprint -------------------------------------------------------


@pytest.mark.parametrize("form", ["device", "host"])
@pytest.mark.parametrize("d", [1, 2])
def test_key_fingerprint_matches_jax(d, form):
    keys = _keys(d)
    with torch_ref.installed():
        want = _jax(keys, d)._key_fingerprint()
    got = _port(keys, form, d)._key_fingerprint()
    assert got.dtype == np.uint8 and got.shape == (32,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["device", "host"])
def test_key_fingerprint_moves_with_any_client(form):
    keys = _keys()
    base = _port(keys, form)._key_fingerprint()
    for client, level in ((0, L - 1), (N // 2, 3), (N - 1, L - 1)):
        k0 = keys[0]._replace(cw_seed=keys[0].cw_seed.copy())
        k0.cw_seed[client, 0, 1, level, 2] ^= np.uint32(1 << 31)
        moved = _port((k0, keys[1]), form)._key_fingerprint()
        assert not np.array_equal(moved, base)
        with torch_ref.installed():
            np.testing.assert_array_equal(moved, _jax((k0, keys[1]))._key_fingerprint())
    k1 = keys[1]._replace(cw_y_bits=keys[1].cw_y_bits.copy())
    k1.cw_y_bits[N - 1, 0, 0, L - 1, 1] ^= True
    assert not np.array_equal(_port((keys[0], k1), form)._key_fingerprint(), base)
    # ball 1 and ball 2 from one seed: the same roots, other correction words
    ball1 = _keys(ball=1)
    np.testing.assert_array_equal(ball1[0].root_seed, keys[0].root_seed)
    assert not np.array_equal(_port(ball1, form)._key_fingerprint(), base)


# -- (b) resume across packages ----------------------------------------------------


@pytest.mark.parametrize("case", ["port-port", "jax-port", "port-jax", "stream"])
def test_resume_equals_uninterrupted_crawl(case, tmp_path):
    keys = _keys()
    path = tmp_path / "crawl.npz"
    first, then = case.split("-") if "-" in case else ("stream", "stream")
    make = {"port": lambda: _port(keys), "jax": lambda: _jax(keys),
            "stream": lambda: _port(keys, "host")}
    _run_stopped(make[first](), path, checkpoint_every=4)
    with np.load(path) as z:
        assert int(z["level"]) == 3 and bool(z["planar"]) == (first != "jax")
    lead = make[then]()
    with torch_ref.installed():
        got = lead.run(N, T, checkpoint_path=str(path), checkpoint_every=4, resume=True)
    _same_result(got, _uninterrupted())
    assert not os.path.exists(path)
    if then != "jax":
        assert len(lead.timings["expand"]) == L - 4  # levels 4.. only


def test_checkpoint_file_is_the_jax_format(tmp_path):
    keys = _keys()
    paths = {who: tmp_path / f"{who}.npz" for who in ("port", "jax")}
    _run_stopped(_port(keys), paths["port"], checkpoint_every=4)
    _run_stopped(_jax(keys), paths["jax"], checkpoint_every=4)
    with np.load(paths["port"]) as zp, np.load(paths["jax"]) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype, k
        for k in ("level", "radix", "paths", "n_nodes", "last_counts", "meta", "key_fp",
                  "params", "s0_alive", "s1_alive_keys"):
            np.testing.assert_array_equal(zp[k], zj[k], err_msg=k)
        assert bool(zp["planar"]) and not bool(zj["planar"])
        for i in (0, 1):  # the JAX CPU engine's interleaved frontier, carried over
            st = tdriver.collect.states_from_numpy(jibdcf.EvalState(
                zj[f"s{i}_seed"], zj[f"s{i}_bit"], zj[f"s{i}_y_bit"]), "cpu")
            np.testing.assert_array_equal(zp[f"s{i}_seed"], st.seed.numpy().view(np.uint32))
            np.testing.assert_array_equal(zp[f"s{i}_bit"], st.bit.numpy())
            np.testing.assert_array_equal(zp[f"s{i}_y_bit"], st.y_bit.numpy())


# -- (c) refusals, cadence, removal ----------------------------------------------------


def _rewrite(path, **changes):
    with np.load(path) as z:
        blob = {k: z[k] for k in z.files}
    for k, v in changes.items():
        if v is None:
            del blob[k]
        else:
            blob[k] = v
    with open(path, "wb") as f:
        np.savez(f, **blob)


@pytest.mark.parametrize("what", ["meta", "radix", "no_key_fp", "fingerprint", "params"])
def test_restore_refusals_leave_state_untouched(what, tmp_path):
    keys = _keys()
    path = tmp_path / "crawl.npz"
    _run_stopped(_port(keys), path, checkpoint_every=4)
    lead, nreqs, thresh = _port(keys), N, T
    if what == "meta":
        lead = _port(keys, min_bucket=2)
        want = "checkpoint shape \\[1, 10, 64, 1\\] != leader shape \\[1, 10, 64, 2\\]"
    elif what == "radix":
        _rewrite(path, radix=np.int64(2))
        want = "checkpoint crawl radix 2 != leader crawl_radix_bits 1"
    elif what == "no_key_fp":
        _rewrite(path, key_fp=None)
        want = "predates the key-fingerprint format"
    elif what == "fingerprint":
        lead = _port(_keys(seed=8))
        want = "written under different key batches"
    else:
        thresh = 0.5
        want = "checkpoint crawl params"
    lead.tree_init()
    lead.run_level(0, nreqs, thresh)
    before = (lead.server0.frontier, lead.server1.frontier, lead.paths, lead.n_nodes,
              lead.server0.alive_keys)
    with pytest.raises(ValueError, match=want):
        lead.restore(str(path), nreqs, thresh)
    after = (lead.server0.frontier, lead.server1.frontier, lead.paths, lead.n_nodes,
             lead.server0.alive_keys)
    assert all(a is b for a, b in zip(before, after))
    with pytest.raises(ValueError, match=want):  # and through run(resume=True)
        lead.run(nreqs, thresh, checkpoint_path=str(path), resume=True)
    assert os.path.exists(path)


@pytest.mark.parametrize("every,want", [(64, [4]), (3, [2, 5, 8]), (1, list(range(L - 1)))])
def test_checkpoint_cadence_clamp(every, want, tmp_path):
    """min(checkpoint_every, max(1, data_len // 2)): with data_len 10 the
    default 64 still checkpoints after level 4; never after the last."""
    lead, written = _port(_keys()), []
    write = lead.checkpoint

    def checkpoint(path, level, *a):
        written.append(level)
        write(path, level, *a)

    lead.checkpoint = checkpoint
    path = tmp_path / "crawl.npz"
    res = lead.run(N, T, checkpoint_path=str(path), checkpoint_every=every)
    assert written == want
    _same_result(res, _uninterrupted())
    assert not os.path.exists(path)  # the completed crawl removed it


def test_completed_crawl_removes_its_file(tmp_path):
    keys = _keys()
    path = tmp_path / "crawl.npz"
    _run_stopped(_port(keys, "host"), path, checkpoint_every=4)
    # a finished crawl removes the file, and the next resume starts fresh
    res = _port(keys, "host").run(N, T, checkpoint_path=str(path), resume=True)
    assert not os.path.exists(path)
    _same_result(res, _uninterrupted())
    lead = _port(keys, "host")
    res = lead.run(N, T, checkpoint_path=str(path), resume=True)
    assert len(lead.timings["expand"]) == L and not os.path.exists(path)
    _same_result(res, _uninterrupted())
    assert not os.path.exists(str(path) + ".tmp")


def test_secure_crawl_refuses_a_checkpoint(tmp_path):
    sessions = tdriver.SecureSessions(snd=(), rcv=(), sec_seed=np.zeros(4, np.uint32))
    lead = _port(_keys(), secure=sessions)
    with pytest.raises(ValueError, match="OT-session state"):
        lead.run(N, T, checkpoint_path=str(tmp_path / "c.npz"))
