"""The PyTorch port's sketch and Beaver checks (``protocol/sketch.py``,
``protocol/mpc.py``) against the JAX package's ``protocol/sketch.py``,
``protocol/mpc.py`` and the single-card programs of its
``parallel/sketch_shard.py``, tolerance zero: ``sketch.gen``'s 16 leaves
(d = 1 and d = 2), the challenge stream and its seek-by-offset draw, the
sketch inner products, the check state, the three server stages and their
wire frames, the Beaver triples and every MPC step in both roles, the
challenge ratchet's hashes, and ``verify_level`` — honest clients pass and
each forgery of ``tests/test_sketch.py`` (value CW, leaf MAC lane,
inconsistent MAC share, bad triple) flags the same clients as the JAX
package.  One (N, L) = (6, 5) shape, as ``tests/test_sketch.py`` uses."""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tf
from fuzzyheavyhitters_torch.protocol import mpc as tmpc
from fuzzyheavyhitters_torch.protocol import sketch as tsk

(jsk, jmpc, jf, jss) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.sketch", "fuzzyheavyhitters_tpu.protocol.mpc",
    "fuzzyheavyhitters_tpu.ops.fields", "fuzzyheavyhitters_tpu.parallel.sketch_shard")

N, L = 6, 5
wire = tsk.wire


def _leaves(sk):
    return [np.asarray(x) for x in (*sk.key, sk.mac_key, sk.mac_key2, sk.mac_key_last,
                                    sk.mac_key2_last, *sk.triples, *sk.triples_last)]


def _gen(seed=0, d=None):
    """Both packages' sketch keys on the same seeds: (jax pair, port pair,
    alpha, shared seed)."""
    rng = np.random.default_rng(seed)
    batch = (N,) if d is None else (N, d)
    alpha = rng.integers(0, 2, size=batch + (L,)).astype(bool)
    seeds = rng.integers(0, 2**32, size=batch + (2, 4), dtype=np.uint32)
    cseed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    shared = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    with torch_ref.installed():
        j = jsk.gen(seeds, alpha, jf.FE62, jf.F255, cseed)
    t = tsk.gen(seeds, alpha, tf.FE62, tf.F255, cseed, device="cpu")
    return j, t, alpha, shared


GEN = {d: _gen(d=d) for d in (None, 2)}


def _eq(got_t, want):
    got, want = wire(got_t), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [None, 2], ids=["d1", "d2"])
def test_gen_leaves_byte_equal(d):
    (j0, j1), (t0, t1), _, _ = GEN[d]
    for jp, tp in ((j0, t0), (j1, t1)):
        jl, tl = _leaves(jp), tsk.sketch_to_numpy(tp)
        assert len(tl) == 16
        for i, (a, b) in enumerate(zip(jl, tl)):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            assert a.tobytes() == b.tobytes(), i
        back = tsk.sketch_to_numpy(tsk.sketch_from_numpy(tl, "cpu"))
        assert all(a.tobytes() == b.tobytes() for a, b in zip(back, tl))


@pytest.mark.parametrize("field", ["FE62", "F255"])
def test_challenge_stream_and_its_seek(field):
    """``shared_r_stream`` equals the JAX draw, and ``challenge_r`` with
    ``challenge_rands`` at any row offset reads the same words."""
    seed = np.array([1, 2, 0xFFFFFFFF, 7], np.uint32)
    m, rows, level = 8, 10, 3
    jfield, tfield = getattr(jf, field), getattr(tf, field)
    with torch_ref.installed():
        jr, jrands = jsk.shared_r_stream(jfield, seed, level, m, rows)
        jr2 = jsk.challenge_r(jfield, seed, level, m)
        jsub = {r0: np.asarray(jsk.challenge_rands(jfield, seed, level, m, r0, 3))
                for r0 in (0, 1, 5, 7)}
    r, rands = tsk.shared_r_stream(tfield, seed, level, m, rows)
    _eq(r, jr)
    _eq(rands, jrands)
    _eq(tsk.challenge_r(tfield, seed, level, m), jr2)
    for r0, want in jsub.items():
        got = tsk.challenge_rands(tfield, seed, level, m, r0, 3)
        _eq(got, want)
        assert torch.equal(got, rands[r0:r0 + 3])


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("d", [None, 2], ids=["d1", "d2"])
def test_check_state_and_the_three_stages_match_jax(field, d):
    """A level's pair shares through ``level_check_state`` (so
    ``sketch_output`` and ``mul_state``) and the three server stages —
    the cor wire stack, the out shares of both roles, the verdicts —
    equal the JAX package's single-card programs."""
    (j0, j1), (t0, t1), _, shared = GEN[d]
    dd = 1 if d is None else d
    rng = np.random.default_rng(11)
    m, level = 4, 2
    last = field == "F255"
    jfield, tfield = getattr(jf, field), getattr(tf, field)
    w = 8 if last else 4
    pairs = [np.asarray(jfield.sample(rng.integers(0, 2**32, size=(m, N, dd, 2, w),
                                                   dtype=np.uint32))) for _ in (0, 1)]
    if last:
        picks = [(s.triples_last, s.mac_key_last, s.mac_key2_last) for s in (j0, j1)]
        tpicks = [(s.triples_last, s.mac_key_last, s.mac_key2_last) for s in (t0, t1)]
    else:
        picks = [(jmpc.level_slab(s.triples, 1), s.mac_key, s.mac_key2) for s in (j0, j1)]
        tpicks = [(tmpc.level_slab(s.triples, 1), s.mac_key, s.mac_key2) for s in (t0, t1)]
    with torch_ref.installed():
        jstate = jsk.level_check_state(jfield, pairs[0], *picks[0], shared, level, 0)
        jcor = [np.asarray(jss.cor_state(None, jfield, pairs[p], *picks[p], shared, level)[0])
                for p in (0, 1)]
        jst = [jss.cor_state(None, jfield, pairs[p], *picks[p], shared, level)[1]
               for p in (0, 1)]
        jo = [np.asarray(jss.out_shares(None, jfield, jst[p], jcor[p], jcor[1 - p], bool(p)))
              for p in (0, 1)]
        jv = np.asarray(jss.verdicts(None, jfield, jo[0], jo[1]))
    tpairs = [tsk.from_wire(p, "cpu") for p in pairs]
    tstate = tsk.level_check_state(tfield, tpairs[0], *tpicks[0], shared, level, 0)
    for name in ("xs", "ys", "zs", "rs"):
        _eq(getattr(tstate, name), getattr(jstate, name))
    tcor, tst = zip(*(tsk.cor_state(tfield, tpairs[p], *tpicks[p], shared, level)
                      for p in (0, 1)))
    to = []
    for p in (0, 1):
        _eq(tcor[p], jcor[p])
        to.append(tsk.out_shares(tfield, tst[p], tcor[p], wire(tcor[1 - p]), bool(p)))
        _eq(to[p], jo[p])
    v = tsk.verdicts(tfield, to[0], wire(to[1]))
    np.testing.assert_array_equal(v.numpy(), jv)


@pytest.mark.parametrize("field", ["FE62", "F255"])
def test_mpc_steps_match_jax(field):
    """Beaver triples from one seed, then cor_share, cor, out_share in both
    roles and verify, on honest and on broken products."""
    jfield, tfield = getattr(jf, field), getattr(tf, field)
    rng = np.random.default_rng(12)
    seed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    w = 8 if field == "F255" else 4
    samp = lambda: np.asarray(jfield.sample(rng.integers(0, 2**32, size=(5, 3, w),
                                                         dtype=np.uint32)))
    x, y, r, junk = samp(), samp(), samp(), samp()
    with torch_ref.installed():
        jt = jmpc.gen_triples(jfield, (5, jmpc.CHECKS), seed)
        z = np.asarray(jfield.neg(jfield.mul(x, y)))
        z_bad = z.copy()
        z_bad[2] = junk[2]
        zero = np.asarray(jfield.zeros((5, 3)))
        jres = {}
        for tag, zz in (("good", z), ("bad", z_bad)):
            s0 = jmpc.MulStateBatch(xs=x, ys=zero, zs=zz, rs=r, triples=jt[0])
            s1 = jmpc.MulStateBatch(xs=zero, ys=y, zs=zero, rs=r, triples=jt[1])
            c0, c1 = jmpc.cor_share(jfield, s0), jmpc.cor_share(jfield, s1)
            op = jmpc.cor(jfield, c0, c1)
            o0, o1 = jmpc.out_share(jfield, False, s0, op), jmpc.out_share(jfield, True, s1, op)
            jres[tag] = [np.asarray(a) for a in (*c0, *c1, *op, o0, o1)] + [
                np.asarray(jmpc.verify(jfield, o0, o1))]
    tt = tmpc.gen_triples(tfield, (5, tmpc.CHECKS), seed)
    for jp, tp in zip(jt, tt):
        for a, b in zip(jp, tp):
            _eq(b, a)
    T = lambda a: tsk.from_wire(a, "cpu")
    for tag, zz in (("good", z), ("bad", z_bad)):
        s0 = tmpc.MulStateBatch(xs=T(x), ys=T(zero), zs=T(zz), rs=T(r), triples=tt[0])
        s1 = tmpc.MulStateBatch(xs=T(zero), ys=T(y), zs=T(zero), rs=T(r), triples=tt[1])
        c0, c1 = tmpc.cor_share(tfield, s0), tmpc.cor_share(tfield, s1)
        op = tmpc.cor(tfield, c0, c1)
        o0, o1 = tmpc.out_share(tfield, False, s0, op), tmpc.out_share(tfield, True, s1, op)
        got = [wire(a) for a in (*c0, *c1, *op, o0, o1)] + [
            tmpc.verify(tfield, o0, o1).numpy()]
        for a, b in zip(got, jres[tag]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert jres["good"][-1].all() and jres["bad"][-1].tolist() == [True, True, False, True,
                                                                   True]


def test_ratchet_hashes_match_jax():
    """The transcript over padded survivor tables of both wire shapes, the
    level seeds and the window roots: the JAX package's bytes."""
    rng = np.random.default_rng(13)
    root = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    with torch_ref.installed():
        jd = jsk.transcript_init()
    td = tsk.transcript_init()
    assert td == jd
    for level, shape, n_alive in ((0, (4, 1), 3), (1, (8, 2), 5), (2, (8, 2, 2), 6),
                                  (4, (16, 3, 1), 16)):
        parent = np.zeros(shape[0], np.int32)
        parent[:n_alive] = rng.integers(0, 4, size=n_alive)
        pat = np.zeros(shape, bool)
        pat[:n_alive] = rng.integers(0, 2, size=(n_alive,) + shape[1:]).astype(bool)
        parent[n_alive:] = 7  # padding must not reach the digest
        with torch_ref.installed():
            jd = jsk.transcript_absorb(jd, level, parent, pat, n_alive)
            jseed = jsk.ratchet_seed(root, level, jd)
        td = tsk.transcript_absorb(td, level, parent.astype(np.int64), pat, n_alive)
        assert td == jd
        np.testing.assert_array_equal(tsk.ratchet_seed(root, level, td), jseed)
        assert tsk.ratchet_seed(root, level, td).dtype == jseed.dtype
    for window in (0, 1, 1 << 40):
        with torch_ref.installed():
            want = jsk.window_root(root, window)
        np.testing.assert_array_equal(tsk.window_root(root, window), want)


def _forge(sk, **kw):
    """Replace leaves of a sketch batch (port or JAX), the key's too."""
    key = sk.key._replace(**{k: v for k, v in kw.items() if k in sk.key._fields})
    return sk._replace(key=key, **{k: v for k, v in kw.items() if k not in sk.key._fields})


FORGERIES = ["honest", "value_cw", "leaf_mac_lane", "mac_share", "bad_triple"]


@pytest.mark.parametrize("case", FORGERIES)
def test_verify_level_flags_the_same_clients(case):
    """Each forgery of ``tests/test_sketch.py``, handed to both packages'
    ``verify_level`` at every level: the same verdict vector, and the
    forged clients caught at the level the forgery lives in."""
    (j0, j1), (t0, t1), _, shared = GEN[None]
    tl0, tl1 = tsk.sketch_to_numpy(t0), tsk.sketch_to_numpy(t1)
    if case == "value_cw":
        bad = tl0[4].copy()
        bad[2, 0, 1, 0] = (int(bad[2, 0, 1, 0]) + 5) % tf.FE62.P
        edits = ({4: bad}, {4: bad})
    elif case == "leaf_mac_lane":
        bad = tl0[5].copy()
        bad[0, 0, 1, 0] ^= 3
        edits = ({5: bad}, {5: bad})
    elif case == "mac_share":
        bad = tl0[6].copy()
        bad[[1, 4]] = tf.FE62.np_add(bad[[1, 4]], np.uint64(1))
        edits = ({6: bad}, {})
    elif case == "bad_triple":
        bad = tl0[12].copy()  # triples.c [N, 1, L-1, CHECKS]
        bad[3, 0, 2, 0] = (int(bad[3, 0, 2, 0]) + 1) % tf.FE62.P
        edits = ({12: bad}, {})
    else:
        edits = ({}, {})
    ls = [list(tl0), list(tl1)]
    for p in (0, 1):
        for i, v in edits[p].items():
            ls[p][i] = v
    tsks = [tsk.sketch_from_numpy(x, "cpu") for x in ls]
    jsks = [jsk.SketchKeyBatch(jsk.DpfKeyBatch(*x[:6]), *x[6:10], jmpc.TripleBatch(*x[10:13]),
                               jmpc.TripleBatch(*x[13:16])) for x in ls]
    caught = {}
    for level in range(L):
        with torch_ref.installed():
            want = jsk.verify_level(*jsks, level, jf.FE62, jf.F255, L, shared)
        got = tsk.verify_level(*tsks, level, tf.FE62, tf.F255, L, shared)
        np.testing.assert_array_equal(got, want, err_msg=f"level {level}")
        caught[level] = np.nonzero(~got)[0].tolist()
    expect = {"honest": {}, "value_cw": {1: [2]}, "leaf_mac_lane": {L - 1: [0]},
              "mac_share": {lv: [1, 4] for lv in range(L - 1)}, "bad_triple": {2: [3]}}[case]
    assert {lv: c for lv, c in caught.items() if c} == expect
