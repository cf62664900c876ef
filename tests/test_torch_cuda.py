"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips.  This file
imports no JAX (the machine with the card has none), so on that machine run
it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fuzzyheavyhitters_torch.ops import expand_cuda, gc, gc_cuda, keygen_cuda, otext_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=shape).astype(np.int32))


@pytest.mark.parametrize("derived", [False, True])
def test_keygen_kernel_equals_plain(cuda, derived):
    rng = np.random.default_rng(11)
    K, L = 1000, 37  # K not a multiple of the block
    seeds = _ints(rng, (K, 2, 4))
    alpha = torch.from_numpy(rng.integers(0, 2, size=(K, L)).astype(bool))
    side = torch.from_numpy(rng.integers(0, 2, size=K).astype(bool))
    want = keygen_cuda.gen_cw_plain(seeds, alpha, side, derived)
    before = keygen_cuda.LAUNCHES
    got = keygen_cuda.gen_cw(seeds.to(cuda), alpha.to(cuda), side.to(cuda), derived)
    torch.cuda.synchronize()
    assert keygen_cuda.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("derived", [False, True])
@pytest.mark.parametrize("K,L", [(1, 509), (127, 16), (8191, 509), (300, 64), (129, 8)])
def test_keygen_kernel_equals_plain_off_tile(cuda, derived, K, L):
    """Odd key counts (a block part full, a lone key) and level counts that
    end in a short tile, or fill whole tiles, of the kernel's 16 levels."""
    rng = np.random.default_rng(K + L)
    seeds = _ints(rng, (K, 2, 4))
    alpha = torch.from_numpy(rng.integers(0, 2, size=(K, L)).astype(bool))
    side = torch.from_numpy(rng.integers(0, 2, size=K).astype(bool))
    want = keygen_cuda.gen_cw_plain(seeds, alpha, side, derived)
    # alpha as a view at an odd byte offset: the wrapper realigns it
    alpha_odd = torch.zeros(K * L + 1, dtype=torch.bool, device=cuda)[1:].view(K, L)
    alpha_odd.copy_(alpha.to(cuda))
    got = keygen_cuda.gen_cw(seeds.to(cuda), alpha_odd, side.to(cuda), derived)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("derived", [False, True])
@pytest.mark.parametrize("d2,want_children", [(2, True), (4, True), (6, False)])
def test_expand_kernel_equals_plain(cuda, derived, d2, want_children):
    rng = np.random.default_rng(12)
    F, N = 5, 777
    B = F * N
    args = (_ints(rng, (4, d2, B)),
            torch.from_numpy(rng.integers(0, 2, size=(d2, B)).astype(bool)),
            torch.from_numpy(rng.integers(0, 2, size=(d2, B)).astype(bool)),
            _ints(rng, (4, d2, N)),
            torch.from_numpy(rng.integers(0, 16, size=(d2, N)).astype(np.uint8)))
    want = expand_cuda.expand_packed_plain(*args, derived, want_children)
    got = expand_cuda.expand_packed(*(a.to(cuda) for a in args), derived, want_children)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert torch.equal(a.cpu(), b)


def test_wrappers_reject_bad_inputs(cuda):
    seeds = torch.zeros((4, 2, 4), dtype=torch.int32, device=cuda)
    alpha = torch.zeros((4, 6), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        keygen_cuda.gen_cw(seeds, alpha, torch.zeros(4, dtype=torch.bool))  # mixed devices
    with pytest.raises(ValueError):
        keygen_cuda.gen_cw(seeds.float(), alpha, torch.zeros(4, dtype=torch.bool, device=cuda))


def _planes(rng, rows, n, bits=False):
    if bits:
        return torch.from_numpy(rng.integers(0, 2, size=(rows, n)).astype(np.int32))
    return _ints(rng, (rows, n))


def _ot2s_inputs(rng, B, S, W):
    s = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s[0] |= 1
    bits = lambda: torch.from_numpy(rng.integers(0, 2, size=(B, S)).astype(bool))
    return (_ints(rng, (B, S, 4)), s, bits(), _ints(rng, (B, W)), _ints(rng, (B, W)),
            _ints(rng, (B, S, 4)), bits())


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_ot2s_kernels_equal_plain(cuda, S, W):
    """The encrypt and decrypt kernels on test-major rows at a B that is not
    a whole planar block (pad tests in the table) nor a whole number of
    256-thread blocks, the pad index wrapping, the table raveled, as planes
    and test-major: one launch a call."""
    rng = np.random.default_rng(13 + S + W)
    B = 8192 + 777
    idx0 = 2**32 - 1000  # the pad index wraps inside the batch
    q, s, x, mv0, mv1, t, y = _ot2s_inputs(rng, B, S, W)
    want = otext_cuda.enc_planar_plain(q, s, x, mv0, mv1, idx0)
    on = lambda *a: tuple(v.to(cuda) if torch.is_tensor(v) else v for v in a)
    before = otext_cuda.ENC_LAUNCHES
    got = otext_cuda.enc_planar(*on(q, s, x, mv0, mv1), idx0)
    torch.cuda.synchronize()
    assert otext_cuda.ENC_LAUNCHES == before + 1
    assert got.shape == ((1 << S) * W * 2 * 8192,)
    assert torch.equal(got.cpu(), want)
    want = otext_cuda.dec_planar_plain(t, y, want, idx0)
    planes = got.reshape((1 << S) * W, -1)
    for table in (got, planes, planes.reshape(1 << S, W, -1).permute(0, 2, 1)):
        before = otext_cuda.DEC_LAUNCHES
        pay = otext_cuda.dec_planar(*on(t, y), table, idx0)
        torch.cuda.synchronize()
        assert otext_cuda.DEC_LAUNCHES == before + 1
        assert torch.equal(pay.cpu(), want), f"table {table.shape}"


@pytest.mark.parametrize("S", [2, 4, 6, 8, 16, 3, 5, 15])
@pytest.mark.parametrize("W", [4, 8])
def test_gc_kernels_equal_plain(cuda, S, W):
    rng = np.random.default_rng(17 + S + W)
    n = 8192 + 333
    idx0 = 2**32 - 1000
    R = [int(v) for v in rng.integers(0, 2**32, size=4)]
    R[0] |= 1
    args = (_planes(rng, 4 * S, n), _planes(rng, 4 * S, n), _planes(rng, S, n, True),
            _planes(rng, 1, n, True), _planes(rng, W, n), _planes(rng, W, n))
    want = gc.garble_planar_plain(R, *args, idx0)
    before = gc_cuda.GARBLE_LAUNCHES
    got = gc_cuda.garble_planar(R, *(a.to(cuda) for a in args), idx0)
    torch.cuda.synchronize()
    assert gc_cuda.GARBLE_LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    tab, gbl, dec, cts = want
    evl = _planes(rng, 4 * S, n)
    want = gc.eval_planar_plain(gbl, evl, tab, dec, cts, idx0)
    got = gc_cuda.eval_planar(*(a.to(cuda) for a in (gbl, evl, tab, dec, cts)), idx0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("S", [1, 17])
def test_gc_kernels_refuse_untaken_widths(cuda, S):
    """S is a kernel argument bounded by the labels' shared memory: the
    wrappers refuse a width outside 2..16 before any launch."""
    rng = np.random.default_rng(23)
    n = 1000
    args = (_planes(rng, 4 * S, n), _planes(rng, 4 * S, n), _planes(rng, S, n, True),
            _planes(rng, 1, n, True), _planes(rng, 4, n), _planes(rng, 4, n))
    before = gc_cuda.GARBLE_LAUNCHES
    with pytest.raises(ValueError, match="compiled for S in"):
        gc_cuda.garble_planar([1, 2, 3, 4], *(a.to(cuda) for a in args), 0)
    assert gc_cuda.GARBLE_LAUNCHES == before


def test_two_processes_build_on_an_empty_build_dir(cuda, tmp_path):
    """Two processes started together on an empty FHH_TORCH_BUILD_DIR (two
    servers of the socket deployment): both load the kernel and read a
    whole compiler log."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from fuzzyheavyhitters_torch.ops import cuda_build as b; b.load('expand'); "
            "print(b.log_path('expand').read_text().count('registers'))")
    env = dict(os.environ, FHH_TORCH_BUILD_DIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(int(o.split()[-1]) >= 1 for o in outs), outs
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_cw_windows_upload_equals_the_host_slices(cuda):
    """Windows copied through the two pinned staging buffers on a side
    stream arrive intact, also when a buffer is refilled (third window)."""
    from fuzzyheavyhitters_torch.ops.ibdcf import HostKeys
    from fuzzyheavyhitters_torch.protocol import driver

    rng = np.random.default_rng(5)
    L, d2, N = 10, 4, 333
    keys = HostKeys(key_idx=torch.zeros((N, 2, 2), dtype=torch.bool),
                    root_seed=_ints(rng, (N, 2, 2, 4)), cws=_ints(rng, (L, 4, d2, N)),
                    cwf=torch.from_numpy(rng.integers(0, 16, size=(L, d2, N)).astype(np.uint8)))
    up = driver.CwWindows(keys, 4, cuda)
    for level in list(range(L)) + [1, 9]:  # a window taken up again after a later one
        cws, cwf = up.at(level)
        assert cws.device.type == "cuda"
        assert torch.equal(cws.cpu(), keys.cws[level]) and torch.equal(cwf.cpu(), keys.cwf[level])


def test_streamed_crawl_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The streamed crawl (host keys, windows, chunked re-expanding
    advance) on the card, and its resume from a checkpoint, give the CPU
    run's hitters."""
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver

    rng = np.random.default_rng(9)
    N, L = 3000, 40
    pts = np.zeros((N, 1, L), bool)
    pts[:, 0] = rng.integers(0, 2, size=(8, L)).astype(bool)[rng.integers(0, 8, N)]

    def leader(dev):
        h = ibdcf.gen_l_inf_ball_host(pts, 2, np.random.default_rng(1), device=dev, chunk=1024)
        return driver.Leader(*driver.make_servers(*h, dev), n_dims=1, data_len=L, f_max=64,
                             stream_chunk=4, stream_window=16, min_bucket=8)

    want = leader("cpu").run(N, 0.05)
    assert want.paths.shape[0] > 0
    got = leader(cuda).run(N, 0.05)
    first, path = leader(cuda), str(tmp_path / "c.npz")
    write = first.checkpoint

    class Stop(Exception):
        pass

    def stop_after(*a):
        write(*a)
        raise Stop

    first.checkpoint = stop_after
    with pytest.raises(Stop):
        first.run(N, 0.05, checkpoint_path=path, checkpoint_every=16)
    resumed = leader(cuda).run(N, 0.05, checkpoint_path=path, resume=True)
    for res in (got, resumed):
        np.testing.assert_array_equal(res.paths, want.paths)
        np.testing.assert_array_equal(res.counts, want.counts)


@pytest.mark.parametrize("d,r", [(1, 2), (1, 3), (2, 2)])
def test_fused_radix_level_on_the_card_equals_the_cpu(cuda, d, r):
    """A fused level (r passes of the expand kernel) on the card: the radix
    word and the child cache of the CPU build, r launches; and the fused
    crawl's hitters equal the CPU's."""
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import collect, driver

    rng = np.random.default_rng(d * 10 + r)
    N, L, F = 333, 7, 5
    pts = np.zeros((N, d, L), bool)
    pts[:] = rng.integers(0, 2, size=(4, d, L)).astype(bool)[rng.integers(0, 4, N)]
    keys = ibdcf.gen_l_inf_ball(pts, 1, np.random.default_rng(1), device="cpu")
    st = ibdcf.EvalState(seed=_ints(rng, (4, d, 2, F, N)),
                         bit=torch.from_numpy(rng.integers(0, 2, (d, 2, F, N)).astype(bool)),
                         y_bit=torch.from_numpy(rng.integers(0, 2, (d, 2, F, N)).astype(bool)))
    fr = collect.Frontier(states=st, alive=torch.arange(F) < F - 1)
    on = lambda x: type(x)(*(a.to(cuda) for a in x))
    want = collect.expand_share_bits_radix(keys[0], fr, 1, r)
    before = expand_cuda.LAUNCHES
    got = collect.expand_share_bits_radix(on(keys[0]), collect.Frontier(on(st), fr.alive.to(cuda)),
                                          1, r)
    torch.cuda.synchronize()
    assert expand_cuda.LAUNCHES == before + r
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].seed.cpu(), want[1].seed)
    assert torch.equal(got[1].flags.cpu(), want[1].flags)
    lead = lambda ks: driver.Leader(*driver.make_servers(*ks), n_dims=d, data_len=L, f_max=64,
                                    radix=r)
    cpu_res = lead(keys).run(N, 0.1)
    assert cpu_res.paths.shape[0] > 0
    card_res = lead([on(k) for k in keys]).run(N, 0.1)
    np.testing.assert_array_equal(card_res.paths, cpu_res.paths)
    np.testing.assert_array_equal(card_res.counts, cpu_res.counts)


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_test_major_ot2s_entry_equals_plain(cuda, S, W):
    """``secure.ot2s_encrypt`` / ``ot2s_decrypt`` (the mesh's 1-of-2^S
    entries: one launch of each kernel over B tests, no pad tests) and the
    packed entries on the card against the plain test-major versions on
    the CPU, at a B that is not a whole planar block."""
    from fuzzyheavyhitters_torch.protocol import secure

    rng = np.random.default_rng(31 + S + W)
    B, idx0 = 5000, 2**32 - 700
    q, s, x, mv0, mv1, _, _ = _ot2s_inputs(rng, B, S, W)
    y = x.clone()
    y[::3] = torch.from_numpy(rng.integers(0, 2, size=y[::3].shape).astype(bool))
    t = q ^ torch.where(y[..., None], torch.from_numpy(s.view(np.int32)), 0)
    want = otext_cuda.ot2s_encrypt(q, otext_cuda.offsets(s, S, "cpu"), x, mv0, mv1, W, idx0)
    before = (otext_cuda.ENC_LAUNCHES, otext_cuda.DEC_LAUNCHES)
    got = secure.ot2s_encrypt(q.to(cuda), s, x.to(cuda), mv0.to(cuda), mv1.to(cuda), W, idx0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    tf = t.clone()
    tf[:, 0, 1] ^= secure._OT2S_DOMAIN  # the plain decrypt takes the domain folded
    want_pay = otext_cuda.ot2s_decrypt(tf, y, want, W, idx0)
    pay = secure.ot2s_decrypt(t.to(cuda), y.to(cuda), got, W, idx0)
    pay2 = secure.ot2s_decrypt(t.to(cuda), y.to(cuda), got.contiguous(), W, idx0)
    torch.cuda.synchronize()
    assert (otext_cuda.ENC_LAUNCHES, otext_cuda.DEC_LAUNCHES) == (before[0] + 1, before[1] + 2)
    assert torch.equal(pay.cpu(), want_pay) and torch.equal(pay2.cpu(), want_pay)
    eq = (x == y).all(1)[:, None]
    assert torch.equal(want_pay, torch.where(eq, mv1, mv0))
    msg = secure.ot2s_encrypt_packed(q.to(cuda), s, x.to(cuda), mv0.to(cuda), mv1.to(cuda), W,
                                     idx0)
    assert torch.equal(msg.cpu(), otext_cuda.enc_planar_plain(q, s, x, mv0, mv1, idx0))
    pay = secure.ot2s_decrypt_packed(t.to(cuda), y.to(cuda), msg, W, idx0)
    assert torch.equal(pay.cpu(), want_pay)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("W", [4, 8])
def test_k2_and_delta_gc_entries_equal_plain(cuda, S, W):
    """K2 (``gc.garble_equality_payload`` / ``eval_equality_payload``) and
    the mesh's delta pair on the card against the plain test-major twins
    on the CPU; one garble and one eval launch each."""
    rng = np.random.default_rng(41 + S + W)
    B, idx0 = 4000, 2**32 - 300
    R = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    R[0] |= 1
    seed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    Y0 = _ints(rng, (B, S, 4))
    x = torch.from_numpy(rng.integers(0, 2, size=(B, S)).astype(bool))
    y = x.clone()
    y[::4] = ~y[::4]
    evl = Y0 ^ torch.where(y[..., None], torch.from_numpy(R.view(np.int32)), 0)
    mv0, mv1 = _ints(rng, (B, W)), _ints(rng, (B, W))
    on = lambda *a: [t.to(cuda) for t in a]
    wb, wcts, wmask = gc._garble_equality_payload_plain(R, Y0, seed, x, mv0, mv1, W, idx0)
    we, wpay = gc._eval_equality_payload_plain(wb, evl, wcts, W, idx0)
    before = (gc_cuda.GARBLE_LAUNCHES, gc_cuda.EVAL_LAUNCHES)
    Yc, xc, m0c, m1c, evc = on(Y0, x, mv0, mv1, evl)
    b, cts, mask = gc.garble_equality_payload(R, Yc, seed, xc, m0c, m1c, W, idx0)
    e, pay = gc.eval_equality_payload(b, evc, cts, W, idx0)
    torch.cuda.synchronize()
    assert (gc_cuda.GARBLE_LAUNCHES, gc_cuda.EVAL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for got, want in zip((*b, cts, mask, e, pay), (*wb, wcts, wmask, we, wpay)):
        assert torch.equal(got.cpu(), want)
    db, dmask = gc.garble_equality_delta(R, Yc, seed, xc)
    de = gc.eval_equality(db, evc)
    torch.cuda.synchronize()
    assert (gc_cuda.GARBLE_LAUNCHES, gc_cuda.EVAL_LAUNCHES) == (before[0] + 2, before[1] + 2)
    for got, want in zip((*db, dmask, de), (*wb, wmask, we)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("secure", [False, True])
def test_mesh_on_logical_card_shards_equals_the_cpu(cuda, secure):
    """A 2 × 4 mesh of logical shards on the card: the hitters of the same
    mesh on CPU shards, 8 expand launches a level and, secure, 4 launches
    of each ot2s kernel a level."""
    import random

    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.parallel import mesh as meshmod
    from fuzzyheavyhitters_torch.protocol import driver

    rng = np.random.default_rng(5)
    N, L, d = 400, 8, 2
    pts = rng.integers(0, 2, size=(6, d, L)).astype(bool)[rng.integers(0, 6, N)]
    keys = ibdcf.gen_l_inf_ball(pts, 1, np.random.default_rng(2), device="cpu")
    mat = driver.session_material(random.Random(4)) if secure else None

    def crawl(dev, ks):
        r = meshmod.MeshRunner(meshmod.make_mesh(devices=[dev] * 8), *ks, f_max=64,
                               secure_exchange=secure, session=mat)
        return meshmod.MeshLeader(r).run(N, 0.05)

    want = crawl(torch.device("cpu"), keys)
    assert want.paths.shape[0] > 0
    before = (expand_cuda.LAUNCHES, otext_cuda.ENC_LAUNCHES, otext_cuda.DEC_LAUNCHES)
    on = lambda k: type(k)(*(a.to(cuda) for a in k))
    got = crawl(cuda, [on(k) for k in keys])
    np.testing.assert_array_equal(got.paths, want.paths)
    np.testing.assert_array_equal(got.counts, want.counts)
    after = (expand_cuda.LAUNCHES, otext_cuda.ENC_LAUNCHES, otext_cuda.DEC_LAUNCHES)
    k = 4 if secure else 0
    assert [a - b for a, b in zip(after, before)] == [8 * L, k * L, k * L]


@pytest.mark.parametrize("path", ["ot2s", "gc"])
@pytest.mark.parametrize("last", [False, True], ids=["fe62", "f255"])
def test_k3_shards_on_the_card_equal_the_plain_and_the_whole_level(cuda, path, last):
    """K3 (``parallel/kernel_shard.py``) on four logical shards of the card:
    each shard's kernels give what their plain versions give on CPU shards
    (the same u matrix, frame and b2a values), one launch of each of the
    path's kernels a shard, and the k = 4 wire is the whole-level path's
    (k = 1) on the card, byte for byte."""
    from fuzzyheavyhitters_torch.ops import otext
    from fuzzyheavyhitters_torch.ops.fields import F255, FE62
    from fuzzyheavyhitters_torch.parallel import kernel_shard
    from fuzzyheavyhitters_torch.parallel.server_mesh import Sharded
    from fuzzyheavyhitters_torch.protocol import secure
    from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

    rng = np.random.default_rng(21)
    B, S = 4 * kernel_shard.BLOCK - 1234, 4
    field = F255 if last else FE62
    x = rng.integers(0, 2, (B, S)).astype(bool)
    y = np.where(rng.random((B, 1)) < 0.5, x, rng.integers(0, 2, (B, S)).astype(bool))
    s = rng.integers(0, 2, 128).astype(bool)
    s[0] = True
    seeds0, seeds1 = (rng.integers(0, 2**32, size=(128, 4), dtype=np.uint32) for _ in range(2))
    chosen = np.where(s[:, None], seeds1, seeds0)
    seeds = (np.array([1, 2, 3, 4], np.uint32), np.array([5, 6, 7, 8], np.uint32))

    def pair(dev):
        return otext.OtExtSender(s, chosen, dev), otext.OtExtReceiver(seeds0, seeds1, dev)

    def sharded(dev):
        ks = kernel_shard.KernelShard(devices=(dev,) * 4, B=B, S=S)
        flat = lambda a: Sharded([torch.from_numpy(np.concatenate(
            [a, np.zeros((ks.bp - B, S), bool)])[j * ks.bloc:(j + 1) * ks.bloc].copy()).to(dev)
            for j in range(4)], 0)
        return kernel_shard.run_level_pair(ks, *pair(dev), flat(x), flat(y), *seeds, field, 1,
                                           path)

    counters = ((otext_cuda, "ENC_LAUNCHES"), (otext_cuda, "DEC_LAUNCHES")) if path == "ot2s" \
        else ((gc_cuda, "GARBLE_LAUNCHES"), (gc_cuda, "EVAL_LAUNCHES"))
    want = sharded(torch.device("cpu"))
    before = [getattr(m, c) for m, c in counters]
    got = sharded(cuda)
    torch.cuda.synchronize()
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [4, 4]
    assert np.array_equal(got[0], want[0]) and got[1].tobytes() == want[1].tobytes()
    for g, w in zip(got[2:], want[2:]):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
    snd, rcv = pair(cuda)
    u, t, idx0 = secure.ev_step1_fused(rcv, torch.from_numpy(y).to(cuda))
    u_np = words_to_numpy(u)
    msg, _ = secure.gb_step_level(snd, words_from_numpy(u_np, cuda), torch.from_numpy(x).to(cuda),
                                  *seeds, field, 1, path)
    assert np.array_equal(u_np, got[0]) and words_to_numpy(msg).tobytes() == got[1].tobytes()
