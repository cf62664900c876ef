"""The PyTorch port's data shards of a collector server
(``parallel/server_mesh.py``) against the JAX package's
``parallel/server_mesh.py`` (its mesh on the conftest's eight virtual CPU
devices), tolerance zero:

- binding, occupancy and degradation (JAX test_multichip.py:127-139);
- the resolution of a request: auto as the JAX package, an explicit count
  taken as it is and wrapped onto the visible cards (the JAX package caps
  it at the visible devices);
- the trusted per-node counts at k in {1, 2, 4} shards equal the JAX
  ``ServerMesh``'s, and so do the secure share sums (FE62, F255) of the
  gather path, which sums the gathered values on one device;
- the key and frontier placement round-trips.

The JAX package's functions run inside ``torch_ref.installed()``."""

import numpy as np
import pytest
import torch

import fuzzyheavyhitters_tpu.ops.fields  # noqa: F401  (one fields module under every torch_ref
# load, whatever other files a worker collects: the JAX functions compare field classes by
# identity, and tests/test_fields.py imports it so in a whole run)
import torch_ref
from fuzzyheavyhitters_torch.ops import ibdcf as tibdcf
from fuzzyheavyhitters_torch.ops.fields import F255, FE62
from fuzzyheavyhitters_torch.parallel import server_mesh as tsm
from fuzzyheavyhitters_torch.protocol import collect as tcollect
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import bits as tbits
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

(jsm, jfields) = torch_ref.reference("fuzzyheavyhitters_tpu.parallel.server_mesh",
                                     "fuzzyheavyhitters_tpu.ops.fields")

CPU = torch.device("cpu")


def test_shard_binding_degrades_as_the_jax_mesh():
    f = tsm._largest_divisor_leq
    assert (f(12, 4), f(12, 8), f(13, 8), f(12, 1)) == (4, 6, 1, 1)
    for n in (1, 2, 7, 12, 64, 97, 100000):
        for k in range(0, 10):
            assert f(n, k) == jsm._largest_divisor_leq(n, k)
    m = tsm.ServerMesh(4, "cpu").bind(6)
    assert m.shards == 3 and m.occupancy() == [2, 2, 2] and m.spans() == [(0, 2), (2, 4), (4, 6)]
    m.bind(12)
    assert m.shards == 4 and m.occupancy() == [3, 3, 3, 3]
    m.bind(13)
    assert m.shards == 1 and m.occupancy() == [13]
    assert tsm.ServerMesh(4, "cpu").occupancy() == []
    with torch_ref.installed():
        jm = jsm.ServerMesh(4).bind(6)
        assert (jm.shards, jm.occupancy()) == (3, [2, 2, 2])
    # the kernel budget follows the bound shards and caps a request at them
    m.bind(12)
    assert (m.kernel_budget(0), m.kernel_budget(2), m.kernel_budget(9)) == (4, 2, 4)


def test_requests_resolve_and_wrap_onto_the_visible_cards(monkeypatch):
    """0 is auto (1 on the CPU, as the JAX package on a CPU host); an
    explicit count is kept — JAX caps it at its visible devices — and its
    shards wrap round-robin onto the visible cards from the server's own."""
    with torch_ref.installed():
        assert jsm.resolve_data_devices(4) == tsm.resolve_data_devices(4, "cpu") == 4
        assert jsm.resolve_data_devices(0) == tsm.resolve_data_devices(0, "cpu") == 1
        assert jsm.resolve_data_devices(16) == 8  # capped at the eight virtual devices
    assert tsm.resolve_data_devices(16, "cpu") == 16
    assert tsm.shard_devices(3, "cpu") == (CPU,) * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsm.resolve_data_devices(0, "cuda") == 2
    assert tsm.resolve_data_devices(8, "cuda") == 8
    assert [str(d) for d in tsm.shard_devices(4, torch.device("cuda"))] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert [str(d) for d in tsm.shard_devices(3, torch.device("cuda", 1))] == [
        "cuda:1", "cuda:0", "cuda:1"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tsm.shard_devices(4, torch.device("cuda")) == (torch.device("cuda", 0),) * 4


@pytest.mark.parametrize("k", [1, 2, 4])
def test_counts_by_pattern_match_the_jax_mesh(k):
    rng = np.random.default_rng(k)
    F, N, d = 8, 36, 2
    ps = rng.integers(0, 2**32, size=(F, N), dtype=np.uint32)
    pp = np.where(rng.random((F, N)) < 0.5, ps, rng.integers(0, 2**32, size=(F, N),
                                                              dtype=np.uint32))
    masks = tcollect.pattern_masks(d)
    ak = rng.random(N) < 0.8
    an = rng.random(F) < 0.7
    m = tsm.ServerMesh(k, "cpu").bind(N)
    got = m.counts_by_pattern(words_from_numpy(ps, CPU), words_from_numpy(pp, CPU), masks,
                              torch.from_numpy(ak), torch.from_numpy(an))
    whole = tcollect.counts_by_pattern(words_from_numpy(ps, CPU), words_from_numpy(pp, CPU),
                                       masks, torch.from_numpy(ak), torch.from_numpy(an))
    assert torch.equal(got, whole)
    # already-sharded parts give the same counts
    parts = m.split(words_from_numpy(ps, CPU), -1)
    assert len(parts) == k and all(p.shape == (F, N // k) for p in parts)
    assert torch.equal(m.counts_by_pattern(parts, words_from_numpy(pp, CPU), masks,
                                           torch.from_numpy(ak), torch.from_numpy(an)), whole)
    with torch_ref.installed():
        want = jsm.ServerMesh(k).bind(N).counts_by_pattern(ps, pp, masks, ak, an)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("field", [FE62, F255])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_node_share_sums_match_the_jax_mesh(field, k):
    """The gather path's one-device sum of the gathered values is the JAX
    mesh's per-shard sums folded with ``field_psum``."""
    rng = np.random.default_rng(10 + k)
    F, C, N = 5, 4, 24
    w = rng.integers(0, 2**32, size=(F, C, N, 8 if field is F255 else 4), dtype=np.uint32)
    vals_np = field.np_sample(w)  # canonical elements in the wire dtype of both packages
    weight = rng.random((F, C, N)) < 0.75
    m = tsm.ServerMesh(k, "cpu").bind(N)
    vals = (torch.from_numpy(vals_np.view(np.int64)) if field is FE62
            else words_from_numpy(vals_np, CPU))
    vals = m.gather(m.split(vals, 2))  # per-shard clients, gathered onto one device
    got = tsecure.node_share_sums(field, vals, torch.from_numpy(weight))
    got_np = got.numpy().view(np.uint64) if field is FE62 else words_to_numpy(got)
    with torch_ref.installed():
        jf = getattr(jfields, field.__name__)
        want = jsm.ServerMesh(k).bind(N).node_share_sums(jf, vals_np, weight)
    np.testing.assert_array_equal(got_np, np.asarray(want))


def test_keys_and_frontier_shard_and_gather_back():
    """Per-shard key batches are the client spans of the wire leaves; a
    frontier split and gathered again is the frontier (states and node
    mask), and a per-shard root frontier equals the whole one's split."""
    rng = np.random.default_rng(3)
    L, N, d = 4, 12, 2
    pts = rng.integers(0, 1 << L, size=(N, d))
    bits = np.array([[tbits.int_to_bits(L, int(v)) for v in row] for row in pts])
    k0, _ = tibdcf.gen_l_inf_ball(bits, 1, rng, device="cpu")
    leaves = tibdcf.keys_to_numpy(k0)
    m = tsm.ServerMesh(4, "cpu").bind(N)
    parts = m.shard_keys(list(leaves))
    assert len(parts) == 4
    for a, b in zip(tibdcf.IbDcfKeyBatch(*(torch.cat(x) for x in zip(*parts))), k0):
        assert torch.equal(a, b)
    fr = tcollect.tree_init(k0, 4)
    shards = m.shard_frontier(fr)
    for sh, kb in zip(shards, parts):
        for a, b in zip(sh.states, tcollect.tree_init(kb, 4).states):
            assert torch.equal(a, b)
    back = m.gather_frontier(shards)
    for a, b in zip(back.states, fr.states):
        assert torch.equal(a, b)
    assert torch.equal(back.alive, fr.alive)
