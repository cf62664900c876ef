"""Row-sharded sketch verification over a server's data shards (the port
of ``fuzzyheavyhitters_tpu/parallel/sketch_shard.py``).

The malicious check of ``sketch_verify`` runs per (client, dim) row: the
sketch inner products, the Beaver cor and out shares and the verdict are
all client-parallel, so the check batch splits along the client axis with
no reduction across shards at all:

- shard j takes its clients' rows of the stored pair shares, the triple
  slab and the MAC shares, and draws its own slice of the level's
  challenge stream by CTR seek (``sketch.challenge_rands`` from row
  ``lo·d``; the per-node r vector is the whole stream's), so its check
  state is the rows of the single-device state;
- the cor and out openings read back per shard and are assembled by
  position into the single-device wire, byte for byte;
- the verdicts concatenate in shard order.

The active shard count is the largest divisor of the client batch within
the budget (``Config.sketch_shards``, 0 = the data shards); at one shard,
or on a server without data shards, :func:`bind` gives None and the
single-card functions of ``protocol/sketch.py`` run unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..protocol import mpc
from ..protocol import sketch as sketchmod
from ..utils import resolve_device
from .server_mesh import Sharded, _largest_divisor_leq, split_even


def sketch_shards(n_clients: int, budget: int) -> int:
    """Active shards of an ``n_clients`` verify under a device budget (1 =
    the single-card path)."""
    return _largest_divisor_leq(n_clients, max(1, int(budget)))


@dataclass(frozen=True)
class SketchShard:
    """One check batch's binding: ``k`` devices over ``N`` clients of ``d``
    dims."""

    devices: tuple
    N: int
    d: int

    @property
    def k(self) -> int:
        return len(self.devices)

    def spans(self) -> list:
        n = self.N // self.k
        return [(j * n, (j + 1) * n) for j in range(self.k)]


def bind(devices, N: int, d: int, budget: int) -> SketchShard | None:
    """Bind the verify to the leading ``devices``; None when one shard
    fits (the single-card path)."""
    k = sketch_shards(N, min(int(budget), len(devices)))
    if k < 2:
        return None
    return SketchShard(devices=tuple(devices[:k]), N=N, d=d)


def cor_state(ss: SketchShard | None, field, pairs, trip, mk, mk2, seed, level: int):
    """Stage 1: -> (the cor wire stack field[2, N, d, CHECKS(, limbs)], the
    check state kept for stage 2), per shard when ``ss`` is bound."""
    if ss is None:
        return sketchmod.cor_state(field, pairs, trip, mk, mk2, seed, level)
    pp = split_even(pairs, ss.devices, 1)
    ta, tb, tc = (split_even(x, ss.devices, 0) for x in trip)
    mks, mk2s = split_even(mk, ss.devices, 0), split_even(mk2, ss.devices, 0)
    cors, states = [], []
    for j, (lo, _) in enumerate(ss.spans()):
        st = sketchmod.level_check_state(field, pp[j], mpc.TripleBatch(ta[j], tb[j], tc[j]),
                                         mks[j], mk2s[j], seed, level, lo * ss.d)
        cors.append(torch.stack(mpc.cor_share(field, st)))
        states.append(st)
    return Sharded(cors, 1), states


def out_shares(ss: SketchShard | None, field, state, cor_mine, cor_peer_np, server_idx: bool):
    """Stage 2: open (d, e) from both cor stacks and take this party's out
    shares field[N, d(, limbs)]; each shard reads its clients' columns of
    the peer's wire stack."""
    if ss is None:
        return sketchmod.out_shares(field, state, cor_mine, cor_peer_np, server_idx)
    peer = np.asarray(cor_peer_np)
    return Sharded([sketchmod.out_shares(field, st, cm, peer[:, lo:hi], server_idx)
                    for st, cm, (lo, hi) in zip(state, cor_mine, ss.spans())], 0)


def verdicts(ss: SketchShard | None, field, o_mine, o_peer_np) -> torch.Tensor:
    """Stage 3: bool[N] on the first shard's device, a client passing iff
    every dim's checks sum to zero."""
    if ss is None:
        return sketchmod.verdicts(field, o_mine, o_peer_np)
    peer = np.asarray(o_peer_np)
    dev0 = ss.devices[0]
    return torch.cat([sketchmod.verdicts(field, om, peer[lo:hi]).to(dev0)
                      for om, (lo, hi) in zip(o_mine, ss.spans())])


def wire(arr) -> np.ndarray:
    """One wire message in its wire dtype (``sketch.wire``): a sharded
    stack is read back per shard and assembled by position."""
    if not isinstance(arr, Sharded):
        return sketchmod.wire(arr)
    return np.concatenate([sketchmod.wire(p) for p in arr], axis=arr.dim)


def stream_parts(ss: SketchShard | None, field, seed, level: int, m: int, N: int, d: int,
                 device=None):
    """(r, rands) of one level's challenge stream in their wire dtypes,
    ``rands`` assembled from the shards' seeks: what the tests hold
    against the single-device ``shared_r_stream`` draw.  Unsharded it runs
    on ``device`` (the card unless the caller names another)."""
    devs = ss.devices if ss is not None else (resolve_device(device),)
    n = N // len(devs)
    r = sketchmod.challenge_r(field, seed, level, m, devs[0])
    rands = [sketchmod.challenge_rands(field, seed, level, m, j * n * d, n * d, dev)
             for j, dev in enumerate(devs)]
    return sketchmod.wire(r), np.concatenate([sketchmod.wire(x) for x in rands])


def warm_verify(ss: SketchShard | None, field, m: int, N: int, d: int, server_idx: bool,
                device=None) -> None:
    """The whole cor -> out -> verdict chain on zero inputs at one (bucket
    ``m``, batch) shape, both wire messages through host numpy as on the
    socket path; touches no live state.  Unsharded it runs on ``device``
    (the card unless the caller names another)."""
    dev = ss.devices[0] if ss is not None else resolve_device(device)
    pairs = field.zeros((m, N, d, sketchmod.LANES), dev)
    trip = mpc.TripleBatch(*(field.zeros((N, d, mpc.CHECKS), dev) for _ in range(3)))
    mk, mk2 = field.zeros((N,), dev), field.zeros((N,), dev)
    seed = np.zeros(4, np.uint32)
    cor, st = cor_state(ss, field, pairs, trip, mk, mk2, seed, 0)
    o = out_shares(ss, field, st, cor, wire(cor), server_idx)
    verdicts(ss, field, o, wire(o)).cpu()
