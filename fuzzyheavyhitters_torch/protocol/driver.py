"""In-process protocol driver: a leader and two colocated server states.

The port of ``fuzzyheavyhitters_tpu/protocol/driver.py`` for radix 1 with
no streaming: both servers' state machines live in one process on one
device, with the trusted-exchange data plane — the per-(node, client)
packed share bits are compared directly (the counts the leader would
reconstruct anyway, ref: collect.rs:945-964).

Level-loop semantics mirror the reference leader (ref: leader.rs:185-297):

- threshold = ``max(1, threshold · nreqs)`` (leader.rs:193-194);
- each level: expand → count → threshold → prune → advance;
- prune keeps only above-threshold children (leader.rs:229-234), in
  (node, pattern) order, so ``f_max`` truncation and the paths match the
  JAX package exactly;
- paths decode MSB-first per dim; heavy hitters are the surviving leaves.

Per-level host timings go to ``Leader.timings`` (a plain dict of lists).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.ibdcf import IbDcfKeyBatch
from . import collect


@dataclass
class ServerState:
    """One collector server's state (ref: server.rs:44-52)."""

    keys: IbDcfKeyBatch  # [N, d, 2]
    alive_keys: torch.Tensor  # bool[N] liveness flags (ref: collect.rs:32)
    frontier: collect.Frontier | None = None
    children: collect.PlanarChildren | None = None


@dataclass
class CrawlResult:
    paths: np.ndarray  # bool[H, d, L] per-dim MSB-first paths
    counts: np.ndarray  # int64[H]

    def decode_ints(self) -> np.ndarray:
        """paths -> int[H, d] leaf values (MSB-first per dim); domains of
        63+ bits decode through Python ints (object dtype)."""
        L = self.paths.shape[-1]
        if L < 63:
            weights = 1 << np.arange(L - 1, -1, -1)
            return (self.paths.astype(np.int64) * weights).sum(-1)
        vals = np.zeros(self.paths.shape[:-1], dtype=object)
        for i in range(L):
            vals = (vals << 1) | self.paths[..., i].astype(object)
        return vals


@dataclass
class Leader:
    """Drives two ServerStates level by level (ref: leader.rs:185-297)."""

    server0: ServerState
    server1: ServerState
    n_dims: int
    data_len: int
    f_max: int = 256
    paths: np.ndarray = field(default=None)  # bool[F, d, level]
    n_nodes: int = 0
    # seconds per level, host clock: "expand" (enqueue of both servers'
    # expansions), "count" (counts + the readback that waits for the
    # device), "advance" (prune bookkeeping + enqueue of both gathers)
    timings: dict = field(default_factory=dict)

    def __post_init__(self):
        if not 1 <= self.n_dims <= collect.MAX_DIMS:
            raise ValueError(f"n_dims={self.n_dims}: supported 1..{collect.MAX_DIMS}")

    def tree_init(self):
        for s in (self.server0, self.server1):
            s.frontier = collect.tree_init(s.keys)
            s.children = None
        self.paths = np.zeros((1, self.n_dims, 0), bool)
        self.n_nodes = 1
        self.timings = {"expand": [], "count": [], "advance": []}

    def run_level(self, level: int, nreqs: int, threshold: float) -> int:
        """One expand -> count -> threshold -> prune -> advance round;
        returns the surviving node count.  The last level builds no child
        cache and leaves no frontier: nothing advances past it."""
        d = self.n_dims
        last = level == self.data_len - 1
        servers = (self.server0, self.server1)
        alive_nodes = self.server0.frontier.alive
        t0 = time.perf_counter()
        packed = []
        for s in servers:
            p, s.children = collect.expand_share_bits(
                s.keys, s.frontier, level, want_children=not last)
            s.frontier = None  # the child cache is all the advance needs
            packed.append(p)
        t1 = time.perf_counter()
        counts = collect.counts_by_pattern(
            packed[0], packed[1], collect.pattern_masks(d),
            self.server0.alive_keys, alive_nodes,
        )
        del packed
        # the one per-level readback: thresholding is leader logic
        counts = counts.cpu().numpy()  # [F, 2^d]
        t2 = time.perf_counter()
        thresh = max(1, int(threshold * nreqs))  # ref: leader.rs:193-194
        keep = counts >= thresh
        keep[self.n_nodes:, :] = False
        parent, pattern, n_alive = collect.compact_survivors(keep, self.f_max)
        pat_bits = collect.pattern_to_bits(pattern, d)
        if not last:
            dev = self.server0.alive_keys.device
            parent_t = torch.from_numpy(parent.astype(np.int64)).to(dev)
            pat_t = torch.from_numpy(pat_bits).to(dev)
            for s in servers:
                s.frontier = collect.advance_from_children(
                    s.children, parent_t, pat_t, n_alive)
                s.children = None
        else:
            for s in servers:
                s.children = None
        self.paths = np.concatenate(
            [self.paths[parent[:n_alive]], pat_bits[:n_alive, :, None]], axis=-1)
        self.n_nodes = n_alive
        self._last_counts = counts[parent[:n_alive], pattern[:n_alive]]
        t3 = time.perf_counter()
        self.timings["expand"].append(t1 - t0)
        self.timings["count"].append(t2 - t1)
        self.timings["advance"].append(t3 - t2)
        return n_alive

    def run(self, nreqs: int, threshold: float) -> CrawlResult:
        """Full crawl: init + data_len levels + final reconstruction
        (ref: leader.rs:417-438 then final_shares at :282-297)."""
        self.tree_init()
        for level in range(self.data_len):
            n = self.run_level(level, nreqs, threshold)
            if n == 0:
                return CrawlResult(
                    paths=np.zeros((0, self.n_dims, level + 1), bool),
                    counts=np.zeros(0, np.int64),
                )
        return CrawlResult(paths=self.paths, counts=self._last_counts)


def make_servers(keys0: IbDcfKeyBatch, keys1: IbDcfKeyBatch):
    n = keys0.cw_seed.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=keys0.cw_seed.device)
    return ServerState(keys0, alive.clone()), ServerState(keys1, alive.clone())
