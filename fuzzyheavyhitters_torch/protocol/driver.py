"""In-process protocol driver: a leader and two colocated server states.

The port of ``fuzzyheavyhitters_tpu/protocol/driver.py`` for radix 1 with
no streaming: both servers' state machines live in one process on one
device.  Two data planes:

- trusted exchange: the per-(node, client) packed share bits are compared
  directly (the counts the leader would reconstruct anyway, ref:
  collect.rs:945-964);
- secure exchange (``Leader.secure`` set): per level the two servers run
  the whole-level 2PC of ``protocol/secure.py`` — the evaluator's Δ-OT
  extension, the garbler's one planar message (1-of-2^S table or packed
  garbled batch), the evaluator's open — and each sums its additive field
  shares per (node, pattern); the leader reconstructs ``sh0 - sh1``.  The
  garbler alternates per level (``g = level % 2``, as the JAX package's
  ``parallel/mesh.py``), each direction on its own OT-extension session
  (:class:`SecureSessions`); inner levels count in FE62, the last in F255
  (ref: rpc.rs:60-62).

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

import contextlib
import secrets as _secrets
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import baseot, otext
from ..ops.fields import F255, FE62
from ..ops.ibdcf import IbDcfKeyBatch
from ..utils import words_to_numpy
from . import collect, secure


SECURE_PHASES = ("otext", "b2a", "garble", "eval", "field")


class PhaseClock:
    """Seconds per named phase, as ``with clock(name): ...`` around the
    work (the ``phase`` argument of ``protocol/secure.py``).  On the card a
    phase is the span of the device stream between CUDA events recorded
    around it — no sync of its own — read by :meth:`settle` once a readback
    has waited for the work; on the CPU it is host time."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spent: dict = {}
        self._marks: list = []  # (phase, start event, end event)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            yield
            ev[1].record()
            self._marks.append((name, *ev))
            return
        t = time.perf_counter()
        yield
        self.spent[name] = self.spent.get(name, 0.0) + time.perf_counter() - t

    def settle(self) -> dict:
        """Seconds per phase since the last settle (waits for the events)."""
        for name, start, end in self._marks:
            end.synchronize()
            self.spent[name] = self.spent.get(name, 0.0) + start.elapsed_time(end) / 1e3
        out, self.spent, self._marks = self.spent, {}, []
        return out


@dataclass
class ServerState:
    """One collector server's state (ref: server.rs:44-52)."""

    keys: IbDcfKeyBatch  # [N, d, 2]
    alive_keys: torch.Tensor  # bool[N] liveness flags (ref: collect.rs:32)
    frontier: collect.Frontier | None = None
    children: collect.PlanarChildren | None = None


@dataclass
class SecureSessions:
    """The secure crawl's OT state: one extension session per garbling
    direction.  In session g server g is the extension sender (garbler),
    holding ``snd[g]``, and server 1 - g the receiver, holding ``rcv[g]``.
    ``sec_seed`` derives the per-level GC and b2a seeds."""

    snd: tuple
    rcv: tuple
    sec_seed: np.ndarray
    crawl_ctr: int = 0


def session_material(rng=None) -> dict:
    """Base-OT material of both sessions and the session seed, from ``rng``
    (``secrets.SystemRandom`` by default; a seeded ``random.Random`` gives
    reproducible sessions): ``{"sessions": [(s_bits, seeds0, seeds1,
    chosen)] * 2, "sec_seed": uint32[4]}``."""
    mats = []
    for _ in range(2):
        s_bits = otext.fresh_s_bits(rng)
        seeds0, seeds1, chosen = baseot.exchange(s_bits, rng)
        mats.append((s_bits, seeds0, seeds1, chosen))
    if rng is None:
        sec_seed = np.frombuffer(_secrets.token_bytes(16), "<u4").copy()
    else:
        sec_seed = np.array([rng.getrandbits(32) for _ in range(4)], np.uint32)
    return {"sessions": mats, "sec_seed": sec_seed}


def make_sessions(material: dict, device) -> SecureSessions:
    snd, rcv = [], []
    for s_bits, seeds0, seeds1, chosen in material["sessions"]:
        snd.append(otext.OtExtSender(s_bits, chosen, device))
        rcv.append(otext.OtExtReceiver(seeds0, seeds1, device))
    return SecureSessions(snd=tuple(snd), rcv=tuple(rcv),
                          sec_seed=np.asarray(material["sec_seed"], np.uint32))


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
    secure: SecureSessions | None = None  # None: trusted exchange
    ot_path: str = "auto"  # secure equality engine (secure.ot_path)
    paths: np.ndarray = field(default=None)  # bool[F, d, level]
    n_nodes: int = 0
    buckets: list = field(default_factory=list)  # frontier bucket per level
    # seconds per level, host clock: "expand" (enqueue of both servers'
    # expansions, and the strings in a secure crawl), "count" (counts, or
    # the leader's reconstruction, and the readback that waits for the
    # device), "advance" (prune bookkeeping + enqueue of both gathers); a
    # secure crawl adds the socket server's phases "otext", "b2a",
    # "garble", "eval" and "field" (the share sums): on the card each is
    # the span on the device stream between CUDA events recorded around
    # it (no sync of its own), on the CPU its host time
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
        self.buckets = []
        names = ["expand", "count", "advance"]
        if self.secure is not None:
            names += list(SECURE_PHASES)
        self.timings = {k: [] for k in names}

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
        self.buckets.append(int(alive_nodes.shape[0]))
        if self.secure is not None:
            counts, t1, tc = self._secure_counts(level, packed, alive_nodes, last)
        else:
            t1 = tc = time.perf_counter()
            counts = collect.counts_by_pattern(
                packed[0], packed[1], collect.pattern_masks(d),
                self.server0.alive_keys, alive_nodes,
            )
            # the one per-level readback: thresholding is leader logic
            counts = counts.cpu().numpy()  # [F, 2^d]
        del packed
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
        self.timings["count"].append(t2 - tc)
        self.timings["advance"].append(t3 - t2)
        return n_alive

    def _secure_counts(self, level: int, packed: list, alive_nodes, last: bool):
        """One secure level after both expansions: strings, the whole-level
        2PC with garbler ``level % 2``, share sums, reconstruction.
        Returns (counts int64[F, 2^d], the host times at which the strings
        were ready and the reconstruction began)."""
        sec, d = self.secure, self.n_dims
        phase = PhaseClock(packed[0].device)
        field_ = F255 if last else FE62
        g = level % 2
        ev = 1 - g
        strs = [secure.child_strings(p, d) for p in packed]
        F, C, N, S = strs[0].shape
        B = F * C * N
        flat = [s.reshape(B, S) for s in strs]
        del strs
        t1 = time.perf_counter()
        sec.crawl_ctr += 1
        gseed = secure.derive_seed(sec.sec_seed, 1, level, sec.crawl_ctr)
        bseed = secure.derive_seed(sec.sec_seed, 2, level, sec.crawl_ctr)
        u, t_rows, idx0 = secure.ev_step1_fused(sec.rcv[g], flat[ev], phase=phase)
        msg, vals_g = secure.gb_step_level(sec.snd[g], u, flat[g], gseed, bseed, field_,
                                           g, self.ot_path, phase=phase)
        del u
        vals_ev = secure.ev_open_level(t_rows, flat[ev], msg, B, S, field_, idx0,
                                       self.ot_path, phase=phase)
        del msg, t_rows, flat
        vals = {g: vals_g, ev: vals_ev}
        with phase("field"):
            w = secure.alive_weight(alive_nodes, self.server0.alive_keys, C)
            shape = (F, C, N) + field_.limb_shape
            sh = [secure.node_share_sums(field_, vals[s].reshape(shape), w) for s in (0, 1)]
        del vals, vals_g, vals_ev
        tc = time.perf_counter()
        # leader reconstruction: v0 - v1 per (node, pattern); the readback
        # waits for the level's device work, so every phase event is done
        if last:
            limbs = words_to_numpy(F255.sub(sh[0], sh[1]))  # [F, C, 8]
            if limbs[..., 1:].any():
                raise RuntimeError("non-count residue in F255 shares")
            v = limbs[..., 0].astype(np.int64)
        else:
            v = FE62.canon(FE62.sub(sh[0], sh[1])).cpu().numpy()
            if (v > N).any():  # e.g. a share-sign or role mismatch
                raise RuntimeError("count reconstruction out of range")
        spent = phase.settle()
        for k in SECURE_PHASES:
            self.timings[k].append(spent.get(k, 0.0))
        return v, t1, tc

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
