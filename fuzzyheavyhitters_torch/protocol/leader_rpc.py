"""The leader of the socket deployment: drives two collector servers over
the control plane (the unsupervised ``RpcLeader`` of the JAX package's
``protocol/leader_rpc.py``, ref: src/bin/leader.rs:185-297).

Batched key upload with a rolling window, an optional warmup
(:meth:`RpcLeader.warmup`), then per round: ``tree_crawl`` on both servers,
the leader's ``v0 - v1`` reconstruction of every count on the host, the
threshold ``max(1, threshold · nreqs)`` (leader.rs:193-194), the fused
prune; the last round in F255 and the final cross-check of the re-served
leaf shares (collect.rs:993-1029).  A round is ``crawl_radix_bits`` = k bit
levels (``r = min(k, data_len - level)`` at the tail): bases 0, k, 2k, …,
2^(d·r) count columns walked in the radix-1 survivor order
(``collect.radix_pattern_order``), prunes ``[F', d]`` at r = 1 and ``[F',
r, d]`` otherwise, r path bits per dim.  The garbler alternates per round
(``(level // k) % 2``, the reference's ``gc_sender`` flip: ``level % 2``
would pin one garbler at even k) and the equality engine rides each verb,
so both servers follow this leader's config.

Node spans: with ``crawl_shard_nodes > 0`` a level's crawl verbs go out
one per node span (``collect.shard_spans`` of the frontier bucket), the
trusted crawl always and the secure one with ``secure_whole_level:
false``; the spans' answers are reassembled in order.  With
``crawl_pipeline_depth > 1`` up to that many span verbs ride in flight:
both servers run them in frame-arrival order under their verb locks, so
the positional data plane stays matched while the next span's expansion
overlaps this span's exchange.  ``pipeline`` keeps the JAX leader's
figures: the depth of the last pipelined level, the overlap (span
seconds beyond the levels' wall time) and the stalls (head-of-line waits
while a later span had finished).

A span that fails cancels the spans in flight and raises: the JAX
leader's per-span retry (``_shard_call``) and its quiesce after a
pipeline fault (``plane_break``/``plane_reset``) belong to the recovery
path, not ported yet, as every verb of this unsupervised leader fails
loudly.  ``server_data_devices > 1`` (servers sharded over several cards)
raises ``NotImplementedError``; the supervised crawl with checkpoint
recovery and streaming windows are not ported either.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import time

import numpy as np

from ..ops import ibdcf
from ..ops.fields import F255, FE62
from ..utils.config import Config
from . import collect
from .driver import CrawlResult
from .rpc import CollectorClient, not_ported

UPLOAD_WINDOW = 256  # add_keys chunks in flight per upload (leader.rs:340-364 keeps 1000)


class RpcLeader:
    def __init__(self, cfg: Config, client0: CollectorClient, client1: CollectorClient):
        if cfg.server_data_devices > 1:
            raise not_ported(f"server_data_devices={cfg.server_data_devices}",
                              "a collector server sharded over several cards")
        self.cfg = cfg
        self.c0, self.c1 = client0, client1
        self.paths: np.ndarray | None = None
        self.n_nodes = 0
        self.buckets: list = []  # frontier bucket per round
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}

    @staticmethod
    async def _all(*coros):
        """Gather that cancels the other calls when one fails, and raises
        the first failure."""
        tasks = [asyncio.ensure_future(c) for c in coros]
        done, pending = await asyncio.wait(tasks, return_when=asyncio.FIRST_EXCEPTION)
        errs = [t.exception() for t in done]  # retrieve every one
        failed = next((e for e in errs if e is not None), None)
        if failed is not None:
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            raise failed
        return [t.result() for t in tasks]

    async def _both(self, verb: str, req=None):
        return await self._all(self.c0.call(verb, req), self.c1.call(verb, req))

    async def upload_keys(self, keys0: ibdcf.IbDcfKeyBatch, keys1: ibdcf.IbDcfKeyBatch):
        """Upload both parties' keys in ``addkey_batch_size`` chunks, at most
        ``UPLOAD_WINDOW`` in flight, refilled as each completes.  Keys are
        the wire form (``ibdcf.keys_to_numpy``)."""
        n = keys0.cw_seed.shape[0]
        bs = max(1, self.cfg.addkey_batch_size)
        sem = asyncio.Semaphore(UPLOAD_WINDOW)

        async def send_one(client, keys, sl):
            async with sem:  # the chunk is cut and pickled inside the window
                await client.call("add_keys", {"keys": tuple(leaf[sl] for leaf in keys),
                                               "sketch": None})

        await self._all(*(send_one(c, k, slice(lo, min(lo + bs, n)))
                          for lo in range(0, n, bs)
                          for c, k in ((self.c0, keys0), (self.c1, keys1))))

    async def warmup(self, f_buckets=None) -> dict:
        """Ask both servers to warm every bucket shape (``rpc.CollectorServer.
        warmup``); by default the powers of two from 1 to ``f_max``, and
        ``f_max`` itself, the ladder ``collect.bucket_for`` walks.  Call after :meth:`upload_keys`: it touches no crawl state."""
        cfg = self.cfg
        if f_buckets is None:
            f_buckets, b = [], 1
            while b <= cfg.f_max:
                f_buckets.append(b)
                b *= 2
            if f_buckets and f_buckets[-1] != cfg.f_max:
                f_buckets.append(cfg.f_max)
        r0, r1 = await self._both("warmup", {
            "f_buckets": [int(b) for b in f_buckets], "ot_path": cfg.ot_path,
            "secure_spans": bool(cfg.secure_exchange and not cfg.secure_whole_level
                                 and cfg.crawl_shard_nodes),
            "data_shards": int(cfg.server_data_devices)})
        return {"f_buckets": list(f_buckets), "s0": r0, "s1": r1}

    async def _crawl_level(self, level: int, last: bool):
        """This level's crawl verbs -> (server 0's, server 1's) answers:
        one verb per node span, in order, or ``crawl_pipeline_depth`` of
        them in flight; the whole level in one verb when there is one span
        or the secure exchange batches whole levels."""
        cfg = self.cfg
        verb = "tree_crawl_last" if last else "tree_crawl"
        # the garbler flips per round: bases 0, k, 2k, ...
        req = {"level": level, "garbler": (level // cfg.crawl_radix_bits) % 2,
               "ot_path": cfg.ot_path}
        spans = collect.shard_spans(self.buckets[-1], cfg.crawl_shard_nodes)
        if len(spans) == 1 or (cfg.secure_exchange and cfg.secure_whole_level):
            return await self._both(verb, req)
        depth = min(max(1, cfg.crawl_pipeline_depth), len(spans))
        if depth > 1:
            return await self._crawl_level_pipelined(verb, req, spans, depth)
        parts0, parts1 = [], []
        for span in spans:
            s0, s1 = await self._both(verb, dict(req, shard=list(span)))
            parts0.append(np.asarray(s0))
            parts1.append(np.asarray(s1))
        return np.concatenate(parts0, axis=0), np.concatenate(parts1, axis=0)

    async def _crawl_level_pipelined(self, verb: str, req: dict, spans: list, depth: int):
        """A window of up to ``depth`` span verbs in flight, refilled as the
        oldest completes (in-order reassembly).  A failure cancels the
        window and raises."""

        def launch(span):
            async def one():
                t0 = time.perf_counter()
                r = await self._both(verb, dict(req, shard=list(span)))
                return r, time.perf_counter() - t0
            return asyncio.ensure_future(one())

        t_level = time.perf_counter()
        it = iter(spans[depth:])
        window = collections.deque(launch(sp) for sp in spans[:depth])
        parts0, parts1 = [], []
        busy, stalls = 0.0, 0
        try:
            while window:
                head = window.popleft()
                if not head.done() and any(t.done() for t in window):
                    stalls += 1
                (s0, s1), dt = await head
                busy += dt
                parts0.append(np.asarray(s0))
                parts1.append(np.asarray(s1))
                nxt = next(it, None)
                if nxt is not None:
                    window.append(launch(nxt))
        except BaseException:
            for t in window:
                t.cancel()
            for t in window:
                with contextlib.suppress(Exception, asyncio.CancelledError):
                    await t
            raise
        self.pipeline["depth"] = depth
        self.pipeline["overlap_s"] += max(0.0, busy - (time.perf_counter() - t_level))
        self.pipeline["stalls"] += stalls
        return np.concatenate(parts0, axis=0), np.concatenate(parts1, axis=0)

    async def _run_one_level(self, level: int, nreqs: int, thresh: int):
        """One crawl -> reconstruct -> threshold -> prune round over bit
        levels ``[level, level + r)``; returns the surviving nodes' counts,
        or None when the crawl died out."""
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        r = min(cfg.crawl_radix_bits, L - level)
        last = level + r == L
        s0, s1 = await self._crawl_level(level, last)
        if last:
            v = F255.np_sub(s0, s1)
            if v[..., 1:].any():
                raise RuntimeError("non-count residue in F255 share")
            counts = v[..., 0]
        else:
            v = FE62.np_canon(FE62.np_sub(s0, s1))
            if (v > nreqs).any():  # e.g. a share-sign or role mismatch
                raise RuntimeError("count reconstruction out of range")
            counts = v.astype(np.uint32)
        # fused children in the radix-1 visit order (the identity at r = 1)
        order = collect.radix_pattern_order(d, r)
        keep = counts[:, order] >= thresh
        keep[self.n_nodes:, :] = False
        parent, rank, n_alive = collect.compact_survivors(keep, cfg.f_max)
        if n_alive == 0:
            return None
        pattern = order[rank]
        if not last:
            self.buckets.append(int(parent.shape[0]))  # the next round's span plan
        pat_bits = collect.pattern_to_bits_radix(pattern, d, r)  # [F', r, d]
        # r = 1 keeps the radix-1 wire, [F', d]
        prune = {"parent_idx": parent, "pattern_bits": pat_bits[:, 0] if r == 1 else pat_bits,
                 "n_alive": n_alive}
        if last:
            await self._both("tree_prune_last", prune)
        else:
            await self._both("tree_prune", dict(prune, level=level))
        self.paths = np.concatenate(
            [self.paths[parent[:n_alive]], pat_bits[:n_alive].transpose(0, 2, 1)], axis=-1)
        self.n_nodes = n_alive
        return counts[parent[:n_alive], pattern[:n_alive]]

    async def run(self, nreqs: int) -> CrawlResult:
        """The whole crawl on the uploaded keys."""
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        await self._both("tree_init", {"root_bucket": 1})
        self.paths = np.zeros((1, d, 0), bool)
        self.n_nodes = 1
        self.buckets = [1]
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}
        thresh = max(1, int(cfg.threshold * nreqs))
        k = cfg.crawl_radix_bits
        for level in range(0, L, k):
            kept = await self._run_one_level(level, nreqs, thresh)
            if kept is None:
                return CrawlResult(paths=np.zeros((0, d, min(L, level + k)), bool),
                                   counts=np.zeros(0, np.uint32))
        # the crawl-time counts only pruned: the result is reconstructed from
        # the re-served leaf shares, which must agree with them
        f0, f1 = await self._both("final_shares")
        v = F255.np_sub(f0["shares"], f1["shares"])
        final = v[..., 0]
        if v[..., 1:].any() or not np.array_equal(final, kept):
            raise RuntimeError("final share reconstruction mismatch")
        return CrawlResult(paths=self.paths, counts=final)
