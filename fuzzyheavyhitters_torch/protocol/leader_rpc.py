"""The leader of the socket deployment: drives two collector servers over
the control plane (the unsupervised ``RpcLeader`` of the JAX package's
``protocol/leader_rpc.py``, ref: src/bin/leader.rs:185-297).

Batched key upload with a rolling window, then per level: ``tree_crawl``
on both servers, the leader's ``v0 - v1`` reconstruction of every count on
the host, the threshold ``max(1, threshold · nreqs)`` (leader.rs:193-194),
the fused prune; the last level in F255 and the final cross-check of the
re-served leaf shares (collect.rs:993-1029).  The garbler alternates per
level (``level % 2``, the reference's ``gc_sender`` flip) and the equality
engine rides each verb, so both servers follow this leader's config.

Options that select paths not ported here raise ``NotImplementedError``
naming the path: ``crawl_shard_nodes > 0`` (node-span sharded crawl
verbs), ``crawl_pipeline_depth > 1`` (the pipelined span crawl) and
``server_data_devices > 1`` (servers sharded over several cards).  The
supervised crawl with checkpoint recovery, warmup and streaming windows
are not ported either.
"""

from __future__ import annotations

import asyncio

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
        if cfg.crawl_shard_nodes > 0:
            raise not_ported(f"crawl_shard_nodes={cfg.crawl_shard_nodes}",
                              "the node-span sharded crawl")
        if cfg.crawl_pipeline_depth > 1:
            raise not_ported(f"crawl_pipeline_depth={cfg.crawl_pipeline_depth}",
                              "the pipelined span crawl")
        if cfg.server_data_devices > 1:
            raise not_ported(f"server_data_devices={cfg.server_data_devices}",
                              "a collector server sharded over several cards")
        self.cfg = cfg
        self.c0, self.c1 = client0, client1
        self.paths: np.ndarray | None = None
        self.n_nodes = 0

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

    async def _run_one_level(self, level: int, nreqs: int, thresh: int):
        """One crawl -> reconstruct -> threshold -> prune round; returns the
        surviving nodes' counts, or None when the crawl died out."""
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        last = level == L - 1
        req = {"level": level, "garbler": level % 2, "ot_path": cfg.ot_path}
        s0, s1 = await self._both("tree_crawl_last" if last else "tree_crawl", req)
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
        keep = counts >= thresh
        keep[self.n_nodes:, :] = False
        parent, pattern, n_alive = collect.compact_survivors(keep, cfg.f_max)
        if n_alive == 0:
            return None
        pat_bits = collect.pattern_to_bits(pattern, d)
        prune = {"parent_idx": parent, "pattern_bits": pat_bits, "n_alive": n_alive}
        if last:
            await self._both("tree_prune_last", prune)
        else:
            await self._both("tree_prune", dict(prune, level=level))
        self.paths = np.concatenate(
            [self.paths[parent[:n_alive]], pat_bits[:n_alive, :, None]], axis=-1)
        self.n_nodes = n_alive
        return counts[parent[:n_alive], pattern[:n_alive]]

    async def run(self, nreqs: int) -> CrawlResult:
        """The whole crawl on the uploaded keys."""
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        await self._both("tree_init", {"root_bucket": 1})
        self.paths = np.zeros((1, d, 0), bool)
        self.n_nodes = 1
        thresh = max(1, int(cfg.threshold * nreqs))
        for level in range(L):
            kept = await self._run_one_level(level, nreqs, thresh)
            if kept is None:
                return CrawlResult(paths=np.zeros((0, d, level + 1), bool),
                                   counts=np.zeros(0, np.uint32))
        # the crawl-time counts only pruned: the result is reconstructed from
        # the re-served leaf shares, which must agree with them
        f0, f1 = await self._both("final_shares")
        v = F255.np_sub(f0["shares"], f1["shares"])
        final = v[..., 0]
        if v[..., 1:].any() or not np.array_equal(final, kept):
            raise RuntimeError("final share reconstruction mismatch")
        return CrawlResult(paths=self.paths, counts=final)
