"""The leader of the socket deployment: drives two collector servers over
the control plane (the ``RpcLeader`` of the JAX package's
``protocol/leader_rpc.py``, ref: src/bin/leader.rs:185-297), unsupervised
(:meth:`RpcLeader.run`) or supervised (:meth:`RpcLeader.run_supervised`,
the JAX leader's default).

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

A span lost to a transient fault is re-run alone (:meth:`RpcLeader.
_shard_call`, under ``SHARD_POLICY``, after a fresh data plane).  A
pipelined level that faults cancels its window, breaks any verb wedged
on the plane (``plane_break`` on both servers, outside their verb locks),
re-keys the plane (``plane_reset``) and re-runs the level's spans in
order.  A restarted server escalates to the supervised crawl's rollback.

The supervised crawl owns the whole collection (reset, upload, warmup,
rounds, final shares), since recovery needs the keys: every
``checkpoint_every`` levels both servers ``tree_checkpoint`` and the
leader stashes its own bookkeeping; on a transport loss, a server restart
or a verb failure it probes both servers, re-keys the data plane,
re-uploads the keys of a restarted server only, rolls both back to the
stash (``tree_restore``; from scratch when there is none, as when the
servers have no checkpoint directory) and re-runs only the lost rounds,
bit-identically.  ``counters`` keeps ``recoveries``, ``levels_rerun``,
``shards_rerun``, ``crawl_checkpoints`` and ``pipeline_faults``; ``emit``
receives ``resilience.recover`` and ``resilience.restored``.

``server_data_devices > 1`` (servers sharded over several cards) raises
``NotImplementedError``; streaming windows are not ported.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import time

import numpy as np

from ..ops import ibdcf
from ..ops.fields import F255, FE62
from ..resilience import policy as respolicy
from ..utils.config import Config
from . import collect
from .driver import CrawlResult
from .rpc import CollectorClient, ServerRestartedError, not_ported

UPLOAD_WINDOW = 256  # add_keys chunks in flight per upload (leader.rs:340-364 keeps 1000)


COUNTERS = ("recoveries", "levels_rerun", "shards_rerun", "crawl_checkpoints",
            "pipeline_faults")
MAX_RECOVERIES = 4  # rollbacks a supervised crawl survives (the JAX leader's default)


class RpcLeader:
    def __init__(self, cfg: Config, client0: CollectorClient, client1: CollectorClient,
                 emit=None):
        if cfg.server_data_devices > 1:
            raise not_ported(f"server_data_devices={cfg.server_data_devices}",
                              "a collector server sharded over several cards")
        self.cfg = cfg
        self.c0, self.c1 = client0, client1
        self.emit = emit or (lambda event, **kw: None)
        self.paths: np.ndarray | None = None
        self.n_nodes = 0
        self.buckets: list = []  # frontier bucket per round
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}
        self.counters = dict.fromkeys(COUNTERS, 0)
        # the supervised crawl's seconds: reset and upload, warmup, the
        # rounds (re-runs and recoveries included), recoveries alone
        self.seconds = {"upload": 0.0, "warmup": 0.0, "levels": 0.0, "recover": 0.0}
        self._boot_ids: dict = {}  # last known server boot ids

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

    async def upload_keys(self, keys0: ibdcf.IbDcfKeyBatch, keys1: ibdcf.IbDcfKeyBatch,
                          which: int | None = None):
        """Upload both parties' keys in ``addkey_batch_size`` chunks, at most
        ``UPLOAD_WINDOW`` in flight, refilled as each completes.  Keys are
        the wire form (``ibdcf.keys_to_numpy``).  ``which`` (0 or 1)
        uploads to that server only: recovery re-seeding a restarted one."""
        n = keys0.cw_seed.shape[0]
        bs = max(1, self.cfg.addkey_batch_size)
        sem = asyncio.Semaphore(UPLOAD_WINDOW)
        targets = [(i, c, k) for i, c, k in ((0, self.c0, keys0), (1, self.c1, keys1))
                   if which in (None, i)]

        async def send_one(client, keys, sl):
            async with sem:  # the chunk is cut and pickled inside the window
                await client.call("add_keys", {"keys": tuple(leaf[sl] for leaf in keys),
                                               "sketch": None})

        # cancel on the first failure: an orphaned add_keys replay landing
        # after a recovery's reset would append a chunk twice
        await self._all(*(send_one(c, k, slice(lo, min(lo + bs, n)))
                          for lo in range(0, n, bs) for _, c, k in targets))

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
        one verb per node span, in order, each under :meth:`_shard_call`'s
        retry, or ``crawl_pipeline_depth`` of them in flight; the whole
        level in one verb when there is one span or the secure exchange
        batches whole levels (a fault then costs the level).  A pipelined
        level that faults is quiesced and re-run span by span."""
        cfg = self.cfg
        verb = "tree_crawl_last" if last else "tree_crawl"
        # the garbler flips per round: bases 0, k, 2k, ...
        req = {"level": level, "garbler": (level // cfg.crawl_radix_bits) % 2,
               "ot_path": cfg.ot_path}
        spans = collect.shard_spans(self.buckets[-1], cfg.crawl_shard_nodes)
        if len(spans) == 1 or (cfg.secure_exchange and cfg.secure_whole_level):
            return await self._both(verb, req)
        depth = min(max(1, cfg.crawl_pipeline_depth), len(spans))
        rerun = False
        if depth > 1:
            try:
                return await self._crawl_level_pipelined(verb, req, spans, depth)
            except respolicy.TRANSIENT_ERRORS as err:
                if isinstance(err, ServerRestartedError):
                    raise  # state lost: the supervised rollback owns it
                await self._quiesce_after_pipeline_fault(level, err)
                rerun = True
        parts0, parts1 = [], []
        for span in spans:
            s0, s1 = await self._shard_call(verb, dict(req, shard=list(span)))
            if rerun:
                self.counters["shards_rerun"] += 1
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

    async def _quiesce_after_pipeline_fault(self, level: int, err) -> None:
        """After a pipelined level's window is cancelled: break any exchange
        wedged by the fault (a span that reached one server leaves the other
        blocked on a plane recv, holding its verb lock; ``plane_break`` runs
        outside it), re-key the plane and check that neither server
        restarted.  The caller re-runs the level; the servers' span caches
        are overwritten, so the re-run is bit-identical."""
        self.counters["pipeline_faults"] += 1
        self.emit("pipeline.quiesce", level=level, error=f"{type(err).__name__}: {err}")
        await self._both("plane_break")
        if await self._reprobe_and_reset():
            raise err  # a restarted server: the rollback owns it

    async def _shard_call(self, verb: str, req: dict):
        """One span's verb on both servers under ``SHARD_POLICY``: a
        transient fault re-keys the data plane (a half-run secure span
        leaves the two OT streams apart) and re-runs just this span.  A
        restarted server escalates: lost state is the rollback's to
        handle."""
        pol = respolicy.SHARD_POLICY
        attempt = 0
        while True:
            try:
                return await self._both(verb, req)
            except respolicy.TRANSIENT_ERRORS as err:
                attempt += 1
                if isinstance(err, ServerRestartedError) or attempt >= pol.attempts:
                    raise
                if await self._reprobe_and_reset():
                    raise
                self.counters["shards_rerun"] += 1
                self.emit("resilience.shard_rerun", level=int(req["level"]),
                          span=req.get("shard"), attempt=attempt,
                          error=f"{type(err).__name__}: {err}")
                await asyncio.sleep(pol.delay(attempt - 1))

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

    async def _start_tree(self) -> None:
        await self._both("tree_init", {"root_bucket": 1})
        self.paths = np.zeros((1, self.cfg.n_dims, 0), bool)
        self.n_nodes = 1
        self.buckets = [1]

    async def run(self, nreqs: int) -> CrawlResult:
        """The whole crawl on the uploaded keys."""
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        await self._start_tree()
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

    # -- the supervised crawl -------------------------------------------------

    @staticmethod
    async def _probe(client) -> dict:
        """``status``, absorbing a restart: the redial may find a new boot
        id and fail the first call with ``ServerRestartedError``; the second
        runs against the new process."""
        try:
            return await client.call("status")
        except ServerRestartedError:
            return await client.call("status")

    async def _reprobe_and_reset(self) -> list:
        """Probe server 0, re-key the data plane through the dialer, probe
        server 1 — in this order: a restarted server 1 binds its control
        port only once server 0 has redialed its plane — and return the
        servers whose boot id changed, learning both (a first boot id is
        learned, not a restart)."""
        st0 = await self._probe(self.c0)
        await self.c0.call("plane_reset")
        st1 = await self._probe(self.c1)
        restarted = []
        for i, st in enumerate((st0, st1)):
            known = self._boot_ids.get(i)
            if known is not None and st["boot_id"] != known:
                restarted.append(i)
            self._boot_ids[i] = st["boot_id"]
        return restarted

    async def _recover(self, keys0, keys1, stash) -> int:
        """Bring both servers back to one state after a control-plane,
        data-plane or server loss; returns the next round's base level.
        With a stash: re-key the plane, re-upload the keys of a restarted
        server only (no reset: it would delete the very checkpoints), and
        ``tree_restore`` both to the stash level.  Without one: reset,
        upload, and start the tree again."""
        t0 = time.perf_counter()
        restarted = await self._reprobe_and_reset()
        if stash is None:
            await self._both("reset")
            await self.upload_keys(keys0, keys1)
            await self._start_tree()
            self.emit("resilience.restarted_from_scratch", restarted_servers=restarted)
            return 0
        level = stash["level"]
        t1 = time.perf_counter()
        for i in restarted:
            await self.upload_keys(keys0, keys1, which=i)
        t2 = time.perf_counter()
        r0, r1 = await self._both("tree_restore", {"level": level})
        if int(r0["level"]) != level or int(r1["level"]) != level:
            raise RuntimeError(f"restored levels diverge: s0={r0['level']} s1={r1['level']} "
                               f"leader stash={level}")
        self.paths = stash["paths"].copy()
        self.n_nodes = stash["n_nodes"]
        self.buckets = list(stash["buckets"])
        t3 = time.perf_counter()
        self.emit("resilience.restored", level=level, restarted_servers=restarted,
                  probe_s=t1 - t0, reupload_s=t2 - t1, restore_s=t3 - t2)
        # a checkpoint banks the state after the round based at ``level``
        return level + min(self.cfg.crawl_radix_bits, self.cfg.data_len - level)

    async def run_supervised(self, nreqs: int, keys0: ibdcf.IbDcfKeyBatch,
                             keys1: ibdcf.IbDcfKeyBatch, *, checkpoint_every: int = 8,
                             warmup: bool = False, warm_buckets=None) -> CrawlResult:
        """The fault-tolerant twin of :meth:`run`, owning the whole crawl
        (``reset``, upload, the optional warmup over ``warm_buckets``, the
        rounds, the final shares), since recovery needs the keys (the wire
        form).  After each round ending on a multiple of
        ``checkpoint_every`` levels both servers checkpoint; a server that
        cannot (no checkpoint directory) turns checkpointing off, and a
        recovery then starts over.  Any transport loss, restart or verb
        failure rolls both back (:meth:`_recover`, at most
        ``MAX_RECOVERIES`` times) and re-runs the lost rounds: the result is
        bit-identical to a fault-free crawl's."""
        cfg = self.cfg
        d, L, k = cfg.n_dims, cfg.data_len, cfg.crawl_radix_bits
        thresh = max(1, int(cfg.threshold * nreqs))
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}
        t0 = time.perf_counter()
        await self._both("reset")
        await self.upload_keys(keys0, keys1)
        self.seconds["upload"] = time.perf_counter() - t0
        if warmup:
            t0 = time.perf_counter()
            await self.warmup(warm_buckets)
            self.seconds["warmup"] = time.perf_counter() - t0
        t_levels = time.perf_counter()
        await self._start_tree()
        self._boot_ids = {0: self.c0.boot_id, 1: self.c1.boot_id}
        stash = None  # the leader's bookkeeping at the last checkpoint
        kept = np.zeros(0, np.uint32)
        ckpt_enabled = True
        level = 0
        while level < L:
            r = min(k, L - level)
            try:
                kept = await self._run_one_level(level, nreqs, thresh)
                if kept is None:
                    self.seconds["levels"] = time.perf_counter() - t_levels
                    return CrawlResult(paths=np.zeros((0, d, level + r), bool),
                                       counts=np.zeros(0, np.uint32))
                if ckpt_enabled and level + r < L and (level + r) % checkpoint_every == 0:
                    try:
                        await self._both("tree_checkpoint", {"level": level})
                        stash = {"level": level, "paths": self.paths.copy(),
                                 "n_nodes": self.n_nodes, "counts": kept.copy(),
                                 "buckets": list(self.buckets)}
                        self.counters["crawl_checkpoints"] += 1
                    except RuntimeError as e:  # no FHH_CKPT_DIR: supervise without
                        ckpt_enabled = False
                        self.emit("resilience.checkpoint_disabled", error=str(e))
                level += r
            except (ConnectionError, TimeoutError, RuntimeError) as err:
                t_rec = time.perf_counter()
                while True:
                    self.counters["recoveries"] += 1
                    attempt = self.counters["recoveries"]
                    self.emit("resilience.recover", level=level, attempt=attempt,
                              error=f"{type(err).__name__}: {err}")
                    if attempt > MAX_RECOVERIES:
                        raise err
                    try:
                        level = await self._recover(keys0, keys1, stash)
                        break
                    except (ConnectionError, TimeoutError, RuntimeError) as e2:
                        err = e2  # the recovery failed: another round of it
                kept = stash["counts"].copy() if stash is not None else np.zeros(0, np.uint32)
                self.counters["levels_rerun"] += 1
                self.seconds["recover"] += time.perf_counter() - t_rec
        self.seconds["levels"] = time.perf_counter() - t_levels
        # the final reconstruction, as in run() (final_shares is read-only:
        # the client's replay covers a transient loss here)
        f0, f1 = await self._both("final_shares")
        v = F255.np_sub(f0["shares"], f1["shares"])
        final = v[..., 0]
        if v[..., 1:].any() or not np.array_equal(final, kept):
            raise RuntimeError("final share reconstruction mismatch")
        return CrawlResult(paths=self.paths, counts=final)
