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

Malicious mode (the sketch keys ride the upload): each round but the one
based at level 1 opens with ``sketch_verify`` on both servers, so a
failing client's liveness flips before the round's counts are taken, and
the crawl ends with the F255 leaf check, which emits
``sketch.leaf_forgery`` with the clients it newly excludes; ``alive``
keeps server 0's last liveness vector.  Supervised, it banks an init
checkpoint (level -1) before any Beaver slab opens and refuses, before
touching a server, to start a sketch crawl over from scratch.

Servers with data shards (``server_data_devices``) answer as unsharded
ones do; a recovery tells a device loss from a server loss by the growth
of a server's ``mesh.faults`` under the same boot id and emits
``resilience.loss_classified`` when it found either.

Streaming ingestion (:class:`WindowedIngest`): clients' submissions go
through server 0's admission gate and are mirrored to server 1 into
tumbling windows; each sealed window is crawled by :meth:`RpcLeader.run`
while the next one fills, and a server restart is recovered from the
ingest-only checkpoint and the leader's journal.  A windowed collection
moves between server pairs at a window boundary
(:meth:`WindowedIngest.migrate`), or off a dead pair from its newest
ingest checkpoint (:meth:`WindowedIngest.failover_to`); ``protocol/fleet.py``
decides where.

Many collections on one server pair (:class:`MultiCollectionDriver`): one
client pair and one :class:`RpcLeader` a collection, each client's hello
naming its collection, all crawled concurrently.

Telemetry (JAX leader_rpc.py): each leader owns a registry ``leader`` (or
``leader:{collection}``), which its clients' control bytes count on, with a
``level`` span a round (its seconds also the ``level_latency`` histogram),
the ``upload_keys`` and ``warmup`` spans, the survivors, the pipeline's
figures and the supervised crawl's counters; a crawl is one trace
(``trace.root("crawl")``) and, with ``FHH_PROFILE`` and no level list, one
profile capture.  The windowed ingest owns ``ingest`` (or
``ingest:{collection}``): an ``ingest`` span a window from its first
submission to its seal, the admission counters and the ``ingest_admit``
latency, a ``window_crawl`` span and the ``seal_to_hitters`` latency, a
window one trace (``trace.root("window")``).
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import time

import numpy as np

from ..obs import metrics as obsmetrics
from ..obs import trace as obstrace
from ..ops import ibdcf
from ..ops.fields import F255, FE62
from ..resilience import policy as respolicy
from ..utils import guards
from ..utils.config import Config
from . import collect
from .driver import CrawlResult
from .rpc import CollectorClient, ServerRestartedError

UPLOAD_WINDOW = 256  # add_keys chunks in flight per upload (leader.rs:340-364 keeps 1000)


COUNTERS = ("recoveries", "levels_rerun", "shards_rerun", "crawl_checkpoints",
            "pipeline_faults")
MAX_RECOVERIES = 4  # rollbacks a supervised crawl survives (the JAX leader's default)


class RpcLeader:
    def __init__(self, cfg: Config, client0: CollectorClient, client1: CollectorClient,
                 emit=None):
        self.cfg = cfg
        self.c0, self.c1 = client0, client1
        self.emit = emit or (lambda event, **kw: None)
        self.paths: np.ndarray | None = None
        self.n_nodes = 0
        self.buckets: list = []  # frontier bucket per round
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}
        # the leader's registry, named for a non-default collection; the
        # clients predate it, so their control bytes are rebound onto it
        self.collection = getattr(client0, "collection", None) or "default"
        self.obs = obsmetrics.Registry("leader" if self.collection == "default"
                                       else f"leader:{self.collection}")
        for c in (client0, client1):
            if c is not None:
                c.obs = self.obs
        # the supervised crawl's seconds: reset and upload, warmup, the
        # rounds (re-runs and recoveries included), recoveries alone
        self.seconds = {"upload": 0.0, "warmup": 0.0, "levels": 0.0, "recover": 0.0}
        self._boot_ids: dict = {}  # last known server boot ids
        self._mesh_faults: dict = {}  # last seen mesh.faults count per server
        self.has_sketch = False  # the uploaded keys carry sketch keys (malicious mode)
        self.alive = None  # server 0's client liveness after the latest sketch_verify

    @property
    def counters(self) -> dict:
        """The supervised crawl's :data:`COUNTERS`, from the registry."""
        return {c: int(self.obs.counter_value(c)) for c in COUNTERS}

    @staticmethod
    async def _all(*coros):
        """Gather that cancels the other calls when one fails, and raises
        the first failure."""
        tasks = [asyncio.ensure_future(c) for c in coros]
        # fhh-lint: disable=unbounded-await (every child is a client call
        # bounded by its own per-verb wall-clock budget; a second timeout
        # here would race the real one)
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
                          sketch0=None, sketch1=None, which: int | None = None):
        """Upload both parties' keys in ``addkey_batch_size`` chunks, at most
        ``UPLOAD_WINDOW`` in flight, refilled as each completes.  Keys are
        the wire form (``ibdcf.keys_to_numpy``); in malicious mode each
        party's sketch keys (``sketch.sketch_to_numpy``, 16 leaves) ride the
        same chunks.  ``which`` (0 or 1) uploads to that server only:
        recovery re-seeding a restarted one."""
        n = keys0.cw_seed.shape[0]
        bs = max(1, self.cfg.addkey_batch_size)
        if which is None:
            self.has_sketch = sketch0 is not None
        sem = asyncio.Semaphore(UPLOAD_WINDOW)
        targets = [(i, c, k, sk) for i, c, k, sk in ((0, self.c0, keys0, sketch0),
                                                     (1, self.c1, keys1, sketch1))
                   if which in (None, i)]

        async def send_one(client, keys, sketch, sl):
            async with sem:  # the chunk is cut and pickled inside the window
                await client.call("add_keys", {
                    "keys": tuple(leaf[sl] for leaf in keys),
                    "sketch": None if sketch is None else [leaf[sl] for leaf in sketch]})

        # cancel on the first failure: an orphaned add_keys replay landing
        # after a recovery's reset would append a chunk twice
        with self.obs.span("upload_keys"):
            await self._all(*(send_one(c, k, sk, slice(lo, min(lo + bs, n)))
                              for lo in range(0, n, bs) for _, c, k, sk in targets))
        self.obs.count("keys_uploaded", n)

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
        with self.obs.span("warmup"):
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
                self.obs.count("shards_rerun", level=level)
            # fhh-lint: disable=host-sync-in-hot-loop (wire responses:
            # already host numpy off the control socket, no device sync)
            parts0.append(np.asarray(s0))
            # fhh-lint: disable=host-sync-in-hot-loop (wire response)
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
        # fhh-lint: disable=unbounded-queue (bounded by construction: at most `depth` span tasks live at once — the refill below only appends after the head pops)
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
                # fhh-lint: disable=host-sync-in-hot-loop (wire response)
                parts0.append(np.asarray(s0))
                # fhh-lint: disable=host-sync-in-hot-loop (wire response)
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
        level = int(req["level"])
        overlap = max(0.0, busy - (time.perf_counter() - t_level))
        self.pipeline["depth"] = depth
        self.pipeline["overlap_s"] += overlap
        self.pipeline["stalls"] += stalls
        self.obs.gauge("pipeline_depth", depth, level=level)
        self.obs.timer_add("pipeline_overlap", overlap, level=level)
        if stalls:
            self.obs.count("pipeline_stalls", stalls, level=level)
        return np.concatenate(parts0, axis=0), np.concatenate(parts1, axis=0)

    async def _quiesce_after_pipeline_fault(self, level: int, err) -> None:
        """After a pipelined level's window is cancelled: break any exchange
        wedged by the fault (a span that reached one server leaves the other
        blocked on a plane recv, holding its verb lock; ``plane_break`` runs
        outside it), re-key the plane and check that neither server
        restarted.  The caller re-runs the level; the servers' span caches
        are overwritten, so the re-run is bit-identical."""
        self.obs.count("pipeline_faults", level=level)
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
                self.obs.count("shards_rerun", level=int(req["level"]))
                self.emit("resilience.shard_rerun", level=int(req["level"]),
                          span=req.get("shard"), attempt=attempt,
                          error=f"{type(err).__name__}: {err}")
                await asyncio.sleep(pol.delay(attempt - 1))

    async def _sketch_gate(self, level: int):
        """Malicious mode: ``sketch_verify`` on both servers before a
        round's crawl, so failing clients' liveness flips before its counts
        are taken — at level 0 the full depth-1 check, at every other round
        base but 1 the depths the last prune stored (depth 1 is the level-0
        check's).  -> the liveness vector, or None when nothing ran."""
        if not self.has_sketch or level == 1:
            return None
        a0, _ = await self._both("sketch_verify", {"level": level})
        self.alive = np.asarray(a0)
        return self.alive

    async def _leaf_check(self, alive_before_leaf) -> None:
        """Malicious mode, after the crawl: the F255 leaf-payload check of
        the surviving leaves; ``sketch.leaf_forgery`` counts the clients it
        newly excludes (one caught earlier is no leaf forgery).  data_len 1
        skips it: the level-0 check was the leaf check."""
        if not self.has_sketch or self.cfg.data_len <= 1:
            return
        a0, _ = await self._both("sketch_verify", {"level": self.cfg.data_len})
        a0 = np.asarray(a0)
        prev = alive_before_leaf if alive_before_leaf is not None else np.ones_like(a0)
        if np.any(prev & ~a0):
            self.emit("sketch.leaf_forgery", new_exclusions=int(np.sum(prev & ~a0)))
        self.alive = a0

    async def _run_one_level(self, level: int, nreqs: int, thresh: int):
        """One verify -> crawl -> reconstruct -> threshold -> prune round
        over bit levels ``[level, level + r)``; returns (the surviving nodes'
        counts, or None when the crawl died out; the liveness after this
        round's sketch check, or None)."""
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        r = min(cfg.crawl_radix_bits, L - level)
        last = level + r == L
        alive = await self._sketch_gate(level)
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
            return None, alive
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
        self.obs.gauge("survivors", n_alive, level=level)
        return counts[parent[:n_alive], pattern[:n_alive]], alive

    async def _start_tree(self) -> None:
        await self._both("tree_init", {"root_bucket": 1})
        self.paths = np.zeros((1, self.cfg.n_dims, 0), bool)
        self.n_nodes = 1
        self.buckets = [1]

    async def _level(self, level: int, nreqs: int, thresh: int):
        """One round in a ``level`` span, its seconds also the
        ``level_latency`` histogram's."""
        with self.obs.span("level", level=level) as sp:
            out = await self._run_one_level(level, nreqs, thresh)
        self.obs.observe("level_latency", sp.seconds)
        return out

    async def run(self, nreqs: int) -> CrawlResult:
        """The whole crawl on the uploaded keys: one trace, and with
        ``FHH_PROFILE`` (no level list) one profile capture."""
        with obstrace.root("crawl"), obstrace.profile_capture("crawl"):
            return await self._run(nreqs)

    async def _run(self, nreqs: int) -> CrawlResult:
        cfg = self.cfg
        d, L = cfg.n_dims, cfg.data_len
        await self._start_tree()
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}
        thresh = max(1, int(cfg.threshold * nreqs))
        k = cfg.crawl_radix_bits
        alive_before_leaf = None  # the liveness after the latest sketch check
        for level in range(0, L, k):
            kept, alive = await self._level(level, nreqs, thresh)
            if alive is not None:
                alive_before_leaf = alive
            if kept is None:
                return CrawlResult(paths=np.zeros((0, d, min(L, level + k)), bool),
                                   counts=np.zeros(0, np.uint32))
        await self._leaf_check(alive_before_leaf)
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
        # device loss against server loss (JAX leader_rpc.py:613-632): a
        # server of the same boot whose mesh fault count grew since the last
        # look lost a data device, not itself — it re-sharded in place, or
        # escalated for want of a checkpoint; the counts are cumulative per
        # boot, so only the growth counts
        device_loss = []
        for i, st in enumerate((st0, st1)):
            f = int((st.get("mesh") or {}).get("faults") or 0)
            if i not in restarted and f > self._mesh_faults.get(i, 0):
                device_loss.append(i)
            self._mesh_faults[i] = f
        if restarted or device_loss:
            self.emit("resilience.loss_classified", server_loss=restarted,
                      device_loss=device_loss)
        return restarted

    async def _recover(self, keys0, keys1, sketch0, sketch1, stash) -> int:
        """Bring both servers back to one state after a control-plane,
        data-plane or server loss; returns the next round's base level.
        With a stash: re-key the plane, re-upload the keys (and sketch keys)
        of a restarted server only (no reset: it would delete the very
        checkpoints), and ``tree_restore`` both to the stash level; the
        sketch's init stash (level -1) resumes at level 0.  Without one:
        reset, upload, and start the tree again — refused, before any
        server is touched, for a sketch crawl: re-uploading the same Beaver
        slabs under a fresh coin flip would leak ``<r - r', x>``."""
        if stash is None and sketch0 is not None:
            raise ValueError(
                "sketch crawl cannot restart from scratch: re-opening the same Beaver slabs "
                "under a fresh challenge root would leak <r - r', x> — configure FHH_CKPT_DIR "
                "so recovery can roll back, or rerun with fresh sketch keys")
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
            await self.upload_keys(keys0, keys1, sketch0, sketch1, which=i)
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
        if level < 0:  # the sketch's init checkpoint
            return 0
        return level + min(self.cfg.crawl_radix_bits, self.cfg.data_len - level)

    async def run_supervised(self, nreqs: int, keys0: ibdcf.IbDcfKeyBatch,
                             keys1: ibdcf.IbDcfKeyBatch, sketch0=None, sketch1=None, *,
                             checkpoint_every: int = 8, warmup: bool = False,
                             warm_buckets=None) -> CrawlResult:
        """The fault-tolerant twin of :meth:`run`, owning the whole crawl
        (``reset``, upload, the optional warmup over ``warm_buckets``, the
        rounds, the final shares), since recovery needs the keys (the wire
        form, and in malicious mode the sketch keys ``sketch0``/``sketch1``).
        After each round ending on a multiple of ``checkpoint_every`` levels
        both servers checkpoint; a server that cannot (no checkpoint
        directory) turns checkpointing off, and a recovery then starts over.
        Any transport loss, restart or verb failure rolls both back
        (:meth:`_recover`, at most ``MAX_RECOVERIES`` times) and re-runs the
        lost rounds: the result is bit-identical to a fault-free crawl's.
        A sketch crawl banks an init checkpoint (level -1) after
        ``tree_init``, before any Beaver slab opens, since it may never
        start over: a re-run level then replays its ratcheted challenge.
        The whole crawl, recoveries included, is one trace."""
        with obstrace.root("crawl"), obstrace.profile_capture("crawl"):
            return await self._run_supervised(
                nreqs, keys0, keys1, sketch0, sketch1, checkpoint_every=checkpoint_every,
                warmup=warmup, warm_buckets=warm_buckets)

    async def _run_supervised(self, nreqs, keys0, keys1, sketch0, sketch1, *,
                              checkpoint_every, warmup, warm_buckets) -> CrawlResult:
        cfg = self.cfg
        d, L, k = cfg.n_dims, cfg.data_len, cfg.crawl_radix_bits
        if cfg.malicious and sketch0 is None:
            # refused before any server is touched: uploading keys without
            # their sketch keys would run a malicious collection semi-honest
            raise ValueError("run_supervised in malicious mode needs the sketch key batches "
                             "(pass sketch0/sketch1)")
        thresh = max(1, int(cfg.threshold * nreqs))
        for c in COUNTERS:  # zero-touched: a fault-free run reports its zeros
            self.obs.count(c, 0)
        self.pipeline = {"depth": 0, "overlap_s": 0.0, "stalls": 0}
        t0 = time.perf_counter()
        await self._both("reset")
        await self.upload_keys(keys0, keys1, sketch0, sketch1)
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
        alive_before_leaf = None  # the liveness after the latest sketch check
        ckpt_enabled = True
        if sketch0 is not None:
            try:
                await self._both("tree_checkpoint", {"level": -1})
                stash = {"level": -1, "paths": self.paths.copy(), "n_nodes": 1,
                         "counts": kept.copy(), "buckets": list(self.buckets), "alive": None}
            except RuntimeError as e:  # no FHH_CKPT_DIR: a fault then ends the crawl
                ckpt_enabled = False
                self.emit("resilience.checkpoint_disabled", error=str(e))
        level = 0
        attempts = 0  # this run's recoveries
        while level < L:
            r = min(k, L - level)
            try:
                kept, alive = await self._level(level, nreqs, thresh)
                if alive is not None:
                    alive_before_leaf = alive
                if kept is None:
                    self.seconds["levels"] = time.perf_counter() - t_levels
                    return CrawlResult(paths=np.zeros((0, d, level + r), bool),
                                       counts=np.zeros(0, np.uint32))
                if ckpt_enabled and level + r < L and (level + r) % checkpoint_every == 0:
                    try:
                        await self._both("tree_checkpoint", {"level": level})
                        stash = {"level": level, "paths": self.paths.copy(),
                                 "n_nodes": self.n_nodes, "counts": kept.copy(),
                                 "buckets": list(self.buckets),
                                 "alive": None if alive_before_leaf is None
                                 else alive_before_leaf.copy()}
                        self.obs.count("crawl_checkpoints", level=level)
                    except RuntimeError as e:  # no FHH_CKPT_DIR: supervise without
                        ckpt_enabled = False
                        self.emit("resilience.checkpoint_disabled", error=str(e))
                level += r
            except (ConnectionError, TimeoutError, RuntimeError) as err:
                t_rec = time.perf_counter()
                while True:
                    self.obs.count("recoveries")
                    attempts += 1
                    attempt = attempts
                    self.emit("resilience.recover", level=level, attempt=attempt,
                              error=f"{type(err).__name__}: {err}")
                    if attempt > MAX_RECOVERIES:
                        raise err
                    try:
                        level = await self._recover(keys0, keys1, sketch0, sketch1, stash)
                        break
                    except (ConnectionError, TimeoutError, RuntimeError) as e2:
                        err = e2  # the recovery failed: another round of it
                kept = stash["counts"].copy() if stash is not None else np.zeros(0, np.uint32)
                alive_before_leaf = (None if stash is None or stash["alive"] is None
                                     else stash["alive"].copy())
                self.obs.count("levels_rerun")
                self.seconds["recover"] += time.perf_counter() - t_rec
        await self._leaf_check(alive_before_leaf)
        self.seconds["levels"] = time.perf_counter() - t_levels
        # the final reconstruction, as in run() (final_shares is read-only:
        # the client's replay covers a transient loss here)
        f0, f1 = await self._both("final_shares")
        v = F255.np_sub(f0["shares"], f1["shares"])
        final = v[..., 0]
        if v[..., 1:].any() or not np.array_equal(final, kept):
            raise RuntimeError("final share reconstruction mismatch")
        return CrawlResult(paths=self.paths, counts=final)


# -- streaming ingest: the leader of the windowed front door (JAX leader_rpc.py:897-1369)

# a client's submit backoff: quick first retries (token refill horizons are
# sub-second at sane rates) and many attempts: a flooding client spends its
# time here, sleeping, so it stalls itself and not the crawl
INGEST_POLICY = respolicy.RetryPolicy(base_s=0.02, cap_s=0.5, factor=2.0, attempts=16)

INGEST_COUNTERS = ("ingest_admitted", "ingest_shed_subs", "ingest_rejected", "ingest_shed",
                   "ingest_windows", "ingest_recoveries", "ingest_journal_replays",
                   "ingest_migrations", "ingest_failovers")


class IngestOverloadedError(RuntimeError):
    """Every backed-off retry of one submission was answered Overloaded:
    the caller floods faster than the front door will ever admit.  Not
    transport-shaped on purpose: retrying the call cannot help, the caller
    must slow down or drop."""


# The lock-discipline sanitizer's map of the ingest driver's state (JAX
# leader_rpc.py:917-922): the window counter, the journal and the seal
# stats belong to the submit lock.
_INGEST_GUARDS = {
    "window": "_submit_lock",
    "_journal": "_submit_lock",
    "_journaled": "_submit_lock",
    "_sealed": "_submit_lock",
}


class WindowedIngest:
    """The leader's side of the streaming front door: ``submit_keys`` into
    tumbling windows (:meth:`submit`), ``window_seal`` at each boundary
    (:meth:`seal_window`), and :meth:`crawl_window` running the ordinary
    round loop (:meth:`RpcLeader.run`) on a sealed window's frozen pool while
    later submissions keep landing.

    Server 0 is the gate: its verdict (an admitted slot, shed, or
    Overloaded) comes first and is then mirrored to server 1, so the two
    pools stay positionally identical whatever order frames arrive in.  An
    Overloaded verdict backs off under ``policy`` (at least the gate's
    ``retry_after_s``) and tries again.

    Recovery: every admitted or shed submission is journaled until its
    window's crawl completes.  After a server restart the leader restores
    that server's last ingest-only checkpoint (``tree_restore`` of level -1,
    banked at each seal: pools, recorded verdicts, the reservoir's state),
    replays the journal in mirror form (the recorded verdicts make it
    exactly-once), re-seals the sealed windows with their banked roots,
    and re-runs the window's crawl, whose result equals a batch crawl over
    the same admitted keys.  A recovery that fails (a restarted server
    still starting) is tried again at the caller's next attempt, bounded
    per call, where the JAX ``crawl_window`` gives up at once.
    ``counters`` reads ``INGEST_COUNTERS`` from its registry ``obs``;
    ``windows`` keeps each crawled window's crawl seconds, recoveries and
    seal-to-hitters seconds."""

    def __init__(self, lead: RpcLeader, *, policy=None, checkpoint=True):
        self.lead = lead
        self.cfg = lead.cfg
        self.window = 0
        self.policy = policy or INGEST_POLICY
        # a registry of its own, so the heartbeat names the ingest phase apart
        # from the crawl's; a non-default collection is named in it
        coll = getattr(lead, "collection", None) or "default"
        self.obs = obsmetrics.Registry("ingest" if coll == "default" else f"ingest:{coll}")
        self._span_ctx = None  # the open window's "ingest" span
        self.windows: dict = {}  # window -> {"crawl_s", "recoveries", "seal_to_hitters_s"}
        self._journal: dict = {}  # window -> submission records
        self._journaled: set = set()  # sub_ids already journaled
        self._sealed: dict = {}  # window -> the gate's seal stats
        self._n_subs = 0
        self._ckpt = bool(checkpoint)
        self._have_ckpt = False
        # the mirror applies verdicts in the gate's order (pools are
        # positional), so each gate-and-mirror pair holds this lock; backoff
        # sleeps happen outside it, so a rejected client stalls only itself
        self._submit_lock = asyncio.Lock()
        # one recovery at a time: a submit and a crawl may see one fault
        self._recover_lock = asyncio.Lock()
        for i, c in ((0, lead.c0), (1, lead.c1)):  # restart detection's baseline
            if lead._boot_ids.get(i) is None:
                lead._boot_ids[i] = getattr(c, "boot_id", None)
        # last: the sanitizer wraps the state already built (a no-op unless
        # FHH_DEBUG_GUARDS=1 or cfg.debug_guards)
        guards.install(self, _INGEST_GUARDS, force=bool(getattr(self.cfg, "debug_guards", False)))

    @property
    def counters(self) -> dict:
        """:data:`INGEST_COUNTERS`, from the registry."""
        return {c: int(self.obs.counter_value(c)) for c in INGEST_COUNTERS}

    # fhh-race: atomic (telemetry-only read of the window id for the span label: one event-loop slice, and a label one boundary stale costs nothing)
    def _ensure_span(self) -> None:
        """Open the current window's ``ingest`` span at its first submission
        (closed at its seal: a ``with`` cannot straddle the two calls)."""
        if self._span_ctx is None:
            with guards.unguarded("telemetry-only window-id read for the span label: one "
                                  "event-loop slice, a label one boundary stale costs nothing"):
                w = self.window
            # fhh-lint: disable=span-discipline (explicitly managed context: the ingest span opens at the first submit and _exit_span closes it at the seal boundary — a with-block cannot straddle the two call sites)
            self._span_ctx = self.obs.span("ingest", level=w)
            self._span_ctx.__enter__()

    def _exit_span(self) -> None:
        if self._span_ctx is not None:
            self._span_ctx.__exit__(None, None, None)
            self._span_ctx = None

    async def submit(self, client_id, k0_chunk, k1_chunk, *, sk0_chunk=None, sk1_chunk=None,
                     sub_id: str | None = None) -> dict:
        """Submit one client's key-share chunks (``k0_chunk`` to server 0,
        ``k1_chunk`` to server 1; wire leaves) into the current window, in
        malicious mode with the 16 sketch leaves of each party's share
        (``sk0_chunk``/``sk1_chunk``).  Blocks through Overloaded verdicts
        under the backoff policy and returns the gate's verdict (admitted or
        shed); raises :class:`IngestOverloadedError` when every attempt was
        rejected."""
        if sub_id is None:
            # one id per logical submission, reused by transport replays and
            # recovery re-submissions so the servers' recorded verdicts
            # dedup them; a backed-off retry that straddles a seal lands in
            # the new window under the same id
            self._n_subs += 1
            sub_id = f"{self.lead.c0.session_id}:{self._n_subs}"
        k0_chunk = tuple(np.asarray(a) for a in k0_chunk)
        k1_chunk = tuple(np.asarray(a) for a in k1_chunk)
        if (sk0_chunk is None) != (sk1_chunk is None):
            raise ValueError("sketch chunks come in pairs: pass sk0_chunk and sk1_chunk "
                             "(one per server's share) or neither")
        if sk0_chunk is not None:
            sk0_chunk = [np.asarray(a) for a in sk0_chunk]
            sk1_chunk = [np.asarray(a) for a in sk1_chunk]
        n_keys = int(k0_chunk[0].shape[0])
        self._ensure_span()
        t_admit = time.perf_counter()
        attempt = faults = 0
        while True:
            # the window id is read under the lock: a seal may have advanced
            # it while this task waited
            async with self._submit_lock:
                w = self.window
                base = {"window": w, "sub_id": sub_id, "client_id": str(client_id)}
                # the gate and its mirror (and a fault's recovery) under one
                # hold: nothing, not even a seal, may land between them
                while True:
                    try:
                        r0 = await self.lead.c0.call(
                            "submit_keys", dict(base, keys=k0_chunk, sketch=sk0_chunk))
                        if r0.get("overloaded"):
                            break
                        rec = {"sub_id": sub_id, "client_id": str(client_id), "window": w,
                               "slot": r0.get("slot"), "shed": bool(r0.get("shed")),
                               "k0": k0_chunk, "k1": k1_chunk, "sk0": sk0_chunk,
                               "sk1": sk1_chunk}
                        # journal before the mirror: a restart mid-mirror is
                        # replayed from it, and a retried gate call (a dup)
                        # must not journal twice
                        if sub_id not in self._journaled:
                            self._journal.setdefault(w, []).append(rec)
                            self._journaled.add(sub_id)
                        await self.lead.c1.call("submit_keys", dict(
                            base, keys=k1_chunk, sketch=sk1_chunk,
                            mirror={"slot": rec["slot"], "shed": rec["shed"]}))
                        break
                    except respolicy.TRANSIENT_ERRORS:
                        # a restart or a lost transport: recover, then the
                        # same sub_id again (recorded verdicts: exactly once)
                        faults += 1
                        if faults > 8:
                            raise
                        await self._recover_or_retry()
            if not r0.get("overloaded"):
                break
            self.obs.count("ingest_rejected", level=w)
            if r0.get("scope") == "burst":  # no refill horizon ever covers it
                raise IngestOverloadedError(
                    f"submission {sub_id} ({n_keys} keys) exceeds the gate's burst allowance "
                    "— split the chunk or raise ingest_burst_keys")
            attempt += 1
            if attempt >= self.policy.attempts:
                raise IngestOverloadedError(
                    f"submission {sub_id} rejected {attempt} times (last scope: "
                    f"{r0.get('scope')}) — client is over the front door's sustained capacity")
            await asyncio.sleep(max(float(r0.get("retry_after_s", 0.0)),
                                    self.policy.delay(attempt - 1)))
        # the window the submission landed in: the id read under the lock
        if rec["shed"]:
            # fhh-lint: disable=stale-read-across-await (deliberate snapshot: the stats must label the window this submission actually LANDED in — the admission-time id banked under the lock; a post-await re-read would mislabel it with whatever window is current now)
            self.obs.count("ingest_shed_subs", level=w)
        else:
            # fhh-lint: disable=stale-read-across-await (deliberate snapshot, same contract as the shed branch: the admitted count labels the window this submission LANDED in — the id banked under the lock at gate time, not whatever window is current after the backoff awaits)
            self.obs.count("ingest_admitted", n_keys, level=w)
        self.obs.observe("ingest_admit", time.perf_counter() - t_admit)
        return r0

    async def seal_window(self) -> dict:
        """Freeze the current window on both servers, check that their pools
        agree (keys, submissions, the committed root), bank the ingest-only
        checkpoint (level -1), and open the next window.  -> the gate's
        seal stats."""
        faults = 0
        while True:
            # the whole boundary under one hold: it must not race a
            # half-mirrored submission, and the id read outside the lock
            # could re-seal a window another boundary already passed
            async with self._submit_lock:
                w = self.window
                try:
                    r0, r1 = await self.lead._both("window_seal", {"window": w})
                except respolicy.TRANSIENT_ERRORS:
                    faults += 1
                    if faults > 8:
                        raise
                    await self._recover_or_retry()
                    continue
                # a root mismatch would silently exclude every honest client
                if (r0["keys"], r0["subs"], r0.get("sk_root")) != (
                        r1["keys"], r1["subs"], r1.get("sk_root")):
                    raise RuntimeError(f"window {w} pools diverged at seal: gate {r0} vs "
                                       f"mirror {r1}")
                self._sealed[w] = dict(r0, sealed_at=time.time())
                self.window = w + 1
                break
        self._exit_span()
        # the seal stats count the reservoir's replaced occupants too
        self.obs.count("ingest_shed", int(r0["shed_keys"]), level=w)
        self.obs.count("ingest_windows")
        self.lead.emit("ingest.window_boundary", window=w, keys=int(r0["keys"]),
                       subs=int(r0["subs"]), shed=int(r0["shed_keys"]),
                       rejected=int(r0["rejected"]))
        if self._ckpt:
            try:  # the rollback point of a kill mid-window
                await self.lead._both("tree_checkpoint", {"level": -1, "ingest_only": True})
                self._have_ckpt = True
            except RuntimeError as e:  # no FHH_CKPT_DIR: the journal replay covers it
                self._ckpt = False
                self.lead.emit("ingest.checkpoint_disabled", error=str(e))
        return r0

    async def crawl_window(self, w: int, *, max_recoveries: int = 4) -> CrawlResult:
        """The ordinary round loop over sealed window ``w``'s frozen pool
        (``window_load``, then :meth:`RpcLeader.run`); ingest into later
        windows goes on meanwhile (``submit_keys`` bypasses the servers'
        verb lock).  On a transport loss, a restart or a verb failure the
        ingest state is recovered, the window reloaded and its crawl run
        again: the pool is rebuilt exactly and the crawl is deterministic,
        so the result is too.  The window is one trace, the crawl a
        ``window_crawl`` span, and the seconds from the seal to the hitters
        go to the ``seal_to_hitters`` histogram."""
        with obstrace.root("window"):
            return await self._crawl_window(w, max_recoveries=max_recoveries)

    async def _crawl_window(self, w: int, *, max_recoveries: int) -> CrawlResult:
        async with self._submit_lock:
            stats = self._sealed.get(w)
        if stats is None:
            raise RuntimeError(f"crawl_window: window {w} is not sealed")
        nreqs = int(stats["keys"])
        recoveries = 0
        t0 = time.perf_counter()
        while True:
            try:
                l0, _ = await self.lead._both("window_load", {"window": w})
                # a malicious window's crawl runs the sketch gates: the batch
                # flow learns it at upload, the windowed one from the pool
                self.lead.has_sketch = bool(l0.get("sketch"))
                with self.obs.span("window_crawl", level=w):
                    res = await self.lead.run(nreqs)
                break
            except (ConnectionError, TimeoutError, RuntimeError) as err:
                recoveries += 1
                self.obs.count("ingest_recoveries")
                self.lead.emit("ingest.window_recover", window=w, attempt=recoveries,
                               error=f"{type(err).__name__}: {err}")
                if recoveries > max_recoveries:
                    raise
                # under the submit lock: the journal replay rebuilds pools
                # positionally, and a live gate-and-mirror pair landing
                # between replayed records would part the servers' slot orders
                async with self._submit_lock:
                    await self._recover_or_retry()
        # fhh-lint: disable=stale-read-across-await (deliberate snapshot: the SLO clock starts at the SEAL-time instant banked in the stats row — a sealed window's stats never mutate, and re-reading under the lock would return the identical row or None after the prune below)
        seal_s = max(0.0, time.time() - stats["sealed_at"])
        self.obs.observe("seal_to_hitters", seal_s)
        self.windows[w] = {"crawl_s": time.perf_counter() - t0, "recoveries": recoveries,
                           "seal_to_hitters_s": seal_s}
        # the window is crawled: its journal and seal stats (and any
        # earlier ones) are done
        async with self._submit_lock:
            for old in [k for k in self._journal if k <= w]:
                for rec in self._journal.pop(old):
                    self._journaled.discard(rec["sub_id"])
            for old in [k for k in self._sealed if k <= w]:
                del self._sealed[old]
        return res

    async def _recover_or_retry(self) -> None:
        """:meth:`_recover_ingest`, its failure left to the caller's next
        attempt: a restarted server may listen only after the data plane's
        redial ran out (its start-up takes seconds), and the next attempt
        probes again (each caller bounds its attempts)."""
        try:
            await self._recover_ingest()
        except (ConnectionError, TimeoutError, RuntimeError) as e:
            self.lead.emit("ingest.recover_failed", error=f"{type(e).__name__}: {e}")

    async def _recover_ingest(self) -> None:
        """Bring both servers' ingest state back to this leader's view:
        probe the boot ids and re-key the data plane, then for each
        restarted server restore its last ingest checkpoint, replay the
        journal (mirror form, recorded verdicts deduping) and re-seal the
        sealed windows with their banked roots.  The crawl state is the
        caller's: it reloads the window and runs the crawl again."""
        async with self._recover_lock:
            lead = self.lead
            restarted = await lead._reprobe_and_reset()
            for i in restarted:
                client = lead.c0 if i == 0 else lead.c1
                if self._have_ckpt:
                    try:
                        await client.call("tree_restore", {"level": -1})
                    except RuntimeError as e:
                        lead.emit("ingest.restore_failed", server=i, error=str(e))
                await self._replay_journal(client, i)
                for req in self._reseal_requests():
                    await client.call("window_seal", req)
                lead.emit("ingest.server_reseeded", server=i)

    def _reseal_requests(self) -> list:
        """``window_seal`` of every sealed window with its banked root: a
        pool rebuilt from the journal takes it, never a fresh root for the
        same slabs."""
        return [{"window": w} if self._sealed[w].get("sk_root") is None
                else {"window": w, "sk_root": self._sealed[w]["sk_root"]}
                for w in sorted(self._sealed)]

    async def _replay_journal(self, client, which: int) -> None:
        """Re-submit every journaled record to one server in mirror form (the
        recorded gate verdicts, no fresh admission): the records the
        restored checkpoint holds answer as duplicates, the rest rebuild
        the pool as it was."""
        replayed = 0
        for w in sorted(self._journal):
            for rec in self._journal[w]:
                await client.call("submit_keys", {
                    "window": rec["window"], "sub_id": rec["sub_id"],
                    "client_id": rec["client_id"],
                    "keys": rec["k0"] if which == 0 else rec["k1"],
                    "sketch": rec["sk0"] if which == 0 else rec["sk1"],
                    "mirror": {"slot": rec["slot"], "shed": rec["shed"]}})
                replayed += 1
        self.obs.count("ingest_journal_replays", replayed)

    # -- the fleet: live migration and failover (JAX leader_rpc.py:1368-1495) --

    async def _adopt(self, new_lead: RpcLeader) -> int:
        """Bind to ``new_lead``'s pair and complete its pools: the journal
        replayed to each server in mirror form (the recorded verdicts make
        it exactly-once), then the sealed windows sealed again with their
        banked roots.  -> the records replayed to each server."""
        new_lead.has_sketch = self.lead.has_sketch
        for i, c in ((0, new_lead.c0), (1, new_lead.c1)):
            new_lead._boot_ids[i] = getattr(c, "boot_id", None)
        self.lead = new_lead
        replayed = sum(len(v) for v in self._journal.values())
        await self._replay_journal(new_lead.c0, 0)
        await self._replay_journal(new_lead.c1, 1)
        for req in self._reseal_requests():
            await new_lead._both("window_seal", req)
        return replayed

    async def migrate(self, new_lead: RpcLeader) -> dict:
        """Move this collection onto ``new_lead``'s server pair mid-stream.

        The whole move holds ``_submit_lock`` then ``_recover_lock`` (the
        order submissions, seals and recoveries take), so no gate-and-mirror
        pair is half landed and no boundary half passed; the servers refuse
        to export mid-level besides.  In this order, so that a failure at
        any step leaves the source pair authoritative (its copy goes last):

        1. ``session_export`` on both source servers (stamped blobs);
        2. ``session_import`` on both destination servers (the stamps
           checked, everything validated before anything changes; each
           destination keys its own channel at its next plane verb);
        3. the driver bound to ``new_lead``, the journal replayed in mirror
           form (every in-flight submission lands once: the exported
           verdicts answer the rest as duplicates);
        4. the sealed windows sealed again with their original roots (a
           migrated malicious window opens the identical challenge);
        5. an ingest checkpoint banked on the destination, then the source
           copy retired on both servers.

        -> ``{"windows": the exported windows, "replayed": records}``."""
        async with self._submit_lock:
            async with self._recover_lock:
                old = self.lead
                x0 = await old.c0.call("session_export", {})
                x1 = await old.c1.call("session_export", {})
                await new_lead.c0.call("session_import", {
                    "path": x0["path"], "boot": x0["boot"], "epoch": x0["epoch"]})
                await new_lead.c1.call("session_import", {
                    "path": x1["path"], "boot": x1["boot"], "epoch": x1["epoch"]})
                replayed = await self._adopt(new_lead)
                if self._ckpt:
                    try:
                        await new_lead._both("tree_checkpoint",
                                             {"level": -1, "ingest_only": True})
                        self._have_ckpt = True
                    except RuntimeError as e:
                        self._ckpt = False
                        new_lead.emit("ingest.checkpoint_disabled", error=str(e))
                # last: the source copy goes only once the destination holds
                # the whole, re-sealed state
                await old.c0.call("session_export", {"retire": True, "epoch": x0["epoch"]})
                await old.c1.call("session_export", {"retire": True, "epoch": x1["epoch"]})
                windows = [int(w) for w in x0.get("windows", [])]
        self.obs.count("ingest_migrations")
        self.lead.emit("ingest.session_migrated", windows=windows, replayed=replayed)
        return {"windows": windows, "replayed": replayed}

    async def failover_to(self, new_lead: RpcLeader, *, level: int = -1) -> dict:
        """Move this collection off a dead pair onto ``new_lead``'s from its
        newest checkpoint in the shared store: :meth:`migrate` without the
        export and the retire.  Each destination server imports the
        ``level`` ingest blob (the one :meth:`seal_window` banks at every
        boundary), then the journal is replayed and the sealed windows
        sealed again with their roots.  A collection that never banked a
        checkpoint recovers from the journal alone.
        -> ``{"imported": any server imported a blob, "replayed": records}``."""
        async with self._submit_lock:
            async with self._recover_lock:
                imported = False
                if self._have_ckpt:
                    for c in (new_lead.c0, new_lead.c1):
                        try:
                            await c.call("session_import", {"level": level})
                            imported = True
                        except RuntimeError as e:
                            new_lead.emit("ingest.restore_failed", error=str(e))
                replayed = await self._adopt(new_lead)
        self.obs.count("ingest_failovers")
        self.lead.emit("ingest.session_failed_over", imported=imported, replayed=replayed)
        return {"imported": imported, "replayed": replayed}


# -- many collections on one server pair (JAX leader_rpc.py:1503-1590) --------


class MultiCollectionDriver:
    """Run many collections concurrently against one collector server pair.

    Each collection gets its own client pair, whose ``__hello__`` binds
    every connection to that collection's session on the servers
    (``protocol/sessions.py``), and its own :class:`RpcLeader`; all run on
    one event loop, so while one collection's level waits on the data plane
    another's expand takes the card (the servers' ``TenantScheduler``
    counts those stall fills).  Each result is bit-identical to a solo run
    of the same keys: independent trees, keys and OT streams per
    collection.  ``emit`` receives each leader's events with its
    ``collection``."""

    def __init__(self, cfg: Config, host0: str, port0: int, host1: str, port1: int, *,
                 emit=None):
        self.cfg = cfg
        self._addr0 = (host0, port0)
        self._addr1 = (host1, port1)
        self.emit = emit or (lambda event, **kw: None)
        self.leaders: dict = {}  # collection -> RpcLeader

    async def open(self, collection: str) -> RpcLeader:
        """Connect one collection's client pair and build its leader, after
        a ``reset`` of the collection on both servers."""
        c0 = await CollectorClient.connect(*self._addr0, collection=collection)
        c1 = await CollectorClient.connect(*self._addr1, collection=collection)
        lead = RpcLeader(self.cfg, c0, c1,
                         emit=lambda event, **f: self.emit(event, collection=collection, **f))
        await lead._both("reset")
        self.leaders[collection] = lead
        return lead

    async def close(self) -> None:
        for lead in self.leaders.values():
            for c in (lead.c0, lead.c1):
                await c.aclose()
        self.leaders.clear()

    async def run_collections(self, jobs: list, *, supervised: bool = True,
                              warmup: bool = False, checkpoint_every: int = 8,
                              warm_buckets=None) -> dict:
        """Run every job concurrently -> {collection: CrawlResult}.

        ``jobs``: dicts ``{collection, nreqs, keys0, keys1}`` (the wire form),
        with ``sketch0``/``sketch1`` in malicious mode.  ``supervised`` runs
        each through :meth:`RpcLeader.run_supervised` (checkpoints in the
        collection's own namespace, recovery per collection); otherwise the
        upload, the optional warmup (over ``warm_buckets``) and the rounds.
        One collection's failure does not stop the others: it is reported
        under its key as the exception raised."""

        async def one(job: dict):
            key = str(job["collection"])
            lead = self.leaders.get(key) or await self.open(key)
            if supervised:
                return await lead.run_supervised(
                    int(job["nreqs"]), job["keys0"], job["keys1"], job.get("sketch0"),
                    job.get("sketch1"), checkpoint_every=checkpoint_every, warmup=warmup,
                    warm_buckets=warm_buckets)
            await lead.upload_keys(job["keys0"], job["keys1"], job.get("sketch0"),
                                   job.get("sketch1"))
            if warmup:
                await lead.warmup(warm_buckets)
            return await lead.run(int(job["nreqs"]))

        keys = [str(j["collection"]) for j in jobs]
        done = await asyncio.gather(*(one(j) for j in jobs), return_exceptions=True)
        results = dict(zip(keys, done))
        failed = {k: r for k, r in results.items() if isinstance(r, BaseException)}
        if failed:
            self.emit("tenancy.collections_failed", collections=sorted(failed),
                      errors={k: f"{type(e).__name__}: {e}" for k, e in failed.items()})
        return results
