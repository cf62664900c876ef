#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # from the root of a checkout, one card
    python3 chip_smoke.py --profile    # also: device time by kernel per crawl

Phases (any failure raises, and the script exits non-zero):

1. build every CUDA kernel of the port from ``fuzzyheavyhitters_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold the keygen kernel bit-exact against its plain PyTorch version on the
   card, in both PRG bit modes: a 4096-client x L=512 chunk, and a chunk of
   K = 8,191 keys x L = 509 levels, off the kernel's block and tile sizes;
3. the main path at full size, two crawls through ``bin.mesh.run`` with both
   servers on the card: the BASELINE.json config-4 shape (zipf over 10,000
   sites, exponent 1.03, data_len 512, n_dims 1, ball 2, threshold 0.001,
   f_max 1024) at N = 196,608 clients, and the ``configs/config.json`` rides
   shape (n_dims 2, data_len 16) at N = 262,144.  Kernel launch counts are
   zeroed just before each crawl and read just after; every hitter's count
   must equal a plaintext recount from the sampled points.  Then the trusted
   covid crawl of the JAX package's ``bench.bench_covid``: 64 hot counties
   written from the seed into a centroid file, jitterless f64 lat/lon bits
   (data_len 64, n_dims 2, ball 1, threshold 0.01, f_max 2048) at N = 65,536
   clients, through ``ibdcf.gen_l_inf_ball`` and ``driver.Leader``; every
   hot county with its 3 x 3 ulp ball (at least 576 hitters) must survive;
4. after each crawl (the secure ones of phase 6 too), the expand kernel
   held bit-exact against its plain version on that crawl's real
   frontiers, re-crawled from its keys with the trusted exchange (the
   same counts, so the same frontiers): each time the frontier reaches a
   new width (so at the widest), and at the last level, which builds no
   child cache; each check is timed;
5. the keygen kernel held bit-exact against its plain version at each of
   the six crawls' shapes (all N x n_dims x 2 keys, L levels) and timed;
6. the secure exchange through ``bin.mesh.run``: ``config4_zipf_secure``
   (the config-4 shape with ``secure_exchange``, S = 2 so the 1-of-2^S OT
   kernels, at N = 8,192 — an eighth of the JAX package's one-chip secure
   shape),
   ``rides_secure_gc`` (``configs/config.json`` with ``secure_exchange`` and
   ``ot_path: "gc"``, S = 4, the garbled-circuit kernels, N = 262,144) and
   ``rides_secure`` (that config with ``ot_path: "auto"``, S = 4 on the
   ot2s kernels, N = 8,192: the engine a user of the config gets).
   Launches must be one per level of the path's two kernels and none of the
   other path's; every hitter count must equal the plaintext recount;
7. after each secure crawl, its kernels held bit-exact against their plain
   versions on that crawl's real inputs, replayed from its keys and
   sessions (the trusted exchange carries the frontier between the checked
   levels): at the widest FE62 level and at the F255 last level, each timed;
8. chunk checks of 1,048,576 tests, the pad index starting at 2^32 - 1000 so
   it wraps inside the batch: ot2s at S in {2, 4, 6} and the GC kernels at
   S in {2, 4, 6, 8, 16}, each at W in {4, 8}; then the GC timing line
   (``gc_timing``): garble and eval timed warm with CUDA events at the
   shapes of ``GC_TIMING`` (S = 4 at rides_secure_gc level 14's bp, S' = 8
   at a phase-29 kernel shard's, S = 8 and 16 on 1,048,576 tests), each
   with its bound, the ratio, and the registers, spills and SASS
   instructions of the instantiation it ran; then the ot2s timing line
   (``ot2s_timing``): each level's encrypt and decrypt step (the packed
   entries, one launch each) at the shapes of ``OT2S_TIMING``
   (config4_zipf_secure level 10, ``configs/secure.json``'s widest FE62
   level and F255 leaf, a K3 shard and its leaf, the S = 6 chunks), each
   with the step's milliseconds (CUDA events, warm), its device
   milliseconds (the same calls captured in a CUDA graph and replayed),
   the host microseconds a call, the bound, decrypt's sector floor at 32-
   and 64-byte granules from the actual choices (and the 128-byte lines
   those sectors touch), the ratios, and the registers, spills and SASS
   instructions of the kernel it ran;
9. the socket deployment: two ``bin.server`` processes and a ``bin.leader``
   (``--seed``) as real OS processes on the card, started together on free
   localhost ports (server 0 and the leader dial with retries; from here on
   each process is an interpreter started ahead, torch imported and its
   CUDA context made (``WarmPool``), except a drill's restart),
   for ``rides_socket`` (``configs/config.json``, trusted, N = 262,144) and
   ``rides_secure_socket`` (the same config with ``secure_exchange``, ot2s at
   S = 4, N = 8,192, whose in-process crawl ``rides_secure`` phase 6 runs
   through ``bin.mesh.run``).  The leaders run with ``FHH_SUPERVISE=0`` and
   ``FHH_WARMUP=0`` (``SOCKET_ENV``).  Each hitter count must equal the plaintext
   recount, the hitters must equal ``bin.mesh.run``'s for the same config,
   seed and N, and each server's ``server.exit`` line must show one expand
   launch per level and, secure, one ot2s encrypt per level it garbled and
   one decrypt per level it evaluated, with no GC launch.  A process that
   exits non-zero, prints a traceback or outlives its timeout fails the
   script.

10. ``config4_zipf_stream``: the config-4 shape at 196,608 clients through
    the streaming crawl of the JAX package's ``bench_crawl_hbm_max``:
    keygen in chunks of 32,768 clients on the card, landed level-major in
    host memory (``ibdcf.gen_l_inf_ball_host``), then ``driver.Leader(
    stream_chunk=32, stream_window=64, min_bucket=128)`` over those keys.  Its
    hitters must equal ``config4_zipf``'s and the plaintext recount, and
    expand must launch once per server per level plus once per advance
    chunk.  The expand kernel is held against its plain version on that
    path's new inputs (a window-sliced level's cw past the first window, a
    gathered 32-parent chunk with the child cache, the widest bucket), and
    keygen at the chunk's shape;
11. ``config4_zipf_resume``: the same streamed crawl checkpointing after
    level 255 (``checkpoint_every=256``) into the temporary directory,
    stopped there; a fresh ``Leader`` over the same host keys resumes it.
    Its hitters must equal phase 10's, and the file must be gone;
12. ``rides_socket_spans`` and ``rides_secure_socket_spans``: the two socket
    cells of phase 9 with ``crawl_shard_nodes: 8`` and
    ``crawl_pipeline_depth: 2`` (the secure one with ``secure_whole_level:
    false``).  Hitters must equal the unsplit runs' (so ``bin.mesh``'s) and
    the recount, each server must launch expand once per span and the ot2s
    kernels once per span it garbled or evaluated;
13. ``config4_zipf_radix3``: ``config4_zipf``'s keys (same seed) crawled
    through ``driver.Leader(radix=3)``, 170 fused rounds of 3 levels and a
    tail of 2; hitters equal ``config4_zipf``'s and the recount, expand
    launches 2 x 512 (r passes of the kernel per round and server), peak
    memory and crawl seconds beside ``config4_zipf``'s.  Server 0's whole
    fused level (radix word and child cache) built through the kernel is
    held against the same level built with the plain expand, at the widest
    round with a child cache and at the r = 2 tail round;
14. ``rides_socket_radix2``: ``rides_socket`` with ``crawl_radix_bits: 2``:
    8 crawl verbs and 16 expand launches per server, the hitters of
    ``bin.mesh`` and the recount, data-plane bytes and crawl seconds beside
    ``rides_socket``'s;
15. ``rides_secure_socket_radix2``: the same with ``secure_exchange`` and
    ``ot_path: "auto"`` at N = 4,096, so the garbled circuit at S' = 8: GC
    garble once per fused round a server garbled and eval once per round it
    evaluated (the garbler flips per round), no ot2s launch; the hitters of
    ``bin.mesh.run`` at the same config, seed and N (one level a round) and
    the recount;
16. ``rides_socket_radix2_warm``: phase 14 again, its leader ``bin.leader.run``
    in this process with the warmup (``FHH_WARMUP``'s default) over the
    buckets phase 14's crawl walked: each server must warm one shape per
    bucket and launch expand 4 times per shape (a full round with the child
    cache and the tail round, 2 levels each) besides the crawl's 16; the
    hitters must equal phase 14's; the warmup's seconds and the servers'
    peak memory and crawl seconds beside phase 14's;
17. ``rides_socket_supervised``: ``rides_socket`` under the leader's
    default, the supervised crawl (``FHH_SUPERVISE`` unset,
    ``FHH_CKPT_EVERY=4``, each server with a ``FHH_CKPT_DIR`` of its own):
    the hitters of phase 9 and the recount, 3 checkpoints a server (after
    the rounds ending at levels 4, 8 and 12), no recovery; the leader's
    seconds (reset, upload and rounds, and the rounds alone), each
    checkpoint's bytes and write seconds, each server's peak memory;
18. ``rides_socket_supervised_kill``: phase 17 with server 1 SIGKILLed as
    soon as its log shows its first checkpoint and started again at once on
    the same ports and directory: the hitters of phase 17, at least one
    recovery and one rollback, one restore in the new process at the
    leader's rollback level, the re-upload all of its 2,622 ``add_keys``
    chunks and none to server 0, expand launched once per crawl verb in
    each process (the restored frontier through the kernel); the seconds
    from the kill to ``resilience.restored``, the new process's start-up,
    the re-upload and the restore.  Then the restored blob is loaded in
    this process through ``rpc.CollectorServer.tree_restore`` on the card
    over rides' keys made again from the seed (``keys_fp`` must match) and
    expand is held against its plain version on that frontier;
19. ``rides_secure_socket_supervised_sever``: ``rides_secure`` (ot2s at S =
    4) at 4,096 clients, supervised as phase 17, the leader's link to
    server 0 through a ``ChaosProxy`` here that severs the answer of the
    first crawl verb after the first checkpoint, and server 1 killed and
    started again as in phase 18: the hitters of the in-process trusted
    ``driver.Leader`` on the same keys and the recount, server 0's replay
    dedup hits at least 1, the leader's client to it at epoch 2 or more, a
    recovery, the sever fired, and in each process one ot2s launch per
    crawl verb between the verbs it finished and those it began (the
    re-run levels included);
20. ``secure_malicious_socket``: ``configs/secure.json`` as shipped (zipf
    over 1,000 sites, data_len 32, n_dims 1, ball 4, threshold 0.01, f_max
    256, ot2s at S = 2, ``malicious``) at N = 16,384, two ``bin.server``
    processes supervised as phase 17, the leader ``RpcLeader.run_supervised``
    in this process on the keys of ``bin.leader.client_keys``, 18 clients'
    sketch keys forged (:func:`forge_clients`): the liveness the leader
    returns must exclude exactly those 18, ``sketch.leaf_forgery`` must
    count the 4 leaf forgers, every hitter count must equal the plaintext
    recount over the clients alive before the leaf check; each server 32
    ``sketch_verify`` verbs (level 0, levels 2-31, the leaf), one expand per
    level, one ot2s encrypt per level it garbled and one decrypt per level
    it evaluated, no GC, and the init checkpoint (level -1) with its
    periodic ones.  Expand is then held against its plain version on the
    widest checkpoint blob's frontier, restored through ``tree_restore``
    with the sketch keys; the ot2s kernels at the config's widest FE62 level
    and its F255 leaf, in process on the same ibDCF keys with ``malicious``
    off (``secure_malicious_replay``, phases 6-7's route);
21. ``zipf_malicious_socket``: the same config on the trusted exchange at
    N = 100,000 (BASELINE.json:9's sketch batch), all three processes, the
    leader ``bin.leader`` making its own sketch keys, supervised at its
    default cadence (the init blob and level 15's): all clients alive in
    both servers' ``server.exit`` and in ``crawl.done``, every hitter count
    the plaintext recount, 32 ``sketch_verify`` verbs a server; then keygen
    held at its K = 200,000 x L = 32 in both PRG bit modes.  Its
    semi-honest twin (``zipf_semi_honest_socket``, ``malicious`` off,
    supervised alike) must give the same hitters; the ratio of the two
    leaders' rounds is the sketch's overhead.  Phases 20-21
    report each server's ``sketch`` seconds and their share of the rounds,
    the data-plane bytes, the leader's ``sketch_gen`` seconds, the sketch
    bytes uploaded to each server and the servers' peak memory.
22. ``config4_mesh``: ``config4_zipf``'s config, seed and N through
    ``bin.mesh.run(..., devices=8)``: ``parallel.mesh.MeshRunner`` on a
    2 x 4 mesh of logical shards on the card.  Its hitters must equal
    ``config4_zipf``'s and the recount, expand must launch 2 x 4 times a
    level and keygen once; expand is held against its plain version on
    shard (0, 0)'s inputs at the widest level and at the last; its seconds
    and peak memory beside ``config4_zipf``'s;
23. ``rides_mesh_secure``: ``rides_secure``'s config, seed and N on the
    same mesh (ot2s at S = 4): the hitters of ``rides_secure`` and the
    recount, 4 launches of each ot2s kernel a level (the garbler row
    encrypts, the evaluator row decrypts) and none of GC; the ot2s kernels
    held on a shard's inputs at the widest FE62 level and the F255 leaf;
24. ``rides_mesh_secure_gc``: phase 23 with ``secure.EQ_OT4 = False`` set
    here: the delta garbled circuit through the GC kernels (zero payloads
    at W = 4) and the b2a round; the same hitters, 4 garble and 4 eval
    launches a level, no ot2s; both GC kernels held at the widest level;
25. ``rides_mesh_2proc`` / ``rides_mesh_2proc_secure``: two OS processes of
    ``bin.mesh --devices 8 --processes 2`` over a gloo group on localhost,
    one mesh row each on the card, trusted at ``rides``' 262,144 clients
    and secure at 4,096: both print the hitters of the one-process run
    (``rides``, and the one-process mesh at 4,096) and the recount, each
    reports its process-group bytes and its kernel launches (4 expand a
    level; secure, 4 encrypts a level it garbled, 4 decrypts a level it
    evaluated);
26. ``rides_mesh_supervised``: ``MeshLeader.run_supervised`` at rides'
    262,144 on the in-process mesh, a snapshot every 4 levels, under
    ``MeshChaos`` (a 200 ms delay at level 1, a dropped shard at 5, a
    killed participant at 9): ``rides``' hitters, recoveries 2,
    ``shards_rerun`` 1, ``levels_rerun`` 1, 8 expand launches a level run;
    the snapshot bytes and the restore's seconds.
27. ``rides_socket_sharded``: ``rides_socket`` with both servers at
    ``FHH_DATA_DEVICES=4`` (``parallel/server_mesh.py``: four logical data
    shards of the card a server, N/4 clients each): the hitters of phase 9
    and the recount, each server's data-plane bytes and largest frame
    equal to phase 9's (the wire is byte-identical), ``server.exit``'s
    ``mesh`` section at 4 shards of 65,536 clients, 64 expand launches a
    server (4 × 16);
28. ``rides_secure_socket_sharded``: the same for ``rides_secure_socket``
    (ot2s at S = 4, 8,192): every level on the row-sharded kernel stage
    (``kernel_shards_max`` 4, ``kernel_gathers`` 0), 4 × the ot2s launches.
    Then K3 held in this process on the cell's own strings (its keys made
    again from the seed, crawled on the trusted exchange to the level) at
    the widest FE62 level and the F255 leaf: ``kernel_shard.run_level_pair``
    at k = 4 gives the u matrix, the frame and the b2a values of the
    whole-level path (k = 1), and each shard's kernel call equals its plain
    version, timed beside its bound;
29. ``rides_secure_socket_radix2_sharded``: the same for phase 15 (GC at
    S' = 8, 4,096), 16 + 16 GC launches a server; K3 at its widest round;
30. ``zipf_malicious_socket_sharded``: phase 21 with four shards a server:
    all 100,000 clients alive, phase 21's hitters, sketch verbs and
    data-plane bytes, the sketch check on 4 shards (``sketch_shards``);
31. ``rides_socket_sharded_device_kill``: phase 27 supervised
    (``SUPERVISED_ENV``, checkpoints after levels 3, 7 and 11), server 1
    with ``FHH_MESH_FAULTS=mesh:kill@level=8``: it re-shards from the level-7
    blob inside the crawl verb (``mesh.faults`` 1, ``reshards`` 1, one
    ``resilience.mesh_reshard``), the leader sees no fault (``levels_rerun``
    0, ``recoveries`` 0, no ``resilience.loss_classified``), phase 27's
    hitters, and server 1's expand launches 64 or, with a pre-expanded
    dispatch dropped, up to 4 more (the line says which);
32. ``rides_socket_windows``: ``rides_socket``'s config and 262,144
    clients through ``bin.leader`` with ``FHH_WINDOWS=4`` (``SOCKET_ENV``):
    the clients' key shares submitted through the servers' admission gate
    (``submit_keys``, 656 submissions a window), each window sealed (an
    ingest-only checkpoint in each server's ``FHH_CKPT_DIR``) and crawled
    while the next one fills: each window's hitters the plaintext recount of
    its 65,536 points, the seal stats equal on both servers, 16 expand
    launches a window a server (64), no secure kernel; pure-ingest keys/s
    (window 0), keys/s during a crawl, each window's crawl seconds beside
    ``rides_socket``'s, and seal-to-hitters seconds;
33. ``rides_socket_windows_drill``: that config with ``ingest_shed:
    "reservoir"``, ``ingest_seed`` 7 and ``ingest_window_keys`` half a
    window's submissions, 65,600 clients in two windows, the leader
    ``WindowedIngest`` in this process through a ``ChaosProxy`` that
    delivers the fourth ``submit_keys`` frame to server 0 twice, and server
    1 SIGKILLed once window 0's crawl is under way (window 1 ingesting) and
    started again: each window's slot table what the port's own
    ``AdmissionController`` predicts from the seed and the offer order, its
    seal ``keys`` the cap, its hitters a batch crawl's (``upload_keys`` and
    ``run``) over exactly the admitted keys and the recount; at least one
    replayed submission answered from its recorded verdict, one ingest
    recovery, one restore, expand once per crawl verb (the re-run crawl's
    included);
34. ``zipf_malicious_socket_windows``: phase 21's config and 25,000
    clients through ``bin.leader`` with ``FHH_WINDOWS=2``, the sketch leaves
    riding each submission: every client alive after each window, each
    window's hitters the recount, both servers committing the same
    ``sketch.window_root`` a window and the two windows' roots apart, 32
    expand launches and 32 ``sketch_verify`` verbs a window a server; the
    sketch verbs' seconds a window beside phase 21's;
35. ``rides_socket_tenants``: rides' config on one pair of ``bin.server``
    processes, the leader in this process: first collection ``t0``'s
    65,536 clients crawled alone in the default collection (supervised: the
    solo run), then ``t0`` uploaded in its own collection and warmed over
    the solo run's buckets, then four collections ``t0``-``t3`` of 65,536
    clients each (keys at seeds ``seed + t``) at once through
    ``MultiCollectionDriver.run_collections``, supervised and warmed: each
    collection's hitters the plaintext recount and ``t0``'s the solo run's
    bit for bit; ``status`` counting the five collections, each keyed on
    both servers, and device turns; every other collection's warmup
    warming no shape and hitting the ladder once for each shape ``t0``
    warmed; the collections' counters summing to each server's totals,
    each collection's checkpoints in its own namespace; expand once per
    crawl verb and twice per warmed shape.  Reported: the aggregate
    clients/s against the solo run's, stall fills and the fill ratio, each
    collection's round seconds, each server's peak memory and launches;
36. ``rides_secure_socket_tenants``: the same at ``rides_secure``'s config
    (ot2s at S = 4) with two collections of 2,048 clients and no warmup:
    the same checks, one ot2s encrypt per round a server garbled and one
    decrypt per round it evaluated, each crawl's; reported besides: each
    collection's base-OT seconds per server;
37. ``rides_socket_tenant_isolation`` (the JAX package's
    ``tests/test_sessions.py:454`` at the card's size): both servers in
    reject mode with a 16,384-key burst and 1,024 keys/s; collection ``ta``
    floods its gate with 65,536 keys in submissions of 100 (one attempt
    each) while collection ``tb`` streams 16,384 clients into one window
    through ``WindowedIngest``, seals it and crawls it, and server 1 is
    SIGKILLed once round 2 of that crawl is under way and started again on
    its ports and directory: ``tb``'s window hitters the plaintext recount
    over its admitted keys, ``tb``'s gate on both servers without a refusal
    or a shed while ``ta``'s refused, an ingest recovery, checkpoints only
    in ``tb``'s namespace.  Reported: the kill-to-hitters seconds and the
    journal replays;
38. ``rides_socket_fleet_migrate`` (the collector fleet, JAX
    ``tests/test_fleet.py`` on the card): two pairs A and B of ``bin.server``
    processes, each registered under ``FHH_FLEET`` (``FHH_FLEET_PAIR``) with
    one shared ``FHH_CKPT_DIR``; the script's ``FleetDirectory`` scans the
    two pairs with the boot ids the processes announced and places the
    collection on A.  131,072 rides clients in two windows of 65,536 (656
    submissions of 100 keys a window, reject mode): window 0 submitted and
    sealed on A, 328 of window 1's submitted there, ``FleetPlacer.migrate``
    to B, the other 328 to B, window 1 sealed and both windows crawled on
    B.  Each window's hitters equal an in-process batch crawl over the
    window's keys as B banked them (its ingest checkpoint in the shared
    store) and the recount; the journal replay lands once (B's servers
    answer at least the replayed submissions as duplicates, the seals count
    every key); A's status shows no pools and one export a server, B's one
    import; A launches nothing, B expand 32 times a server; expand held
    against its plain version on window 1's batch crawl.  Reported: the
    migration seconds, the export blob's bytes a server, the replayed
    submissions, the window crawl seconds beside phase 32's;
39. ``rides_secure_socket_fleet_migrate``: the same at ``rides_secure``'s
    config (ot2s at S = 4), 4,096 clients in two windows: B keys its plane
    once a server (a base OT each, ``plane_epoch`` 1), A never; B launches
    each ot2s kernel 16 times a server, no GC; the ot2s pair held against
    their plain versions at window 1's widest FE62 level and F255 leaf, as
    phase 20's replay does;
40. ``rides_socket_fleet_host_kill``: phase 38's config and keys on fresh
    pairs C and D; after window 0's seal (its ingest checkpoint banked) and
    328 of window 1's submissions on C, a ``host:kill@window=0`` clause of
    ``HostChaos`` fires and both of C's processes are SIGKILLed; the
    directory's probe (bounded by ``FLEET_PROBE_S``) marks C dead,
    ``recover_dead_pair`` fails the collection over to D from the level -1
    blob and the journal, the rest is submitted to D and both windows crawl
    there: hitters equal phase 38's window for window, one failover, one
    import a server of D.  Reported: the seconds from the kill to the
    hitters;
41. ``rides_secure_socket_observed``: ``rides_secure_socket`` again (the
    same config, seed and 8,192 clients, the leader unsupervised as there)
    with the per-run telemetry on: ``FHH_RUN_REPORT``, ``FHH_TRACE_DIR``,
    ``FHH_PROFILE`` with ``FHH_PROFILE_LEVELS=14,15`` (the widest FE62
    level and the F255 leaf) and ``FHH_HEARTBEAT_S=1``.  Its hitters equal
    phase 9's and the recount; three run reports (leader, ``s0``, ``s1``)
    of schema ``fhh-run-report/1``; ``fss``, ``gc_ot`` and ``field`` cover
    every level on both servers; what one server sent the other received;
    ``gc_tests`` by level equal on both; the three processes' trace rings
    merge into one timeline that validates, one ``crawl`` root, every
    server verb span under a leader call span; each server's two profile
    captures name the expand and both ot2s kernels with device time above 0;
    the servers' last memory sample is above 0, its watermark at least
    that, its limit the card's capacity; no fresh ``nvcc`` build in either
    server; a heartbeat line names an active span.  Reported: server 0's
    per-level ``fss``/``gc_ot``/``otext``/``field`` seconds, the crawl
    seconds against phase 9's as a ratio (no gate), and the launches;
42. ``rides_secure_socket_live``: ``rides_secure_socket`` again (the same
    config, seed and 8,192 clients, unsupervised) with the live plane and
    both sanitizers on: ``FHH_METRICS_PORT`` at a free base (the leader on
    base + 0, the servers + 1 and + 2), ``FHH_DEBUG_GUARDS=1``,
    ``FHH_DEBUG_TAINT=1``, ``FHH_RUN_REPORT``, ``FHH_TRACE_DIR``, the SLO and
    device-memory alert budgets at 1e-6 (so ``slo_burn`` and
    ``hbm_high_water`` fire) and the stall budget at ``LIVE_STALL_S``.  A
    thread here scrapes the three ``/metrics`` endpoints every
    ``LIVE_SCRAPE_S`` during the crawl and runs ``python -m
    fuzzyheavyhitters_torch.obs.ops top --once`` against the base once both
    servers name their alerts; after the leader's exit the servers are held
    past the stall budget, scraped again, asked their ``status``, then sent
    SIGTERM.  Its hitters equal phase 9's and the recount; no log holds a
    ``GuardViolation`` or ``TaintViolation``; each exporter bound its port
    and every scrape parsed line for line; from each server's post-crawl
    scrape the ``level_latency`` buckets, count and sum equal its run
    report's, and so does its p95 (with the report's observed extremes, which
    the exposition does not carry: the scrape alone gives the same p95 unless
    the report's is clamped to them); the scrape's counters equal the
    report's, but those the status call and the exit advance
    (``LIVE_ADVANCED``); each server fired ``slo_burn``, ``hbm_high_water``
    and, after the stall, ``tenant_stall`` for the default collection,
    exactly once each and nothing else, alike in ``status.alerts``, the run
    report's ``alerts``, the ``alert.*`` log lines and the trace instants;
    the ``ops top`` frame names both servers' alerts and default rows.
    Reported: the crawl seconds against phase 9's as a ratio (no gate), the
    scrapes' median milliseconds and bytes, the secrets each server's taint
    sanitizer watched (``server.exit`` ``taint_markers``), the launches.

The shapes are fixed: there is no option to cut them.  Exact comparisons
throughout (tolerance 0: the system is bitwise).  Prints the card's name
and power limit, every check with its times against its bound, crawl
figures, the seconds each stage took, a ``{"kernels": [...]}`` line (each
kernel's launches in the crawl that runs it, its time at that crawl's
widest checked level; ``max_abs_err`` over every check of the kernel, K3's
per-shard checks of phases 28-29 included;
expand's row also carries its restored-frontier checks, keygen's its
data_len-32 check, the ot2s rows their phase-20 checks; each row the
launches per server of the later phases' processes, phases 35-37's as
``tenant_launches``, phases 38-40's as ``fleet_launches``, phase 41's as
``observed_launches``, phase 42's as ``live_launches``), and
as its last line ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer ops: the data sheet gives no integer rate, so take the issue
# limit, one warp instruction per clock per SM quarter = 128 thread ops per
# SM per clock (the rate behind its 67 TFLOP/s fp32: 2 flops x 128 x 132 SMs
# x 1.98 GHz).  The 64 INT32 lanes per SM are no limit: integer adds also
# issue to the FMA pipe as IMAD.  128 x 132 x 1.98e9 = 33.5e12 ops/s.
INT32_OPS_PER_S = 128 * 132 * 1.98e9
CHACHA8_OPS = 4 * 8 * 12 + 16  # 4 double rounds x 8 quarter-rounds x 12 ops + feed-forward
# ops that output word 8 alone needs (the derived t/y bits, all a level
# without a child cache reads): 3 full double rounds, the last one's 4 column
# quarter-rounds and 10 ops of one diagonal quarter-round, 1 feed-forward
# add and the seed mask
CHACHA8_WORD8_OPS = 7 * 4 * 12 + 10 + 1 + 1

CONFIG4 = dict(
    data_len=512, n_dims=1, ball_size=2, addkey_batch_size=100, num_sites=10000,
    threshold=0.001, zipf_exponent=1.03, server0="127.0.0.1:8000",
    server1="127.0.0.1:8001", distribution="zipf", f_max=1024,
)
ZIPF_CLIENTS = 196608
RIDES_CLIENTS = 262144
# the secure config-4 cell runs an eighth of bench.py's bench_secure_device
# shape (65,536 clients, about 155 s of crawl on the card; 32,768 until
# phase 41), for the script's time: its crawl is linear in N; the
# 1,048,576-test chunk checks keep the pad index's wrap past 2^32 covered
ZIPF_SECURE_CLIENTS = 8192
# bench.py:bench_covid's trusted covid crawl, at 8 x its 8,192 clients: about
# 1,024 clients per hot county
COVID = dict(
    data_len=64, n_dims=2, ball_size=1, addkey_batch_size=100, num_sites=64,
    threshold=0.01, zipf_exponent=1.03, server0="127.0.0.1:8000",
    server1="127.0.0.1:8001", distribution="covid", f_max=2048,
)
COVID_CLIENTS = 65536
# the secure socket cell's cut is forced by the wire: at the last level (F =
# 32, F255) the 1-of-16 table is 512 B a test, 4.3 GB a frame at 65,536
# clients, 17 GB at 262,144, held three or four times over in host memory;
# 32,768 (with its in-process and node-span twins) made room for phases 20-21,
# and 8,192 (with its sharded and mesh twins, cut together) for phases 35-37
RIDES_SECURE_CLIENTS = 8192
SOCKET_START_S = 240  # seconds for a server to listen (torch import, CUDA init)
SOCKET_LEADER_S = 420  # seconds for a leader's whole run
KEYGEN_CHUNKS = ((4096 * 2, 512), (8191, 509))  # keys, levels
PLAIN_ROWS = 1 << 23  # rows per plain-expand slice: bounds its int64 temporaries
PLAIN_TESTS = 1 << 19  # tests per plain ot2s/GC slice
CHUNK_TESTS = 1 << 20  # tests of each chunk check
CHUNK_IDX0 = 2**32 - 1000  # the chunk checks' pad index wraps inside the batch
# the GC timing line: (what, S, W, bp) — rides_secure_gc's widest level, a
# K3 shard of rides_secure_socket_radix2_sharded's widest round at 16,384
# clients and at the 4,096 the cell runs, the chunks
GC_TIMING = (("rides_secure_gc level 14", 4, 4, 1 << 24),
             ("K3 shard, S' = 8", 8, 4, 1 << 19),
             ("K3 shard at 4,096 clients, S' = 8", 8, 4, 1 << 17),
             ("chunk", 8, 4, CHUNK_TESTS), ("chunk", 8, 8, CHUNK_TESTS),
             ("chunk", 16, 4, CHUNK_TESTS), ("chunk", 16, 8, CHUNK_TESTS))
GC_TIMING_REPS = 20
# the ot2s timing line: (what, S, W, B) — config4_zipf_secure level 10 at 2^24
# tests (32,768 clients) and 2^22 (8,192), configs/secure.json's widest FE62
# level and its F255 leaf, a rides_secure_socket_sharded K3 shard at its widest
# FE62 level and at its leaf, and the chunks at S = 6; B whole planar blocks
OT2S_TIMING = (("config4_zipf_secure level 10", 2, 4, 1 << 24),
               ("config4_zipf_secure level 10 at 8,192 clients", 2, 4, 1 << 22),
               ("secure.json widest FE62 level", 2, 4, 1 << 20),
               ("secure.json F255 leaf", 2, 8, 1 << 16),
               ("K3 shard, widest FE62 level", 4, 4, 1 << 19),
               ("K3 shard, F255 leaf", 4, 8, 1 << 20),
               ("chunk", 6, 4, CHUNK_TESTS), ("chunk", 6, 8, CHUNK_TESTS))
OT2S_TIMING_REPS = 20
PROFILE_LEVELS = 8  # secure levels --profile traces per secure crawl
# bench.py:485-489 (bench_crawl_hbm_max): the streaming crawl's leader
STREAM = dict(stream_chunk=32, stream_window=64, min_bucket=128)
KEYGEN_HOST_CHUNK = 32768  # clients per keygen chunk landed in host memory (bench.py:469)
RESUME_EVERY = 256  # one checkpoint, after level 255 of 512
SPANS = dict(crawl_shard_nodes=8, crawl_pipeline_depth=2)
ZIPF_RADIX = 3  # phase 13: config4_zipf in rounds of 3 levels (170 and a tail of 2)
RIDES_RADIX = 2  # phase 14-15: rides over sockets in rounds of 2 levels (S' = 8 secure)
# phase 15's cut: a fused level carries 16 patterns of GC tests at about 512 B
# a test, where two radix-1 levels carry 2 x 4 patterns of ot2s tests at
# about 320 B; 16,384 clients moved about the bytes of rides_secure_socket at
# 32,768, and with it cut for phases 35-37 the pair (phase 29 its twin) is cut
# alike, to 8,192; for phases 38-40 to 4,096
RIDES_RADIX_SECURE_CLIENTS = 4096
# the socket leaders skip the warmup: its default ladder runs every bucket up
# to f_max = 1024, whose expansion alone (rides, 262,144 clients) needs about
# 55 GB per server, two servers on one card; phase 16 warms the buckets its
# crawl walks
SOCKET_ENV = {"FHH_WARMUP": "0"}
# every child process of the script logs its events (obs.emit) as JSON lines on
# standard output, each with its wall clock ``ts``, which the script reads
LOG_ENV = {"FHH_LOG_FORMAT": "json", "FHH_LOG_STREAM": "stdout"}
SIGTERM_RC = 143  # a server's exit code after SIGTERM (obs.exit_report)
# phases 17-19: the supervised crawl (FHH_SUPERVISE unset) banking a checkpoint
# every 4 levels, after the rounds ending at levels 4, 8 and 12 of rides' 16
# (the JAX leader's default of 16 banks none there)
SUPERVISED_ENV = {"FHH_WARMUP": "0", "FHH_CKPT_EVERY": "4"}
CKPT_EVERY = 4
# phase 19's cut, for the script's time: rides_secure_socket's 65,536 clients
# took 51-74 s a stage, 16,384 until phases 38-40 and 8,192 until phase 41
# needed the time
RIDES_SEVER_CLIENTS = 4096
PLAIN_COMPARE = 1 << 26  # elements per slice of a large kernel-vs-plain comparison
# phase 41: the levels profiled, rides' widest FE62 level and its F255 leaf
OBSERVED_LEVELS = (14, 15)
# phase 42: the live plane and both sanitizers on rides_secure_socket's cell.
# The stall budget stays above a level's seconds (up to 2.75 s a level of
# this cell on an H100 80GB HBM3, its base OT in level 0), so the stall
# fires after the crawl
LIVE_STALL_S = 6.0
LIVE_ENV = {"FHH_DEBUG_GUARDS": "1", "FHH_DEBUG_TAINT": "1",
            "FHH_ALERT_LEVEL_P95_S": "0.000001", "FHH_ALERT_HBM_FRAC": "0.000001",
            "FHH_ALERT_STALL_S": str(LIVE_STALL_S)}
LIVE_SCRAPE_S = 0.1  # the scrape thread's pause between rounds of the three targets
# counters the script's status call and the exit advance after the
# post-crawl scrape: the verb count and the control plane's bytes
LIVE_ADVANCED = {"verb_requests", "control_bytes_recv", "control_bytes_sent"}
# the symbol of each kernel of phase 41's servers, as a profile names it
KERNEL_SYMBOLS = {"expand": "fhh_expand_kernel", "ot2s_encrypt": "fhh_ot2s_enc_kernel",
                  "ot2s_decrypt": "fhh_ot2s_dec_kernel"}
# phase 20: configs/secure.json as shipped (ot2s at S = 2, malicious) over
# sockets, its leader in this process forging keys; cut from the 100,000
# clients of BASELINE.json:9's sketch batch for the script's time (the ot2s
# wire moves 0.24-0.28 GB/s)
MALICIOUS_CLIENTS = 16384
# phase 21: the same config on the trusted exchange, at BASELINE.json:9's and
# the config's sketch_batch_size, uncut
SKETCH_CLIENTS = 100000
FORGED_LEVELS = (0, 1, 2, 7, 15, 23)  # phase 20's cw_val forgeries, lanes 0 and 1
SITE_BITS = 24  # a zipf point is its site's 24 bits and 8 random ones (AUG_LEN)

# phases 22-26: the device mesh, 2 x 4 logical shards on the one card
MESH_DEVICES = 8
MESH_SHARDS = MESH_DEVICES // 2  # shards a row: kernel launches a level per row
# phase 25's secure cut (its table crosses gloo): 16,384 until phases 38-40
# and 8,192 until phase 41 needed the time
MESH_2PROC_SECURE_CLIENTS = 4096
MESH_CKPT_EVERY = 4
MESH_FAULTS = "mesh:delay@level=1,ms=200;mesh:drop@level=5;mesh:kill@level=9"

# phases 27-31: the socket deployment with four data shards a server, four
# logical shards of the card (parallel/server_mesh.py wraps them)
SHARDS = 4
SHARD_ENV = {"FHH_DATA_DEVICES": str(SHARDS)}
MESH_KILL_LEVEL = 8  # phase 31: the level after the checkpoint of round 7
MESH_KILL = f"mesh:kill@level={MESH_KILL_LEVEL}"
# phases 32-34: streaming ingestion (FHH_WINDOWS) on the socket deployment
WINDOWS = 4  # phase 32: rides_socket's 262,144 clients in four windows
# phase 33: two windows of 328 submissions of 100 keys (reservoir shedding
# takes uniform chunks: 65,536 would leave a 68-key tail a window, which the
# gate refuses by design), a reservoir of half a window's submissions
DRILL_CLIENTS = 65600
DRILL_WINDOWS = 2
DRILL_SEED = 7  # ingest_seed
DRILL_FLOOD = "ctl0:flood@msg=6,count=1"  # the 4th submit_keys frame to server 0, twice
SKETCH_WINDOWS = 2  # phase 34: two windows
# phase 34's clients, cut from phase 21's 100,000 for phases 38-40's time
# (50,000) and phase 41's
SKETCH_WINDOW_CLIENTS = 25000
# phases 35-37: many collections on one server pair
TENANTS = 4  # phase 35: t0..t3 at rides' config
TENANT_CLIENTS = 65536
SECURE_TENANTS = 2  # phase 36: at rides_secure's config (ot2s at S = 4)
SECURE_TENANT_CLIENTS = 2048  # 8,192 until phases 38-40, 4,096 until phase 41
TENANT_CKPT_EVERY = 8  # the MultiCollectionDriver's default cadence
ISOLATION_CLIENTS = 16384  # phase 37: tb's window
FLOOD_KEYS = 65536  # ta's flood
TENANT_GATE = dict(ingest_burst_keys=16384, ingest_rate_keys_per_s=1024.0)
FLEET_CLIENTS = 131072  # phases 38 and 40: rides clients, 65,536 a window
FLEET_WINDOWS = 2
FLEET_SECURE_CLIENTS = 4096  # phase 39: 2,048 a window (rides_secure's 8,192 until phase 41)
FLEET_PROBE_S = 3.0  # a fleet probe's whole budget: both dials and status calls

# every kernel of the port: (module, launch counter, source, TPU kernel it replaces)
KERNELS = {
    "keygen": ("keygen_cuda", "LAUNCHES", "fuzzyheavyhitters_torch/csrc/keygen.cu",
               "fuzzyheavyhitters_tpu/ops/keygen_pallas.py:206"),
    "expand": ("expand_cuda", "LAUNCHES", "fuzzyheavyhitters_torch/csrc/expand.cu",
               "fuzzyheavyhitters_tpu/ops/expand_pallas.py:182"),
    "ot2s_encrypt": ("otext_cuda", "ENC_LAUNCHES", "fuzzyheavyhitters_torch/csrc/ot2s.cu",
                     "fuzzyheavyhitters_tpu/ops/otext_pallas.py:214"),
    "ot2s_decrypt": ("otext_cuda", "DEC_LAUNCHES", "fuzzyheavyhitters_torch/csrc/ot2s.cu",
                     "fuzzyheavyhitters_tpu/ops/otext_pallas.py:259"),
    "gc_garble": ("gc_cuda", "GARBLE_LAUNCHES", "fuzzyheavyhitters_torch/csrc/gc.cu",
                  "fuzzyheavyhitters_tpu/ops/gc_pallas.py:279"),
    "gc_eval": ("gc_cuda", "EVAL_LAUNCHES", "fuzzyheavyhitters_torch/csrc/gc.cu",
                "fuzzyheavyhitters_tpu/ops/gc_pallas.py:336"),
}
# the wrapper of each secure kernel, as the protocol code calls it
WRAPPERS = {"ot2s_encrypt": ("otext_cuda", "enc_planar"),
            "ot2s_decrypt": ("otext_cuda", "dec_planar"),
            "gc_garble": ("gc_cuda", "garble_planar"),
            "gc_eval": ("gc_cuda", "eval_planar")}
OT2S, GC = ("ot2s_encrypt", "ot2s_decrypt"), ("gc_garble", "gc_eval")


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def cuda_ms(fn, reps: int, warm: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs (CUDA events).
    ``warm`` runs it once untimed first, so that a kernel's output blocks are
    already in the caching allocator and no timed run waits on cudaMalloc
    (a check's plain slices in between leave the cache fragmented)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if warm:
        fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(got, want, what: str) -> int:
    """Largest |difference| over paired integer/bool tensors; raises unless
    every pair is identical, so the return value is 0."""
    import torch

    err = 0
    for a, b in zip(got, want, strict=True):
        d = (a.long() - b.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel != plain (max_abs_err {err})")
    return err


def _ints(bits: np.ndarray) -> list:
    """bool[..., L] MSB-first bitstrings -> flat list of Python ints."""
    L = bits.shape[-1]
    rows = np.packbits(bits.reshape(-1, L), axis=-1)
    return [int.from_bytes(r.tobytes(), "big") >> (-L % 8) for r in rows]


def plaintext_counts(points: np.ndarray, ball: int, paths: np.ndarray) -> np.ndarray:
    """Clients whose L∞ ball holds each hitter in every dimension, from the
    sampled points alone (no FSS, no port code): a client at v covers
    [max(0, v - ball), min(2^L - 1, v + ball)] per dimension, in int64 up
    to L = 62 and in Python integers past it, where interval ends and
    hitters are ranked together, so the containment test is a vectorised
    comparison of ranks."""
    N, d, L = points.shape
    top = (1 << L) - 1
    inside = np.ones((paths.shape[0], N), bool)
    if L <= 62:
        w = np.int64(1) << np.arange(L - 1, -1, -1, dtype=np.int64)
        v, x = (points * w).sum(-1), (paths * w).sum(-1)  # [N, d], [H, d]
        for j in range(d):
            lo, hi = np.maximum(0, v[:, j] - ball), np.minimum(top, v[:, j] + ball)
            inside &= (lo[None] <= x[:, j, None]) & (x[:, j, None] <= hi[None])
        return inside.sum(1)
    for j in range(d):
        v, x = _ints(points[:, j]), _ints(paths[:, j])
        lo = [max(0, a - ball) for a in v]
        hi = [min(top, a + ball) for a in v]
        rank = {val: r for r, val in enumerate(sorted(set(lo) | set(hi) | set(x)))}
        r_lo, r_hi, r_x = (np.array([rank[a] for a in vals], np.int64) for vals in (lo, hi, x))
        inside &= (r_lo[None] <= r_x[:, None]) & (r_x[:, None] <= r_hi[None])
    return inside.sum(1)


def _ops(name):
    import importlib

    return importlib.import_module(f"fuzzyheavyhitters_torch.ops.{name}")


def _counter(kn):
    mod, attr, _, _ = KERNELS[kn]
    return _ops(mod), attr


def mesh_run(name, cfg, n, seed, tmp):
    """One collection through ``bin.mesh.run`` on the card."""
    from fuzzyheavyhitters_torch.bin import mesh

    with open(os.path.join(tmp, f"{name}_events.jsonl"), "w") as out, json_logs(out):
        return mesh.run(cfg, n, device="cuda", seed=seed,
                        csv_path=os.path.join(tmp, f"{name}_hitters.csv"))


def covid_run(name, cfg, n, seed, tmp):
    """The JAX package's ``bench.bench_covid`` on the card: ``cfg.num_sites``
    hot counties written from the seed into a centroid file, jitterless
    points (clients of one county share one f64 pattern), keygen through
    ``ibdcf.gen_l_inf_ball`` and the trusted crawl through ``driver.Leader``."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver
    from fuzzyheavyhitters_torch.workloads import covid

    rng = np.random.default_rng(seed)
    cpath = os.path.join(tmp, f"{name}_centroids.csv")
    with open(cpath, "w") as f:
        f.write("fips_code,latitude,longitude\n")
        for i in range(cfg.num_sites):
            f.write(f"{10000 + i},{25 + 25 * rng.random():.4f},"
                    f"{-120 + 50 * rng.random():.4f}\n")
    seconds = {}
    t0 = time.perf_counter()
    pts = covid.sample_covid_locations(os.path.join(tmp, "absent.csv"), cpath, n,
                                       fuzz_factor=None, rng=rng)
    seconds["sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device="cuda")
    torch.cuda.synchronize()
    seconds["keygen"] = time.perf_counter() - t0
    lead = driver.Leader(*driver.make_servers(k0, k1), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max)
    del k0, k1
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    torch.cuda.synchronize()
    seconds["crawl"] = time.perf_counter() - t0
    return mesh.MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def run_main_path(name, cfg, n, seed, tmp, per_level, drive, min_hitters):
    """Drive one collection (``drive``: ``mesh_run`` or ``covid_run``) with
    every kernel count zeroed just before and read just after; check the
    answer; return (run, launches, figures).  keygen and expand must launch;
    the kernels in ``per_level`` once per level; every other kernel never."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    for kn in KERNELS:
        setattr(*_counter(kn), 0)
    run = drive(name, cfg, n, seed, tmp)
    launches = {kn: getattr(*_counter(kn)) for kn in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    res = run.result
    levels = len(run.leader.timings["expand"])
    # expand, count, prune, advance on the host clock (the leader's phases
    # take stream events only under a profiler); the secure phases as spans
    # of the device stream (Leader.timings)
    phases = {k: float(np.sum(v)) for k, v in run.leader.timings.items()}
    consumed = ([s.consumed for s in run.leader.secure.snd]
                if run.leader.secure is not None else None)
    H = res.paths.shape[0]
    log(f"crawl {name}: N={n} data_len={cfg.data_len} n_dims={cfg.n_dims} "
        f"secure={cfg.secure_exchange} ot_path={cfg.ot_path} "
        f"levels={levels} hitters={H} sampling_s={run.seconds['sampling']:.3f} "
        f"keygen_s={run.seconds['keygen']:.3f} crawl_wall_s={run.seconds['crawl']:.3f} "
        f"clients_per_s={n / run.seconds['crawl']:.1f} "
        f"max_memory_allocated={peak} launches={launches} "
        f"phase_s={ {k: round(v, 4) for k, v in phases.items()} }"
        + (f" ot_consumed_per_session={consumed}" if consumed is not None else ""))
    for kn, c in launches.items():
        want = levels if kn in per_level else None
        if kn in ("keygen", "expand") and c <= 0:
            raise AssertionError(f"{name}: kernel {kn} was never launched on the main path")
        if kn not in ("keygen", "expand") and c != (want or 0):
            raise AssertionError(f"{name}: kernel {kn} launched {c} times, want {want or 0}")
    if not min_hitters <= H <= cfg.f_max:
        raise AssertionError(f"{name}: {H} hitters, want {min_hitters}..f_max={cfg.f_max}")
    if res.paths.shape[1:] != (cfg.n_dims, cfg.data_len):
        raise AssertionError(f"{name}: hitter paths shaped {res.paths.shape}")
    thresh = max(1, int(cfg.threshold * n))
    if (res.counts < thresh).any():
        raise AssertionError(f"{name}: a hitter count is below the threshold {thresh}")
    want = plaintext_counts(run.points, cfg.ball_size, res.paths)
    if not np.array_equal(res.counts, want):
        bad = np.nonzero(res.counts != want)[0][:5]
        raise AssertionError(f"{name}: counts {res.counts[bad]} != plaintext {want[bad]}")
    log(f"crawl {name}: all {H} hitter counts equal the plaintext recount")
    return run, launches, {"n": n, "levels": levels, "hitters": H,
                           "seconds": run.seconds, "phase_s": phases,
                           "max_memory_allocated": peak, "ot_consumed": consumed,
                           "clients_per_s": n / run.seconds["crawl"]}


def replay(lead, n, threshold, secure_levels, each=None):
    """Crawl the leader's keys once more, level by level: the secure
    exchange at ``secure_levels`` (on the leader's own OT sessions), the
    trusted one elsewhere, which gives the same counts and so carries the
    same frontier.  ``each(level, before)`` runs around every level."""
    sessions = lead.secure
    try:
        lead.tree_init()
        for level in range(lead.data_len):
            lead.secure = sessions if level in secure_levels else None
            if each:
                each(level, True)
            lead.run_level(level, n, threshold)
            if each:
                each(level, False)
    finally:
        lead.secure = sessions
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None


def profile_crawl(name, run, cfg, torch, window=None):
    """``--profile``: crawl the run's keys once more under ``torch.profiler``;
    report device time by kernel and the device's busy and idle share of the
    crawl (kernels run on one stream, so busy time is the sum of their times).
    A secure crawl profiles the secure levels in ``window`` of a replay (a
    whole 512-level secure crawl is millions of launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = run.leader
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    if window is None:
        with prof:
            t0 = time.perf_counter()
            res = lead.run(nreqs=run.points.shape[0], threshold=cfg.threshold)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if not np.array_equal(res.paths, run.result.paths):
            raise AssertionError(f"{name}: profiled crawl disagrees with the main-path run")
    else:
        clock = {}

        def each(level, before):
            if before and level == window[0]:
                torch.cuda.synchronize()
                prof.start()
                clock["t0"] = time.perf_counter()
            if not before and level == window[-1]:
                torch.cuda.synchronize()
                clock["wall"] = time.perf_counter() - clock["t0"]
                prof.stop()

        replay(lead, run.points.shape[0], cfg.threshold, set(window), each)
        wall = clock["wall"]
    by_kernel = {}  # device-side events only: kernels, memcpys, memsets
    runtime = {}  # host-side CUDA runtime calls: (count, host seconds)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e6
        elif ev.key.startswith("cuda"):
            runtime[ev.key] = (ev.count, ev.cpu_time_total / 1e6)
    busy = float(sum(by_kernel.values()))
    ours = {k: v for k, v in by_kernel.items() if "fhh_" in k}
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    span = "whole crawl" if window is None else f"secure levels {window[0]}..{window[-1]}"
    log(f"profile {name} ({span}): profiled_wall_s={wall:.4f} device_busy_s={busy:.4f} "
        f"idle_share={1.0 - busy / wall:.4f} port_kernels_s={sum(ours.values()):.4f} "
        f"plain_pytorch_s={busy - sum(ours.values()):.4f}")
    for k, v in top.items():
        log(f"  {v * 1e3:10.3f} ms  {k[:100]}")
    for k, v in ours.items():
        if k not in top:
            log(f"  {v * 1e3:10.3f} ms  {k[:100]}")
    runtime = dict(sorted(runtime.items(), key=lambda kv: -kv[1][1])[:8])
    log("  host CUDA runtime calls: " + ", ".join(
        f"{k} n={n} {s:.4f} s" for k, (n, s) in runtime.items()))
    return {"span": span, "profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "port_kernels_s": sum(ours.values()),
            "device_s_by_kernel": top, "port_kernel_s_by_name": ours,
            "host_cuda_runtime": runtime}


def free_ports():
    """(port0, port1) free on localhost with port1 + 1 free too: server 1's
    data plane listens there."""
    import socket

    while True:
        with socket.socket() as a, socket.socket() as b, socket.socket() as c:
            a.bind(("127.0.0.1", 0))
            p1 = a.getsockname()[1]
            try:
                b.bind(("127.0.0.1", p1 + 1))
            except OSError:
                continue
            c.bind(("127.0.0.1", 0))
            return c.getsockname()[1], p1


# A pre-started interpreter (WarmPool): it imports torch and makes its CUDA
# context, then reads the one job it runs, a JSON line (module, args, cwd,
# env, log), on its standard input and runs the module as ``python -m``
# would, its output in the job's log.  A warm-up that failed is reported
# there, so a cell's log always says why its process ended.
WARM_BOOT = r"""
import json, os, runpy, sys, traceback
try:
    import torch
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    err = None
except BaseException:
    err = traceback.format_exc()
line = sys.stdin.readline()
if not line:
    sys.exit(0)
job = json.loads(line)
os.chdir(job["cwd"])
os.environ.clear()
os.environ.update(job["env"])
if err is None and os.environ.get("OMP_NUM_THREADS"):  # read at torch's import
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
fd = os.open(job["log"], os.O_WRONLY | os.O_APPEND)
os.dup2(fd, 1)
os.dup2(fd, 2)
os.close(fd)
if err is not None:
    sys.stderr.write(err)
    sys.exit(1)
sys.argv = [job["module"], *job["args"]]
runpy.run_module(job["module"], run_name="__main__", alter_sys=True)
"""
WARM_SPARES = 4  # a fleet cell's four servers


class WarmPool:
    """Interpreters started ahead of the card's socket, fleet and two-process
    cells, so that a cell's processes do not each pay the seconds of a
    Python and CUDA start-up (torch's import and the context) before they
    serve.  Each runs one job and is gone; taking one starts its
    replacement, which warms while the cell runs.  A restart inside a drill
    is a cold ``python -m`` start (``start(..., warm=False)``): its start-up
    is what the drill measures."""

    def __init__(self, spares=WARM_SPARES):
        self.spares, self.idle, self.on = spares, [], False

    def _boot(self):
        repo = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
        self.idle.append(subprocess.Popen(
            [sys.executable, "-c", WARM_BOOT], stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=repo, env=env))

    def start(self, module, args, cwd, env, log, warm=True):
        """``python -m module *args`` in ``cwd`` under ``env``, its standard
        output and error truncated into ``log``: a warm interpreter when the
        pool is on and ``warm``, else a cold process."""
        open(log, "w").close()
        proc = None
        while warm and self.on and proc is None:
            if not self.idle:
                self._boot()
            p = self.idle.pop(0)
            job = json.dumps({"module": module, "args": list(args), "cwd": cwd,
                              "env": dict(env), "log": log}) + "\n"
            try:
                p.stdin.write(job.encode())
                p.stdin.close()
                proc = p
            except OSError:  # it died warming: take the next one
                p.kill()
                p.wait()
        if proc is None:
            with open(log, "w") as out:
                return subprocess.Popen([sys.executable, "-m", module, *args], cwd=cwd,
                                        env=env, stdout=out, stderr=subprocess.STDOUT)
        self.fill()
        return proc

    def fill(self):
        """Start interpreters until ``spares`` of them wait."""
        while len(self.idle) < self.spares:
            self._boot()

    def close(self):
        """Stop every interpreter still waiting for a job."""
        self.on = False
        for p in self.idle:
            p.kill()
            p.wait()
        self.idle = []


POOL = WarmPool()  # on only in main() on the card: the CPU tests start cold processes


@contextlib.contextmanager
def json_logs(stream="stdout"):
    """``obs.emit`` lines as JSON on standard output (or on ``stream``) for
    the length of the block, as :data:`LOG_ENV` makes them in a child
    process: an in-process leader writes its log as its process would."""
    from fuzzyheavyhitters_torch.obs import logs

    saved = (logs._cfg["fmt"], logs._cfg["stream"])
    logs.configure(fmt="json", stream=stream)
    try:
        yield
    finally:
        logs.configure(fmt=saved[0], stream=saved[1])


def _events(path) -> list:
    """The JSON event lines of a log (a line still being written is left
    for the next read)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{") and line.endswith("\n")]


def _wait_event(path, event, proc, timeout):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if any(e["event"] == event for e in _events(path)):
            return
        if proc.poll() is not None:
            with open(path) as f:
                raise AssertionError(f"{path}: exited {proc.returncode} before {event}:\n"
                                     f"{f.read()[-3000:]}")
        time.sleep(0.1)
    raise AssertionError(f"{path}: no {event} within {timeout} s")


def _chaos_proxy(spec, target_port):
    """A ``resilience.chaos.ChaosProxy`` with the fault ``spec`` in front of
    localhost ``target_port``, on an event loop of its own in a thread (the
    leader it serves is another process).  Returns (proxy, stop)."""
    import asyncio
    import threading

    from fuzzyheavyhitters_torch.resilience.chaos import ChaosProxy, parse_faults

    box, ready = {}, threading.Event()

    async def serve():
        box["loop"], box["stop"] = asyncio.get_running_loop(), asyncio.Event()
        box["proxy"] = await ChaosProxy("127.0.0.1", free_ports()[0], "127.0.0.1", target_port,
                                        parse_faults(spec), link="ctl0").start()
        ready.set()
        await box["stop"].wait()
        await box["proxy"].stop()

    th = threading.Thread(target=asyncio.run, args=(serve(),), daemon=True)
    th.start()
    if not ready.wait(30):
        raise AssertionError(f"the chaos proxy did not start: {box}")

    def stop():
        box["loop"].call_soon_threadsafe(box["stop"].set)
        th.join(30)

    return box["proxy"], stop


def socket_run(name, cfg, n, seed, tmp, env=None, warm_buckets=None, supervise=False,
               kill=False, ctl0_faults=None, leader_coro=None, keep_blobs=False,
               server_env=None, ckpt=None, after_leader=None):
    """Phase 9: ``bin.server --server_id 1``, ``--server_id 0`` and ``bin.leader
    --seed`` started together as OS processes (warm ones from :data:`POOL`
    once it is on; the restart after ``kill`` cold) (on the card unless
    ``cfg.backend`` is ``"cpu"``; server 0 and the leader dial with retries,
    after start-ups at least as long as the servers'; on the CPU, where the
    start-ups contend for the cores, one after another: server 0 once
    server 1 listens for its plane, the leader once both serve), in the
    working directory ``tmp/name``; SIGTERM to the servers after the leader's exit.
    The leader runs with ``FHH_SUPERVISE=0`` (the unsupervised crawl) unless
    ``supervise``: then the variable is unset, the JAX leader's default,
    and each server gets a checkpoint directory of its own
    (``FHH_CKPT_DIR``; ``ckpt`` True gives them without ``supervise``);
    ``env`` adds variables to the processes' environment, ``server_env``
    ({server id: variables}) one server's.  With ``kill`` server 1 is
    SIGKILLed as soon as its log shows its first
    ``resilience.server_checkpoint`` (or, ``kill`` a callable, once
    ``kill(server 1's events)`` is true) and started again at once on the
    same ports and directory; the blob the new process restores is copied
    aside (``restored_blob``), since later checkpoints prune it.
    With ``ctl0_faults`` the leader reaches server 0 through a
    ``ChaosProxy`` with that fault spec, in this process, and starts once
    both servers serve.  With
    ``warm_buckets`` the leader is ``bin.leader.run`` in this process once
    both servers serve, in the environment its process would have, its
    events written to its log as the process's are, and its warmup over
    those buckets; with ``leader_coro`` the leader is the coroutine
    ``leader_coro(config)`` there instead (its return value is the run's
    ``leader_result``).  ``after_leader((port0, port1), logs)`` runs once the
    leader has ended, before the servers are sent SIGTERM (its return value
    is the run's ``after``).  With ``keep_blobs`` every checkpoint blob a server
    writes is hard-linked into ``blobs/`` as it appears (the servers keep
    only their two newest).  Every process must end without a traceback
    inside its timeout: the leader with 0, the servers, sent SIGTERM at the
    end, with 143 (the SIGTERM contract of ``obs.exit_report``), the killed
    one with -9; all are killed in a ``finally``.  Returns the leader's and
    the servers' events and the working directory."""
    import asyncio
    import contextlib
    import shutil
    import signal
    import threading

    p0, p1 = free_ports()
    work = os.path.join(tmp, name)
    os.makedirs(work)
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(dataclasses.asdict(cfg), server0=f"127.0.0.1:{p0}",
                       server1=f"127.0.0.1:{p1}"), f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "FHH_SUPERVISE": "0", **LOG_ENV, **(env or {}),
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    if supervise:
        del env["FHH_SUPERVISE"]
    with_ckpt = supervise if ckpt is None else ckpt
    ckpt = {sid: os.path.join(work, f"ckpt{sid}") for sid in (0, 1)}
    procs, logs = {}, {who: os.path.join(work, f"{who}.log")
                       for who in ("server0", "server1", "leader")}
    leader_cfg = cfg_path
    stop_proxy = proxy = None

    device = "cpu" if cfg.backend == "cpu" else "cuda"

    def spawn(who, mod, *args, config=cfg_path, extra=None, warm=True):
        procs[who] = POOL.start(f"fuzzyheavyhitters_torch.bin.{mod}",
                                ["--config", config, "--device", device, *args], work,
                                {**env, **(extra or {})}, logs[who], warm=warm)
        return time.time()

    def spawn_server(sid, warm=True):
        extra = {"FHH_CKPT_DIR": ckpt[sid]} if with_ckpt else {}
        extra.update((server_env or {}).get(sid, {}))
        return spawn(f"server{sid}", "server", "--server_id", str(sid), extra=extra, warm=warm)

    killed, done = {}, threading.Event()
    kill_now = kill if callable(kill) else (
        lambda ev: any(e["event"] == "resilience.server_checkpoint" for e in ev))

    def killer():
        """SIGKILL server 1 at its first checkpoint (or when ``kill`` says),
        start it again, and copy the blob the new process restores."""
        while not done.is_set():
            if kill_now(_events(logs["server1"])):
                break
            time.sleep(0.01)
        else:
            return
        old = procs["server1"]
        old.kill()
        killed["t_kill"] = time.time()
        killed["rc"] = old.wait()
        killed["log"] = os.path.join(work, "server1_killed.log")
        os.replace(logs["server1"], killed["log"])
        killed["t_spawn"] = spawn_server(1, warm=False)  # a restart's start-up is cold
        while not done.is_set():
            ev = [e for e in _events(logs["server1"]) if e["event"] == "resilience.server_restore"]
            if ev:
                lvl, coll = ev[0]["level"], ev[0].get("collection", "default")
                ns = "" if coll == "default" else f"c{coll}_"  # the collection's namespace
                killed["restored_blob"] = os.path.join(work, f"restored_{ns}l{lvl}.npz")
                shutil.copyfile(os.path.join(ckpt[1], f"fhh_server1_{ns}l{lvl}.npz"),
                                killed["restored_blob"])
                return
            time.sleep(0.01)

    blobs = os.path.join(work, "blobs")

    def keeper():
        """Hard-link each new checkpoint blob into ``blobs``."""
        os.makedirs(blobs)
        while not done.is_set():
            for sid in (0, 1):
                names = os.listdir(ckpt[sid]) if os.path.isdir(ckpt[sid]) else []
                for nm in names:
                    dst = os.path.join(blobs, nm)
                    if nm.endswith(".npz") and not os.path.exists(dst):
                        with contextlib.suppress(FileNotFoundError):
                            os.link(os.path.join(ckpt[sid], nm), dst)
            time.sleep(0.01)

    rcs = {}
    killer_th = keeper_th = None
    result = None
    if warm_buckets is not None:
        import torch

        from fuzzyheavyhitters_torch.bin import leader

        leader_coro = functools.partial(leader.run, nreqs=n, dev=torch.device(device),
                                        seed=seed, warm_buckets=warm_buckets)
    try:
        spawn_server(1)
        if device == "cpu":  # start-ups contend for the cores: a dial budget must
            # not run out during a peer's start-up (server 0's to server 1's plane)
            _wait_event(logs["server1"], "server.plane_listening", procs["server1"],
                        SOCKET_START_S)
        spawn_server(0)
        if keep_blobs:
            keeper_th = threading.Thread(target=keeper, daemon=True)
            keeper_th.start()
        if ctl0_faults is not None:
            proxy, stop_proxy = _chaos_proxy(ctl0_faults, p0)
            leader_cfg = os.path.join(work, "leader.json")
            with open(leader_cfg, "w") as f:
                json.dump(dict(dataclasses.asdict(cfg), server0=f"127.0.0.1:{proxy.listen_port}",
                               server1=f"127.0.0.1:{p1}"), f)
        if kill:
            killer_th = threading.Thread(target=killer, daemon=True)
            killer_th.start()
        t0 = time.perf_counter()
        if leader_coro is None:
            # and the leader's to server 0; through the chaos proxy too, which
            # accepts the leader before server 0 listens and drops it when its
            # own dial fails, past the reach of the leader's dial retries
            if device == "cpu" or ctl0_faults is not None:
                for who in ("server0", "server1"):
                    _wait_event(logs[who], "server.serving", procs[who], SOCKET_START_S)
            spawn("leader", "leader", "-n", str(n), "--seed", str(seed), config=leader_cfg)
            rcs["leader"] = procs["leader"].wait(timeout=SOCKET_LEADER_S)
        else:
            from fuzzyheavyhitters_torch.utils import config as configmod

            for who in ("server0", "server1"):
                _wait_event(logs[who], "server.serving", procs[who], SOCKET_START_S)
            t0 = time.perf_counter()
            here, saved = os.getcwd(), dict(os.environ)
            os.chdir(work)  # the rides CSV lands under the working directory
            os.environ.clear()  # the environment the leader's process would have
            os.environ.update(env)
            try:
                with open(logs["leader"], "w") as out, contextlib.redirect_stdout(out), \
                        json_logs():
                    result = asyncio.run(asyncio.wait_for(
                        leader_coro(configmod.load_config(leader_cfg)), SOCKET_LEADER_S))
            finally:
                os.chdir(here)
                os.environ.clear()
                os.environ.update(saved)
            rcs["leader"] = 0
        wall = time.perf_counter() - t0
        after = None if after_leader is None else after_leader((p0, p1), logs)
        done.set()
        for th in (killer_th, keeper_th):
            if th is not None:
                th.join(60)
        for who in ("server0", "server1"):
            procs[who].send_signal(signal.SIGTERM)
            rcs[who] = procs[who].wait(timeout=60)
    finally:
        done.set()
        if stop_proxy is not None:
            stop_proxy()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    # a process that failed is the first thing to report: a kill that never
    # came is then its consequence
    for who, path in logs.items():
        with open(path) as f:
            text = f.read()
        want = 0 if who == "leader" else SIGTERM_RC  # the servers were sent SIGTERM
        if rcs.get(who) != want or "Traceback" in text:
            raise AssertionError(f"{name}: {who} exited {rcs.get(who)} (want {want}):\n"
                                 f"{text[-3000:]}")
    if kill and killed.get("rc") != -signal.SIGKILL:
        raise AssertionError(f"{name}: server 1 was not killed at a checkpoint: {killed}")
    if "log" in killed:
        with open(killed["log"]) as f:
            if "Traceback" in f.read():
                raise AssertionError(f"{name}: the killed server 1 printed a traceback")
    ev = {who: _events(path) for who, path in logs.items()}
    if "log" in killed:
        ev["server1_killed"] = _events(killed["log"])
    one = lambda who, event: next((e for e in ev[who] if e["event"] == event), None)
    return {"work": work, "wall_s": wall, "crawl": one("leader", "crawl.done"),
            "warmup": one("leader", "warmup.done"),
            "addkeys": one("leader", "addkeys.done"), "keygen": one("leader", "keygen"),
            "hitters": [e for e in ev["leader"] if e["event"] == "hitter"],
            "exits": [one(f"server{sid}", "server.exit") for sid in (0, 1)],
            "events": ev, "killed": killed, "proxy_fired": proxy.fired if proxy else None,
            "leader_result": result, "blobs": blobs if keep_blobs else None, "after": after}


def _recount(name, got, cfg, points):
    """Every hitter count against the plaintext recount from the points."""
    vals = np.array([json.loads(v) for v in got], np.int64).reshape(len(got), cfg.n_dims)
    paths = ((vals[..., None] >> np.arange(cfg.data_len - 1, -1, -1)) & 1).astype(bool)
    want = plaintext_counts(points, cfg.ball_size, paths)
    if not np.array_equal(np.array(list(got.values())), want):
        raise AssertionError(f"{name}: counts {list(got.values())} != plaintext {want}")


def check_socket_run(name, run, cfg, points, mesh_hitters, mesh_crawl_s, per_level, shards=1):
    """Phase 9's (and 12's, 14's, 15's) checks: the hitters equal
    ``bin.mesh.run``'s and every count the plaintext recount; each server
    ran one crawl verb per round (of ``crawl_radix_bits`` levels) or per
    node span of it, launched expand once per level of each verb, and, with
    ``per_level`` (the ot2s or the GC pair), the garbling kernel once per
    verb of a round it garbled (round index % 2 == its id) and the other
    once per verb of a round it evaluated; no other kernel.  After a
    (trusted) warmup each server must also report one shape per warmed
    bucket and span size, and launch expand once per level of the rounds
    ``rpc.CollectorServer._warm_bucket`` runs at each shape.  With
    ``shards`` data shards a server (``FHH_DATA_DEVICES``) every count is
    that many times as large: each shard runs its own launch."""
    from fuzzyheavyhitters_torch.protocol import collect

    L, k = cfg.data_len, cfg.crawl_radix_bits
    bases = list(range(0, L, k))
    buckets = run["crawl"]["buckets"]
    whole = cfg.secure_exchange and cfg.secure_whole_level
    spans = [1 if whole else len(collect.shard_spans(b, cfg.crawl_shard_nodes))
             for b in buckets]
    if len(spans) != len(bases):
        raise AssertionError(f"{name}: the leader crawled {len(spans)} rounds, "
                             f"want {len(bases)}")
    got = {e["value"]: e["count"] for e in run["hitters"]}
    if got != mesh_hitters:
        raise AssertionError(f"{name}: socket hitters {got} != bin.mesh's {mesh_hitters}")
    _recount(name, got, cfg, points)
    launches = {}
    verbs = sum(spans)
    passes = sum(n * min(k, L - lv) for n, lv in zip(spans, bases))
    warm = run["warmup"]
    if warm is not None:
        if per_level:
            raise AssertionError(f"{name}: the launch check counts a trusted warmup only")
        shapes = sum(len({hi - lo for lo, hi in collect.shard_spans(b, cfg.crawl_shard_nodes)}
                         | {b}) for b in set(warm["f_buckets"]))
        if warm["shapes"] != [shapes, shapes]:
            raise AssertionError(f"{name}: the servers warmed {warm['shapes']} shapes, want "
                                 f"{shapes} each")
        base_last = k * ((L - 1) // k)  # a full round with the cache, and the tail round
        passes += shapes * (min(k, L) if base_last == 0 else k + L - base_last)
    for sid, ex in enumerate(run["exits"]):
        garbled = sum(n for i, n in enumerate(spans) if i % 2 == sid)
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = passes * shards
        if per_level:
            want_l.update({per_level[0]: garbled * shards,
                           per_level[1]: (verbs - garbled) * shards})
        if ex["launches"] != want_l or ex["levels"] != verbs:
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{ex['levels']} crawl verbs, want {want_l} over {verbs}")
        launches[f"server{sid}"] = ex["launches"]
        log(f"socket {name} server{sid}: data_bytes_sent={ex['data_bytes_sent']} "
            f"data_bytes_recv={ex['data_bytes_recv']} data_frame_max={ex['data_frame_max']} "
            f"control_bytes_recv="
            f"{ex['control_bytes_recv']} control_bytes_sent={ex['control_bytes_sent']} "
            f"phase_s={ {k: round(v, 4) for k, v in ex['seconds'].items()} } "
            f"launches={ex['launches']}")
    log(f"socket {name}: N={points.shape[0]} hitters={len(got)} (= bin.mesh's, each = the "
        f"plaintext recount) crawl_s={run['crawl']['seconds']:.3f} bin.mesh crawl_s="
        f"{mesh_crawl_s:.3f} addkeys_s={run['addkeys']['seconds']:.3f} keygen_s="
        f"{run['keygen']['seconds']:.3f} leader_wall_s={run['wall_s']:.3f} "
        f"crawl_verbs_per_server={verbs} radix={k} pipeline={run['crawl']['pipeline']}")
    return {"n": int(points.shape[0]), "hitters": len(got), "hitter_map": got, "crawl_s": run["crawl"]["seconds"],
            "mesh_crawl_s": mesh_crawl_s, "addkeys_s": run["addkeys"]["seconds"],
            "keygen_s": run["keygen"]["seconds"], "leader_wall_s": run["wall_s"],
            "launches": launches, "servers": run["exits"], "crawl_verbs": verbs,
            "pipeline": run["crawl"]["pipeline"], "radix": k,
            "data_bytes_sent": [ex["data_bytes_sent"] for ex in run["exits"]],
            "data_frame_max": [ex["data_frame_max"] for ex in run["exits"]],
            "max_memory_allocated": [ex["max_memory_allocated"] for ex in run["exits"]],
            "buckets": buckets, "warmup": warm}


def check_supervised_run(name, run, cfg, want_hitters, points, per_level=(), shards=1,
                         rerun_slack=0):
    """Phases 17-19's checks of a supervised socket run (faults or none):
    the hitters ``want_hitters`` and the plaintext recount; each server
    process launched expand once per crawl verb it began and, with
    ``per_level`` (the ot2s pair), one of the pair per verb between the
    verbs it finished and the verbs it began (a verb cut on the plane may
    fail before or after its kernel), no other kernel; after a kill the
    restarted server 1 restored once, at the leader's restored level, and
    re-uploads alone: ``add_keys`` chunks of all clients to it, none again
    to server 0.  With ``shards`` data shards a server each launch count is
    that many times as large, and expand may run ``rerun_slack`` launches
    more (a level re-run inside its verb).  Returns the figures."""
    got = {e["value"]: e["count"] for e in run["hitters"]}
    if got != want_hitters:
        raise AssertionError(f"{name}: hitters {got} != {want_hitters}")
    _recount(name, got, cfg, points)
    crawl, ev = run["crawl"], run["events"]
    if not crawl["supervised"]:
        raise AssertionError(f"{name}: the leader ran the unsupervised crawl")
    chunks = -(-points.shape[0] // cfg.addkey_batch_size)
    servers = []
    for sid, ex in enumerate(run["exits"]):
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = ex["levels"] * shards
        want_l.update({kn: ex["launches"][kn] for kn in per_level})
        got_l = dict(ex["launches"])
        if want_l["expand"] <= got_l["expand"] <= want_l["expand"] + rerun_slack:
            got_l["expand"] = want_l["expand"]
        pair = sum(ex["launches"][kn] for kn in per_level)
        if got_l != want_l or (per_level and not ex["levels_done"] * shards <= pair
                               <= ex["levels"] * shards):
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{ex['levels']} crawl verbs begun, {ex['levels_done']} done")
        if ex["add_keys"] != chunks:
            raise AssertionError(f"{name}: server {sid} took {ex['add_keys']} add_keys "
                                 f"chunks, want {chunks}")
        ckpts = [e for e in ev[f"server{sid}"] if e["event"] == "resilience.server_checkpoint"]
        servers.append({k: ex[k] for k in (
            "boot_id", "levels", "levels_done", "launches", "dedup_hits", "plane_resets",
            "checkpoint_writes", "checkpoint_bytes", "checkpoint_write_s",
            "checkpoint_restores", "checkpoint_restore_s",
            "data_bytes_sent", "data_bytes_recv", "data_frame_max", "max_memory_allocated")})
        servers[-1]["mesh"] = ex.get("mesh")
        servers[-1]["checkpoints"] = [{k: e[k] for k in ("level", "bytes", "seconds")}
                                      for e in ckpts]
    fig = {"n": int(points.shape[0]), "hitters": len(got), "hitter_map": got,
           "crawl_s": crawl["seconds"], "seconds_by_part": crawl["seconds_by_part"],
           "counters": {k: crawl[k] for k in ("recoveries", "levels_rerun", "shards_rerun",
                                              "crawl_checkpoints", "pipeline_faults")},
           "epochs": crawl["epochs"], "buckets": crawl["buckets"], "servers": servers,
           "launches": {f"server{sid}": ex["launches"] for sid, ex in enumerate(run["exits"])},
           "keygen_s": run["keygen"]["seconds"], "leader_wall_s": run["wall_s"]}
    killed = run["killed"]
    if killed:
        restored = [e for e in ev["leader"] if e["event"] == "resilience.restored"]
        restores = [e for e in ev["server1"] if e["event"] == "resilience.server_restore"]
        if len(restores) != 1 or restores[0]["level"] != restored[-1]["level"]:
            raise AssertionError(f"{name}: the new server 1 restored {restores}, the leader "
                                 f"rolled back to {restored}")
        new_ev = {e["event"]: e for e in ev["server1"]}
        fig["recovery"] = {
            "restored_level": restored[-1]["level"],
            "kill_to_restored_s": restored[-1]["ts"] - killed["t_kill"],
            "startup_to_plane_listening_s": new_ev["server.plane_listening"]["ts"]
            - killed["t_spawn"],
            "startup_to_serving_s": new_ev["server.serving"]["ts"] - killed["t_spawn"],
            "leader_probe_s": restored[-1]["probe_s"],
            "leader_reupload_s": restored[-1]["reupload_s"],
            "leader_restore_s": restored[-1]["restore_s"],
            "server1_restore_s": restores[0]["seconds"],
            "recover_s": crawl["seconds_by_part"]["recover"]}
    log(f"supervised {name}: N={points.shape[0]} hitters={len(got)} (as wanted, each = the "
        f"plaintext recount) crawl_s={crawl['seconds']:.3f} by part="
        f"{ {k: round(v, 3) for k, v in crawl['seconds_by_part'].items()} } counters="
        f"{fig['counters']} epochs={crawl['epochs']} recovery={fig.get('recovery')}")
    for sid, sv in enumerate(servers):
        log(f"supervised {name} server{sid}: " + " ".join(
            f"{k}={sv[k]}" for k in ("levels", "levels_done", "launches", "dedup_hits",
                                     "plane_resets", "checkpoint_writes", "checkpoint_bytes",
                                     "checkpoint_write_s", "checkpoint_restores",
                                     "checkpoint_restore_s", "data_bytes_sent",
                                     "max_memory_allocated", "checkpoints")))
    return fig


def restored_expand_check(name, blob, cfg, keys1, ex, collect, prg, torch, sketch1=None):
    """Phases 18's and 20's check of the restored route into the expand
    kernel: a blob of server 1, loaded in this process through
    ``rpc.CollectorServer.tree_restore`` on the card over the keys made
    again from the seed (``keys1``, its ``keys_fp`` must equal the blob's;
    a sketch blob also needs the sketch keys ``sketch1``), then expand held
    against its plain version on that frontier at the round after it."""
    import asyncio

    from fuzzyheavyhitters_torch.protocol import rpc

    with np.load(blob) as z:
        level, blob_fp = int(z["level"]), z["keys_fp"]
    ckdir = os.path.join(os.path.dirname(blob), f"restored_check_l{level}")
    os.makedirs(ckdir)
    os.link(blob, os.path.join(ckdir, f"fhh_server1_l{level}.npz"))
    srv = rpc.CollectorServer(1, cfg, "cuda", ckpt_dir=ckdir)

    async def restore():
        await srv.add_keys({"keys": tuple(keys1), "sketch": sketch1})
        return await srv.tree_restore({"level": level})

    asyncio.run(restore())
    if not np.array_equal(srv._keys_fp(), blob_fp):
        raise AssertionError(f"{name}: the regenerated keys' keys_fp != the blob's")
    nxt = level + srv.crawl_radix(level)
    last = nxt + srv.crawl_radix(nxt) == cfg.data_len
    st = srv.frontier.states
    dev = st.seed.device
    if dev.type != "cuda":
        raise AssertionError(f"{name}: the restored frontier is on {dev}")
    d, _, F, N = st.bit.shape
    d2, B = 2 * d, F * N
    cws, cwf = collect.level_cw_planar(srv.keys, nxt)
    args = (st.seed.reshape(4, d2, B), st.bit.reshape(d2, B), st.y_bit.reshape(d2, B), cws, cwf)
    err, ms, plain_ms = expand_check(ex, args, not last, prg.DERIVED_BITS, torch)
    b_ms, b_by = expand_bound(B, N, d2, not last, prg.DERIVED_BITS)
    check = {"kind": "restored", "restored_level": level, "level": nxt, "F": F, "N": N,
             "d2": d2, "B": B, "want_children": not last, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "blob_bytes": os.path.getsize(blob)}
    log(f"expand {name} restored from the level-{level} blob ({check['blob_bytes']} B, keys_fp = "
        f"the blob's), level={nxt} F={F} N={N} d2={d2} want_children={not last}: kernel == "
        f"plain, max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by})")
    del srv
    torch.cuda.empty_cache()
    return check


def forge_clients(cfg, ck):
    """Phase 20's forgeries on copies of the leader's sketch keys (both
    parties' copies altered alike, as ``tests/test_sketch.py`` does): 12
    clients of the most popular site with ``cw_val[c, 0, j, lane]`` off by
    one, one per (j, lane) for j in FORGED_LEVELS and lanes 0 and 1 (every
    prefix of that site through depth 24 survives, so each is checked); 2
    clients with an inconsistent ``mac_key2`` share (party 0's, + 1: check
    2 fails at level 0); 4 clients with their leaf MAC lane
    (``cw_val_last[c, 0, 1]``) forged, among the clients whose point is a
    hitter leaf of the plaintext recount without the 14 others (their leaves
    survive to the leaf check).  -> (sk0, sk1, {"inner", "mac2", "leaf"}:
    client indices)."""
    from fuzzyheavyhitters_torch.ops.fields import FE62

    n, L = ck.points.shape[0], cfg.data_len
    site = np.array(_ints(ck.points[:, 0, :SITE_BITS]), np.int64)
    sites, counts = np.unique(site, return_counts=True)
    top = sites[np.argmax(counts)]
    inner = np.nonzero(site == top)[0][:2 * len(FORGED_LEVELS)]
    mac2 = np.nonzero(site != top)[0][:2]
    keep = np.ones(n, bool)
    keep[inner] = keep[mac2] = False
    point = np.array(_ints(ck.points[:, 0]), np.int64)
    cand = np.unique(point[keep])
    paths = ((cand[:, None] >> np.arange(L - 1, -1, -1)) & 1).astype(bool)[:, None, :]
    hit = set(cand[plaintext_counts(ck.points[keep], cfg.ball_size, paths)
                   >= max(1, int(cfg.threshold * n))].tolist())
    leaf = np.array([c for c in np.nonzero(keep)[0] if point[c] in hit][:4])
    if len(inner) < 12 or len(leaf) < 4:
        raise AssertionError(f"phase 20 found {len(inner)} clients at the top site and "
                             f"{len(leaf)} at hitter leaves")
    sk = [list(ck.sketch0), list(ck.sketch1)]
    for p in (0, 1):
        for i in (4, 5, 7):  # cw_val, cw_val_last, mac_key2: copies of their own
            sk[p][i] = sk[p][i].copy()
        for k, c in enumerate(inner):
            j, lane = FORGED_LEVELS[k // 2], k % 2
            sk[p][4][c, 0, j, lane] = (int(sk[p][4][c, 0, j, lane]) + 1) % FE62.P
        for c in leaf:
            sk[p][5][c, 0, 1, 0] ^= 3
    sk[0][7][mac2] = FE62.np_add(sk[0][7][mac2], np.uint64(1))
    return sk[0], sk[1], {"inner": inner.tolist(), "mac2": mac2.tolist(),
                          "leaf": leaf.tolist()}


def _sketch_figures(name, run, crawl_s):
    """The report of a malicious socket run, per server: the ``sketch``
    seconds (the verbs) and the prunes' sketch advance seconds, each with
    its share of the leader's rounds, the sketch verbs, the
    data-plane bytes (the sketch swaps included), checkpoints, peak card
    memory."""
    out = []
    for sid, ex in enumerate(run["exits"]):
        sk_s = ex["seconds"]["sketch"]
        out.append({"sketch_s": sk_s, "sketch_share_of_crawl": sk_s / crawl_s,
                    "sketch_advance_s": ex["sketch_advance_s"],
                    "sketch_advance_share_of_crawl": ex["sketch_advance_s"] / crawl_s,
                    "sketch_verifies": ex["sketch_verifies"],
                    "alive_clients": ex["alive_clients"], "levels": ex["levels"],
                    "launches": ex["launches"], "data_bytes_sent": ex["data_bytes_sent"],
                    "data_bytes_recv": ex["data_bytes_recv"],
                    "data_frame_max": ex["data_frame_max"],
                    "checkpoint_writes": ex["checkpoint_writes"],
                    "checkpoint_bytes": ex["checkpoint_bytes"], "phase_s": ex["seconds"],
                    "max_memory_allocated": ex["max_memory_allocated"],
                    "mesh": ex.get("mesh")})
        log(f"malicious {name} server{sid}: " + " ".join(
            f"{k}={v}" for k, v in out[-1].items() if k != "phase_s")
            + f" phase_s={ {k: round(v, 3) for k, v in ex['seconds'].items()} }")
    return out


def check_malicious_run(name, run, cfg, points, alive, per_level, ckpt_levels, shards=1):
    """Phases 20's and 21's checks of a supervised malicious socket run:
    ``alive`` (bool[N]) is the liveness each server reports and the
    leader's ``crawl.done`` counts; every hitter count is the plaintext
    recount over the clients alive before the leaf check; each server ran
    one ``sketch_verify`` a round but level 1's, and the leaf's (data_len
    in all), one expand launch per crawl verb, with ``per_level`` (the ot2s
    pair) one encrypt per level it garbled (level % 2 = its id) and one
    decrypt per level it evaluated, no other kernel; and wrote its
    checkpoints at ``ckpt_levels`` (-1 the init blob); ``shards`` data shards
    a server multiply the launches.  -> the figures."""
    L = cfg.data_len
    got = {e["value"]: e["count"] for e in run["hitters"]}
    if not got:
        raise AssertionError(f"{name}: no hitters")
    _recount(name, got, cfg, points)
    crawl = run["crawl"]
    if not crawl["supervised"] or crawl["alive"] != int(alive.sum()):
        raise AssertionError(f"{name}: crawl.done {crawl}")
    for sid, ex in enumerate(run["exits"]):
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = L * shards
        if per_level:
            mine = sum(1 for lv in range(L) if lv % 2 == sid)
            want_l.update({per_level[0]: mine * shards, per_level[1]: (L - mine) * shards})
        ck = [e["level"] for e in run["events"][f"server{sid}"]
              if e["event"] == "resilience.server_checkpoint"]
        if (ex["launches"] != want_l or ex["levels"] != L or ex["sketch_verifies"] != L
                or ex["alive_clients"] != int(alive.sum()) or ck != list(ckpt_levels)):
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} (want "
                                 f"{want_l}) over {ex['levels']} crawl verbs, "
                                 f"{ex['sketch_verifies']} sketch verbs, "
                                 f"{ex['alive_clients']} clients alive, checkpoints at {ck}")
    return got


def malicious_forged_run(name, cfg, n, seed, tmp, ex, collect, prg, torch):
    """Phase 20: configs/secure.json over two ``bin.server`` processes,
    supervised (a checkpoint every CKPT_EVERY levels, each server its own
    directory), its leader ``RpcLeader.run_supervised`` in this process on
    the keys ``bin.leader.client_keys`` makes, forged by
    :func:`forge_clients`; then expand held against its plain version on
    the widest checkpoint blob's frontier (restored through
    ``tree_restore``).  -> the figures."""
    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.bin.server import split_addr
    from fuzzyheavyhitters_torch.protocol.leader_rpc import RpcLeader
    from fuzzyheavyhitters_torch.protocol.rpc import CollectorClient

    for kn in KERNELS:
        setattr(*_counter(kn), 0)
    ck = leader_bin.client_keys(cfg, n, torch.device("cuda"), seed)
    keygen_launches = getattr(*_counter("keygen"))
    sk0, sk1, forged = forge_clients(cfg, ck)
    upload = sum(a.nbytes for a in sk0)

    async def lead_forged(lcfg):
        c0 = await CollectorClient.connect(*split_addr(lcfg.server0))
        c1 = await CollectorClient.connect(*split_addr(lcfg.server1))
        try:
            lead = RpcLeader(lcfg, c0, c1, emit=leader_bin.emit)
            t0 = time.perf_counter()
            res = await lead.run_supervised(n, ck.keys0, ck.keys1, sk0, sk1,
                                            checkpoint_every=CKPT_EVERY)
            leader_bin.emit("crawl.done", seconds=time.perf_counter() - t0, supervised=True,
                            levels=lcfg.data_len, hitters=int(res.paths.shape[0]),
                            seconds_by_part=lead.seconds, alive=int(lead.alive.sum()),
                            buckets=lead.buckets, **lead.counters)
        finally:
            await c0.aclose()
            await c1.aclose()
        for row, c in zip(res.decode_ints(), res.counts):
            leader_bin.emit("hitter", value=str(row.tolist()), count=int(c))
        return lead.alive

    run = socket_run(name, cfg, n, seed, tmp, SUPERVISED_ENV, supervise=True,
                     leader_coro=lead_forged, keep_blobs=True)
    alive = run["leader_result"]
    want = np.ones(n, bool)
    out = forged["inner"] + forged["mac2"] + forged["leaf"]
    want[out] = False
    if not np.array_equal(alive, want):
        raise AssertionError(f"{name}: excluded {np.nonzero(~alive)[0].tolist()}, want "
                             f"{sorted(out)}")
    leaf_ev = [e for e in run["events"]["leader"] if e["event"] == "sketch.leaf_forgery"]
    if [e["new_exclusions"] for e in leaf_ev] != [len(forged["leaf"])]:
        raise AssertionError(f"{name}: leaf forgery events {leaf_ev}")
    before_leaf = want.copy()
    before_leaf[forged["leaf"]] = True
    L = cfg.data_len
    ckpts = [-1] + [lv for lv in range(L - 1) if (lv + 1) % CKPT_EVERY == 0]
    got = check_malicious_run(name, run, cfg, ck.points[before_leaf], want, OT2S, ckpts)
    crawl_s = run["crawl"]["seconds_by_part"]["levels"]
    fig = {"n": n, "hitters": len(got), "hitter_map": got, "forged": forged,
           "crawl_s": crawl_s, "seconds_by_part": run["crawl"]["seconds_by_part"],
           "keygen_s": ck.keygen_s, "sketch_gen_s": ck.sketch_s,
           "sketch_upload_bytes_per_server": upload, "keygen_launches": keygen_launches,
           "leaf_forgery": leaf_ev[0]["new_exclusions"], "buckets": run["crawl"]["buckets"],
           "servers": _sketch_figures(name, run, crawl_s)}
    fig["launches"] = {f"server{sid}": sv["launches"] for sid, sv in enumerate(fig["servers"])}
    log(f"malicious {name}: N={n} excluded {sorted(out)} (= the 18 forged: "
        f"{forged}), leaf_forgery new_exclusions={fig['leaf_forgery']}, hitters={len(got)} "
        f"(each = the plaintext recount without the 14 caught before the leaf) crawl_s="
        f"{crawl_s:.3f} by part={ {k: round(v, 3) for k, v in fig['seconds_by_part'].items()} }"
        f" keygen_s={ck.keygen_s:.3f} sketch_gen_s={ck.sketch_s:.3f} "
        f"sketch_upload_bytes_per_server={upload} buckets_max={max(fig['buckets'])}")
    # expand on the widest frontier a checkpoint of server 1 banked
    widest, wf = None, -1
    for nm in sorted(os.listdir(run["blobs"])):
        if nm.startswith("fhh_server1_l"):
            with np.load(os.path.join(run["blobs"], nm)) as z:
                if z["bit"].shape[2] > wf:
                    widest, wf = os.path.join(run["blobs"], nm), z["bit"].shape[2]
    fig["restored_check"] = restored_expand_check(name, widest, cfg, ck.keys1, ex, collect,
                                                  prg, torch, sketch1=sk1)
    del ck, sk0, sk1
    return fig


def malicious_batch_run(name, cfg, n, seed, tmp, env=SOCKET_ENV, shards=1):
    """Phase 21: the sketch at its batch size on the trusted exchange, all
    three processes (``bin.leader`` making its own sketch keys), supervised
    at the leader's default checkpoint cadence (16) with a directory a
    server, so the init blob is written: every client stays alive, every
    hitter count is the plaintext recount.  ``env`` is the processes'
    environment, ``shards`` the data shards it gives each server (phase
    30).  -> the figures."""
    from fuzzyheavyhitters_torch.workloads import sample_points

    run = socket_run(name, cfg, n, seed, tmp, env, supervise=True)
    points = sample_points(cfg, n, np.random.default_rng(seed))
    L = cfg.data_len
    got = check_malicious_run(name, run, cfg, points, np.ones(n, bool), (),
                              [-1] + [lv for lv in range(L - 1) if (lv + 1) % 16 == 0],
                              shards)
    gen = next(e for e in run["events"]["leader"] if e["event"] == "sketch_gen")
    crawl_s = run["crawl"]["seconds_by_part"]["levels"]
    fig = {"n": n, "hitters": len(got), "hitter_map": got, "crawl_s": crawl_s,
           "seconds_by_part": run["crawl"]["seconds_by_part"],
           "keygen_s": run["keygen"]["seconds"], "sketch_gen_s": gen["seconds"],
           "sketch_upload_bytes_per_server": gen["bytes_per_server"],
           "buckets": run["crawl"]["buckets"], "leader_wall_s": run["wall_s"],
           "servers": _sketch_figures(name, run, crawl_s)}
    fig["launches"] = {f"server{sid}": sv["launches"] for sid, sv in enumerate(fig["servers"])}
    log(f"malicious {name}: N={n} all alive, hitters={len(got)} (each = the plaintext "
        f"recount) rounds_s={crawl_s:.3f} by part="
        f"{ {k: round(v, 3) for k, v in fig['seconds_by_part'].items()} } keygen_s="
        f"{fig['keygen_s']:.3f} sketch_gen_s={fig['sketch_gen_s']:.3f} "
        f"sketch_upload_bytes_per_server={fig['sketch_upload_bytes_per_server']} "
        f"sketch_share_of_rounds="
        f"{[round(sv['sketch_share_of_crawl'], 4) for sv in fig['servers']]} "
        f"buckets_max={max(fig['buckets'])}")
    return fig, points


def check_keygen_chunks(kg, torch, rng):
    """Phase 2: keygen kernel vs plain on random alphas and sides, both PRG
    bit modes, at each of KEYGEN_CHUNKS."""
    err = 0
    for K, L in KEYGEN_CHUNKS:
        seeds = torch.from_numpy(
            rng.integers(-2**31, 2**31, size=(K, 2, 4)).astype(np.int32)).to("cuda")
        alpha = torch.from_numpy(rng.integers(0, 2, size=(K, L)).astype(bool)).to("cuda")
        side = torch.from_numpy(rng.integers(0, 2, size=K).astype(bool)).to("cuda")
        for derived in (False, True):
            got = kg.gen_cw(seeds, alpha, side, derived)
            want = kg.gen_cw_plain(seeds, alpha, side, derived)
            torch.cuda.synchronize()
            err = max(err, same(got, want, f"keygen chunk K={K} L={L} (derived_bits={derived})"))
        log(f"keygen chunk K={K} L={L}: kernel == plain in both PRG bit modes, "
            f"max_abs_err={err}")
    return err


def expand_check(ex, args, want_children, derived, torch):
    """The expand kernel against its plain version on one frontier (the
    plain version on row slices); returns (max_abs_err, ms, plain_ms)."""
    seed, t, y, cws, cwf = args
    B = t.shape[1]
    got = ex.expand_packed(*args, derived, want_children)
    torch.cuda.synchronize()
    if not want_children and (got[1] is not None or got[2] is not None):
        raise AssertionError("expand built a child cache it was not asked for")
    err, plain_ms = 0, 0.0
    for lo in range(0, B, PLAIN_ROWS):
        hi = min(B, lo + PLAIN_ROWS)
        sl = (seed[..., lo:hi], t[:, lo:hi], y[:, lo:hi], cws, cwf)
        box = {}
        plain_ms += cuda_ms(lambda: box.update(
            w=ex.expand_packed_plain(*sl, derived, want_children, row0=lo)), 1)
        part = (got[0][lo:hi],)
        if want_children:
            part += (got[1][..., lo:hi], got[2][:, lo:hi])
        err = max(err, same(part, box["w"][:len(part)], f"expand rows [{lo}, {hi})"))
    del got
    ms = cuda_ms(lambda: ex.expand_packed(*args, derived, want_children), 5, warm=True)
    return err, ms, plain_ms


def expand_bound(B, N, d2, want_children, derived):
    """Least time of one expansion of B rows: read seed + t + y per (row,
    plane) and the cw planes once, write packed per row and, with the child
    cache, 8 seed words + flags; hash a whole ChaCha8 block per (row,
    plane) with the cache, without it only what word 8 needs."""
    if not want_children:
        return bound(B * d2 * 18 + N * d2 + B * 4,
                     B * d2 * (CHACHA8_WORD8_OPS if derived else 0))
    return bound(B * d2 * (18 + 33) + N * d2 * 17 + B * 4, B * d2 * CHACHA8_OPS)


def measure_expand(name, run, cfg, ex, collect, prg, torch):
    """Phase 4: re-crawl the run's keys level by level and hold the expand
    kernel against its plain version on server 0's frontier each time it
    reaches a new width, and at the last level (no child cache, as the
    crawl calls it there).  A secure crawl is replayed with the trusted
    exchange, which gives the same counts and so the same frontiers.
    Returns the checks."""
    lead = run.leader
    L, n = lead.data_len, run.points.shape[0]
    sessions, lead.secure = lead.secure, None
    try:
        return _expand_checks(name, lead, L, n, cfg, ex, collect, prg, torch)
    finally:
        lead.secure = sessions
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None


def _expand_checks(name, lead, L, n, cfg, ex, collect, prg, torch):
    lead.tree_init()
    widest, checks = 0, []
    for level in range(L):
        st = lead.server0.frontier.states
        d, _, F, N = st.bit.shape
        last = level == L - 1
        if F > widest or last:
            widest = max(widest, F)
            d2, B = 2 * d, F * N
            cws, cwf = collect.level_cw_planar(lead.server0.keys, level)
            args = (st.seed.reshape(4, d2, B), st.bit.reshape(d2, B),
                    st.y_bit.reshape(d2, B), cws, cwf)
            err, ms, plain_ms = expand_check(ex, args, not last, prg.DERIVED_BITS, torch)
            b_ms, b_by = expand_bound(B, N, d2, not last, prg.DERIVED_BITS)
            checks.append({"level": level, "F": F, "N": N, "d2": d2, "B": B,
                           "want_children": not last, "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
            log(f"expand {name} level={level} F={F} N={N} d2={d2} want_children={not last}: "
                f"kernel == plain, max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
        if not last:
            lead.run_level(level, n, cfg.threshold)
    return checks


def radix_run(name, cfg, n, seed, tmp, tail):
    """Phase 13: ``bin.mesh``'s sampling and keygen on the card (the same
    seed gives ``config4_zipf``'s keys), then the trusted crawl through
    ``driver.Leader(radix=cfg.crawl_radix_bits)``.  Keeps in ``tail`` the
    tail round's level and server 0's input frontier, which the round
    itself drops, for :func:`measure_radix`."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver
    from fuzzyheavyhitters_torch.workloads import sample_points

    rng = np.random.default_rng(seed)
    seconds = {}
    t0 = time.perf_counter()
    pts = sample_points(cfg, n, rng)
    seconds["sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device="cuda")
    torch.cuda.synchronize()
    seconds["keygen"] = time.perf_counter() - t0
    lead = driver.Leader(*driver.make_servers(k0, k1), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max, radix=cfg.crawl_radix_bits)
    del k0, k1
    step = lead.run_level

    def keep_tail(level, nreqs, threshold):
        if level + min(lead.radix, lead.data_len - level) == lead.data_len:
            tail.update(level=level, frontier=lead.server0.frontier)
        return step(level, nreqs, threshold)

    lead.run_level = keep_tail
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    torch.cuda.synchronize()
    seconds["crawl"] = time.perf_counter() - t0
    del lead.run_level
    return mesh.MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def same_sliced(got, want, what: str) -> int:
    """``same`` over paired tensors too large for its int64 copies, in
    slices of PLAIN_COMPARE elements."""
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: kernel {list(a.shape)} != plain {list(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for lo in range(0, a.numel(), PLAIN_COMPARE):
            hi = lo + PLAIN_COMPARE
            err = max(err, same((a[lo:hi],), (b[lo:hi],), f"{what} elements [{lo}, {hi})"))
    return err


def radix_check(name, keys, fr, level, r, want_children, ex, collect, prg, torch):
    """The fused level at ``level`` (r passes) of one server's ``keys`` from
    its frontier ``fr``, built twice: through the expand kernel, as the
    crawl builds it, and with the kernel replaced by its plain version on
    row slices; the radix word and the child cache of one against the
    other.  Times the fused level, its r kernel launches alone (CUDA events
    around each), and the plain build."""
    d, _, F, N = fr.states.bit.shape
    d2 = 2 * d
    orig = ex.expand_packed
    marks = []

    def timed(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig(*a)
        ev[1].record()
        marks.append(ev)
        return out

    def plain(seed, t, y, cws, cwf, derived, wc):
        B = t.shape[1]
        out = (torch.empty(B, dtype=torch.int32, device=t.device),
               torch.empty((2, 4, d2, B), dtype=torch.int32, device=t.device) if wc else None,
               torch.empty((d2, B), dtype=torch.uint8, device=t.device) if wc else None)
        for lo in range(0, B, PLAIN_ROWS):
            hi = min(B, lo + PLAIN_ROWS)
            p, sd, fl = ex.expand_packed_plain(seed[..., lo:hi], t[:, lo:hi], y[:, lo:hi],
                                               cws, cwf, derived, wc, row0=lo)
            out[0][lo:hi] = p
            if wc:
                out[1][..., lo:hi] = sd
                out[2][:, lo:hi] = fl
        return out

    build = lambda: collect.expand_share_bits_radix(keys, fr, level, r, want_children)
    flat = lambda w: (w[0],) if w[1] is None else (w[0], w[1].seed, w[1].flags)
    ex.expand_packed = timed
    try:
        got = flat(build())
    finally:
        ex.expand_packed = orig
    torch.cuda.synchronize()
    kernel_ms = sum(a.elapsed_time(b) for a, b in marks)
    box = {}
    ex.expand_packed = plain
    try:
        plain_ms = cuda_ms(lambda: box.update(w=flat(build())), 1)
    finally:
        ex.expand_packed = orig
    err = same_sliced(got, box.pop("w"), f"radix expand {name} level={level} r={r}")
    del got
    ms = cuda_ms(build, 3, warm=True)
    bounds = [expand_bound(F * N << t, N, d2, want_children or t + 1 < r, prg.DERIVED_BITS)
              for t in range(r)]
    b_ms = sum(b for b, _ in bounds)
    b_by = "+".join(by for _, by in bounds)
    log(f"radix expand {name} level={level} r={r} F={F} N={N} d2={d2} "
        f"want_children={want_children}: kernel == plain (radix word"
        f"{' and child cache' if want_children else ''}), max_abs_err={err} ms={ms:.4f} "
        f"kernel_ms={kernel_ms:.4f} ({r} launches) plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    return {"level": level, "r": r, "F": F, "N": N, "d2": d2, "want_children": want_children,
            "max_abs_err": err, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def measure_radix(name, run, cfg, tail, ex, collect, prg, torch):
    """Phase 13's kernel checks: server 0's fused level held against its
    plain build (``radix_check``) at the tail round, from the frontier
    ``radix_run`` kept in ``tail``, and at the widest round with a child
    cache, re-crawled from the keys up to that round only."""
    lead = run.leader
    L, k, n = lead.data_len, lead.radix, run.points.shape[0]
    keys = lead.server0.keys
    checks = [radix_check(name, keys, tail.pop("frontier"), tail["level"], L - tail["level"],
                          False, ex, collect, prg, torch)]
    checks[0]["kind"] = "tail"
    torch.cuda.empty_cache()
    bases = list(range(0, L, k))
    inner = lead.buckets[:-1]
    widest = bases[inner.index(max(inner))]
    lead.tree_init()
    try:
        for level in bases[:bases.index(widest)]:
            lead.run_level(level, n, cfg.threshold)
        checks.insert(0, radix_check(name, keys, lead.server0.frontier, widest, k, True, ex,
                                     collect, prg, torch))
        checks[0]["kind"] = "widest"
    finally:
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None
    return checks


def measure_keygen(name, points, cfg, kg, ibdcf, torch, rng, both_modes=False):
    """Phase 5: keygen at a crawl's shape (all N clients x n_dims x 2 keys
    x L levels in one call): kernel vs plain, bit-exact, timed (with
    ``both_modes``, also held in the other PRG bit mode)."""
    lo, hi = ibdcf.ball_bounds(points, cfg.ball_size)
    alpha = torch.from_numpy(np.stack([lo, hi], axis=-2).reshape(-1, cfg.data_len)).to("cuda")
    K, L = alpha.shape
    seeds = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(K, 2, 4)).astype(np.int32)).to("cuda")
    side = torch.from_numpy(np.tile([True, False], K // 2)).to("cuda")
    derived = ibdcf.prg.DERIVED_BITS
    ms = cuda_ms(lambda: kg.gen_cw(seeds, alpha, side, derived), 3, warm=True)
    got = kg.gen_cw(seeds, alpha, side, derived)
    box = {}
    plain_ms = cuda_ms(lambda: box.update(w=kg.gen_cw_plain(seeds, alpha, side, derived)), 1)
    err = same(got, box["w"], f"keygen {name}")
    if both_modes:
        other = kg.gen_cw(seeds, alpha, side, not derived)
        err = max(err, same(other, kg.gen_cw_plain(seeds, alpha, side, not derived),
                            f"keygen {name} (derived_bits={not derived})"))
        del other
    nbytes = K * 32 + K * L + K + K * L * (16 + 2 + 2)
    b_ms, b_by = bound(nbytes, K * L * 2 * CHACHA8_OPS)
    log(f"keygen {name} K={K} L={L}: kernel == plain"
        f"{' in both PRG bit modes' if both_modes else ''}, max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"K": K, "L": L, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


PLAIN = {"ot2s_encrypt": ("otext_cuda", "enc_planar_plain"),
         "ot2s_decrypt": ("otext_cuda", "dec_planar_plain"),
         "gc_garble": ("gc", "garble_planar_plain"),
         "gc_eval": ("gc", "eval_planar_plain")}


def secure_shape(kn, args):
    """(S, W, bp, B) of one call of a secure kernel's wrapper: bp the tests
    of its planar table or planes, B the tests it reads (bp for GC)."""
    oc = _ops("otext_cuda")
    if kn == "ot2s_encrypt":
        B, S = args[2].shape
        bp = args[6] if len(args) > 6 and args[6] is not None else _ops("gc").padded_tests(B)
        return S, args[3].shape[1], bp, B
    if kn == "ot2s_decrypt":
        B, S = args[1].shape
        W, _, _, _, n = oc.table_strides(args[2], S, B)
        return S, W, n, B
    if kn == "gc_garble":
        return args[3].shape[0], args[5].shape[0], args[1].shape[1], args[1].shape[1]
    return args[0].shape[0] // 4, args[4].shape[0] // 2, args[0].shape[1], args[0].shape[1]


def secure_bound(kn, S, W, bp, B=None):
    """Least time for one call: the bytes it must move — each input read
    once (ot2s: rows, 1-byte choices and payloads of the B real tests; the
    GC planes), except that of the ciphertext slots a test holds (2^S for
    ot2s, 2 for GC) it reads only the one it opens; each output written
    once (encrypt's whole table of bp tests) — and the ChaCha8 blocks it
    must hash."""
    B = bp if B is None else B
    if kn == "ot2s_encrypt":
        nbytes = B * (16 * S + S + 8 * W) + bp * (1 << S) * 4 * W
        blocks = bp * (1 << S)
    elif kn == "ot2s_decrypt":
        nbytes, blocks = B * (16 * S + S + 4 * W + 4 * W), B
    elif kn == "gc_garble":
        nbytes = bp * (32 * S + 4 * S + 4 + 8 * W + 32 * (S - 1) + 16 * S + 4 + 8 * W)
        blocks = bp * (4 * (S - 1) + 2)
    else:
        nbytes = bp * (32 * S + 32 * (S - 1) + 4 + 4 * W + 4 + 4 * W)
        blocks = bp * (2 * (S - 1) + 1)
    return bound(nbytes, blocks * CHACHA8_OPS)


def dec_sector_count(y, W: int, granule: int = 32) -> int:
    """Sectors of ``granule`` bytes that decrypt must read from a planar
    table: the distinct (plane, sector) pairs of the planes y_t * W + w
    that test t opens, y the tests' choices bool[B, S] (granule / 4 tests
    a sector of each plane)."""
    import torch

    B, S = y.shape
    k = granule // 4
    choice = ((y.to(torch.int64) & 1) << torch.arange(S, device=y.device)).sum(dim=1)
    key = (torch.arange(B, device=y.device) // k) * (1 << S) + choice
    seen = torch.zeros(-(-B // k) << S, dtype=torch.bool, device=y.device)
    seen[key] = True
    return int(seen.sum()) * W


def ot2s_floor(y, W, granule=32):
    """Decrypt's floor on a planar table: the rows, choices and output of
    its B tests, and the ``granule``-byte sectors of the planes that the
    choices ``y`` open (:func:`dec_sector_count`; 128 bytes: the lines
    those sectors touch), against its ChaCha8 blocks -> (ms, by,
    sectors)."""
    B, S = y.shape
    sectors = dec_sector_count(y, W, granule)
    ms, by = bound(B * (16 * S + S + 4 * W) + sectors * granule, B * CHACHA8_OPS)
    return ms, by, sectors


def _idx0(kn, args):
    return args[5] if kn == "ot2s_encrypt" else args[3] if kn == "ot2s_decrypt" else args[-1]


def _cut(kn, args, outs, lo, hi):
    """One call's arguments cut to tests [lo, hi), the pad index moved to
    test lo, and the kernel's outputs there."""
    if kn == "ot2s_encrypt":  # test-major rows (none past B); the planar table
        S, W, bp, _ = secure_shape(kn, args)
        q, s_block, x, m0, m1, idx0 = args[:6]
        planes = outs[0].reshape((1 << S) * W, bp)[:, lo:hi]
        return ((q[lo:hi], s_block, x[lo:hi], m0[lo:hi], m1[lo:hi], idx0 + lo, hi - lo),
                (planes.reshape(-1),))
    if kn == "ot2s_decrypt":  # the table's tests [lo, hi) as a [2^S, n, W] view
        S, _, _, B = secure_shape(kn, args)
        t, y, table, idx0 = args[:4]
        cts = _ops("otext_cuda").table_view(table, S, B)[:, lo:hi]
        return (t[lo:hi], y[lo:hi], cts, idx0 + lo), (outs[0][lo:hi],)
    head, planes = (args[:1], args[1:-1]) if kn == "gc_garble" else ((), args[:-1])
    return (head + tuple(a[:, lo:hi] for a in planes) + (args[-1] + lo,),
            tuple(o[:, lo:hi] for o in outs))


def secure_check(kn, args, got, kernel, what, reps=3):
    """A secure kernel's output on one call against its plain version on
    slices of PLAIN_TESTS tests, and the kernel timed on the same inputs."""
    S, W, bp, B = secure_shape(kn, args)
    plain = getattr(_ops(PLAIN[kn][0]), PLAIN[kn][1])
    outs = got if isinstance(got, tuple) else (got,)
    err, plain_ms = 0, 0.0
    n = B if kn == "ot2s_decrypt" else bp  # decrypt opens the B real tests
    for lo in range(0, n, PLAIN_TESTS):
        hi = min(n, lo + PLAIN_TESTS)
        (sl, mine), box = _cut(kn, args, outs, lo, hi), {}
        plain_ms += cuda_ms(lambda: box.update(w=plain(*sl)), 1)
        want = box["w"] if isinstance(box["w"], tuple) else (box["w"],)
        err = max(err, same(mine, want, f"{kn} {what} tests [{lo}, {hi})"))
    ms = cuda_ms(lambda: kernel(*args), reps, warm=True)
    b_ms, b_by = secure_bound(kn, S, W, bp, B)
    log(f"{kn} {what} S={S} W={W} bp={bp} B={B} idx0={_idx0(kn, args)}: kernel == plain, "
        f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
    return {"what": what, "S": S, "W": W, "bp": bp, "B": B, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def measure_secure(name, run, cfg, kns, torch):
    """Replay a secure crawl from its keys and sessions and hold each of its
    kernels against the plain version on the inputs the crawl gives it: at
    the widest FE62 level and at the F255 last level.  Between those levels
    the trusted exchange carries the frontier (it gives the same counts).
    The wrappers are wrapped to keep those calls' inputs and outputs."""
    lead = run.leader
    L, n = lead.data_len, run.points.shape[0]
    widest = max(lead.buckets[:-1])
    levels = {lead.buckets.index(widest): "widest_fe62", L - 1: "last_f255"}
    orig = {kn: getattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1]) for kn in kns}
    kept, on = {}, [False]

    def keeping(kn):
        def call(*a):
            out = orig[kn](*a)
            if on[0]:
                kept[kn] = (a, out)
            return out
        return call

    checks = []

    def each(level, before):
        on[0] = before and level in levels
        if before or level not in levels:
            return
        for kn in kns:
            a, out = kept.pop(kn)
            c = secure_check(kn, a, out, orig[kn], f"{name} level={level} "
                             f"({levels[level]}, F={lead.buckets[level]})")
            c.update(kernel=kn, level=level, kind=levels[level])
            checks.append(c)
            del a, out
        torch.cuda.empty_cache()

    for kn in kns:
        setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], keeping(kn))
    try:
        replay(lead, n, cfg.threshold, set(levels), each)
    finally:
        for kn in kns:
            setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], orig[kn])
    return checks


def stream_run(name, cfg, n, seed, tmp):
    """Phase 10: ``bench.py``'s streaming crawl on the card.  Sampling draws
    from ``default_rng(seed)`` as ``bin.mesh`` does; keygen runs in chunks
    of KEYGEN_HOST_CHUNK clients, each landed in host memory (timed with
    the copies); the peak memory counter is reset just before the crawl."""
    import torch

    from fuzzyheavyhitters_torch.bin import mesh
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver
    from fuzzyheavyhitters_torch.workloads import sample_points

    rng = np.random.default_rng(seed)
    seconds = {}
    t0 = time.perf_counter()
    pts = sample_points(cfg, n, rng)
    seconds["sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    h0, h1 = ibdcf.gen_l_inf_ball_host(pts, cfg.ball_size, rng, device="cuda",
                                       chunk=KEYGEN_HOST_CHUNK)
    torch.cuda.synchronize()
    seconds["keygen"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    lead = driver.Leader(*driver.make_servers(h0, h1, "cuda"), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max, **STREAM)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = lead.run(nreqs=n, threshold=cfg.threshold)
    torch.cuda.synchronize()
    seconds["crawl"] = time.perf_counter() - t0
    return mesh.MeshRun(points=pts, result=res, leader=lead, seconds=seconds)


def stream_launches(buckets, chunk):
    """Expand launches of a streamed crawl over ``buckets`` (one per level):
    per server, the level's expansion, and at each inner level one per
    advance chunk of the next bucket (the whole bucket when the chunk does
    not tile it)."""
    per = 0
    for level, F in enumerate(buckets):
        per += 1
        if level + 1 < len(buckets):
            F2 = buckets[level + 1]
            c = min(F2, chunk)
            per += F2 // c if F2 % c == 0 else 1
    return 2 * per


def measure_stream_expand(name, run, cfg, ex, prg, torch):
    """Phase 10's kernel checks: replay the streamed crawl level by level,
    keep server 0's expand calls of three kinds and hold each against the
    plain version: the level expansion at the first level of the second
    window (its cw sliced from an uploaded window), the first advance chunk
    (gathered parents, child cache) at the level before the widest inner
    bucket, and the level expansion at the widest bucket."""
    lead = run.leader
    b = lead.buckets
    L = lead.data_len
    want = {"window_slice": (lead.stream_window, False),
            "gathered_chunk": (max(range(L - 1), key=lambda lv: (b[lv + 1], -lv)), True),
            "widest_bucket": (b.index(max(b)), False)}
    kept, level_now = {}, [0]
    orig = ex.expand_packed

    def keeping(*a):
        for kind, key in want.items():
            if key == (level_now[0], a[-1]) and kind not in kept:
                kept[kind] = a
        return orig(*a)

    ex.expand_packed = keeping
    try:
        lead.tree_init()
        for level in range(L):
            level_now[0] = level
            lead.run_level(level, run.points.shape[0], cfg.threshold)
    finally:
        ex.expand_packed = orig
    checks = []
    for kind, (level, wc) in want.items():
        args = kept.pop(kind)[:5]
        d2, B = args[1].shape
        N = args[4].shape[1]
        err, ms, plain_ms = expand_check(ex, args, wc, prg.DERIVED_BITS, torch)
        b_ms, b_by = expand_bound(B, N, d2, wc, prg.DERIVED_BITS)
        checks.append({"kind": kind, "level": level, "F": B // N, "N": N, "d2": d2, "B": B,
                       "want_children": wc, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        log(f"expand {name} {kind} level={level} F={B // N} N={N} d2={d2} "
            f"want_children={wc}: kernel == plain, max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        del args
    return checks


class _Stopped(Exception):
    """Raised after the resume phase's checkpoint to stop its crawl there."""


def resume_run(name, run, cfg, tmp, want_hitters):
    """Phase 11: the streamed crawl of ``run``'s host keys, checkpointed
    after level RESUME_EVERY - 1 and stopped; a fresh leader over the same
    keys resumes it.  Returns its figures."""
    import torch

    from fuzzyheavyhitters_torch.protocol import driver

    keys = (run.leader.server0.keys, run.leader.server1.keys)
    n = run.points.shape[0]
    path = os.path.join(tmp, f"{name}.npz")
    fig = {}

    def leader():
        return driver.Leader(*driver.make_servers(*keys, "cuda"), n_dims=cfg.n_dims,
                             data_len=cfg.data_len, f_max=cfg.f_max, **STREAM)

    first = leader()
    write = first.checkpoint

    def checkpoint(*a):
        t0 = time.perf_counter()
        first._key_fingerprint()
        fig["fingerprint_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write(*a)
        fig["write_s"] = time.perf_counter() - t0
        fig["level"] = a[1]
        raise _Stopped

    first.checkpoint = checkpoint
    t0 = time.perf_counter()
    try:
        first.run(nreqs=n, threshold=cfg.threshold, checkpoint_path=path,
                  checkpoint_every=RESUME_EVERY)
        raise AssertionError(f"{name}: the crawl wrote no checkpoint")
    except _Stopped:
        pass
    fig["first_s"] = time.perf_counter() - t0
    fig["bytes"] = os.path.getsize(path)
    del first
    torch.cuda.empty_cache()
    second = leader()
    restore = second.restore

    def timed_restore(*a):
        t0 = time.perf_counter()
        second._key_fingerprint()
        t1 = time.perf_counter()
        out = restore(*a)
        torch.cuda.synchronize()
        fig["restore_fingerprint_s"], fig["restore_s"] = t1 - t0, time.perf_counter() - t1
        return out

    second.restore = timed_restore
    t0 = time.perf_counter()
    res = second.run(nreqs=n, threshold=cfg.threshold, checkpoint_path=path,
                     checkpoint_every=RESUME_EVERY, resume=True)
    torch.cuda.synchronize()
    fig["resumed_s"] = time.perf_counter() - t0
    fig["levels_resumed"] = len(second.timings["expand"])
    got = {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
    if got != want_hitters:
        raise AssertionError(f"{name}: resumed hitters differ from the streamed crawl's")
    if os.path.exists(path) or os.path.exists(path + ".tmp"):
        raise AssertionError(f"{name}: the completed crawl left its checkpoint behind")
    if fig["level"] != RESUME_EVERY - 1 or fig["levels_resumed"] != cfg.data_len - RESUME_EVERY:
        raise AssertionError(f"{name}: checkpoint after level {fig['level']}, "
                             f"{fig['levels_resumed']} levels resumed")
    log(f"resume {name}: checkpoint after level {fig['level']} bytes={fig['bytes']} "
        f"fingerprint_s={fig['fingerprint_s']:.3f} write_s={fig['write_s']:.3f} "
        f"restore_s={fig['restore_s']:.3f} (its fingerprint "
        f"{fig['restore_fingerprint_s']:.3f} s) crawl_to_checkpoint_s={fig['first_s']:.3f} "
        f"resumed_crawl_s={fig['resumed_s']:.3f} levels_resumed={fig['levels_resumed']} "
        f"hitters={len(got)} (= the streamed crawl's); the file is gone")
    return fig


def chunk_checks(torch, seed):
    """Every secure kernel on CHUNK_TESTS random tests with the pad index
    starting at CHUNK_IDX0, so the u32 index wraps inside the batch."""
    oc, gcc = _ops("otext_cuda"), _ops("gc_cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = CHUNK_TESTS
    words = lambda r: torch.randint(-2**31, 2**31, (r, n), dtype=torch.int32,
                                    device="cuda", generator=g)
    bits = lambda r: torch.randint(0, 2, (r, n), dtype=torch.int32, device="cuda", generator=g)
    checks = {kn: [] for kn in OT2S + GC}
    for S in (2, 4, 6):
        for W in (4, 8):
            q, s_block, x, m0, m1 = ot2s_inputs(torch, g, n, S, W)
            a = (q, s_block, x, m0, m1, CHUNK_IDX0)
            cts = oc.enc_planar(*a)
            checks["ot2s_encrypt"].append(secure_check("ot2s_encrypt", a, cts,
                                                       oc.enc_planar, "chunk", 1))
            t, _, y, _, _ = ot2s_inputs(torch, g, n, S, W)
            a = (t, y, cts, CHUNK_IDX0)
            checks["ot2s_decrypt"].append(secure_check("ot2s_decrypt", a, oc.dec_planar(*a),
                                                       oc.dec_planar, "chunk", 1))
            del q, x, m0, m1, t, y, cts, a
    for S in (2, 4, 6, 8, 16):
        for W in (4, 8):
            R = [int(v) for v in torch.randint(0, 2**32, (4,), generator=torch.Generator()
                                               .manual_seed(seed + S + W))]
            R[0] |= 1
            a = (R, words(4 * S), words(4 * S), bits(S), bits(1), words(W), words(W),
                 CHUNK_IDX0)
            tab, gbl, dec, cts = gcc.garble_planar(*a)
            checks["gc_garble"].append(secure_check("gc_garble", a, (tab, gbl, dec, cts),
                                                    gcc.garble_planar, "chunk", 1))
            a = (gbl, words(4 * S), tab, dec, cts, CHUNK_IDX0)
            checks["gc_eval"].append(secure_check("gc_eval", a, gcc.eval_planar(*a),
                                                  gcc.eval_planar, "chunk", 1))
            del tab, gbl, dec, cts, a
    return checks


def ot2s_inputs(torch, g, B, S, W):
    """Random test-major ot2s inputs on the card from generator ``g``: (rows
    int32[B, S, 4], an s_block with lsb 1, choices bool[B, S], two payloads
    int32[B, W])."""
    words = lambda *shape: torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                                         device="cuda", generator=g)
    s_block = np.asarray(words(4).cpu().numpy().view(np.uint32))
    s_block[0] |= 1
    x = torch.randint(0, 2, (B, S), dtype=torch.bool, device="cuda", generator=g)
    return words(B, S, 4), s_block, x, words(B, W), words(B, W)


def _device_ms(torch, fn, reps, graph=True):
    """Milliseconds of device time a call of ``fn``: ``reps`` calls captured
    in a CUDA graph and replayed (no host work between the launches), or,
    for calls that cannot be captured (a tree whose step copies from host
    memory), ``torch.profiler``'s kernel, copy and fill time summed."""
    fn()
    torch.cuda.synchronize()
    if graph:
        g, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        ms = cuda_ms(g.replay, 3) / reps
        del g
        return ms
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / reps


def _host_us(torch, fn, reps):
    """Host microseconds a call of ``fn`` takes to return, the card's queue
    drained first (the launches queue up behind it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def ot2s_time_shape(torch, secure_mod, S, W, B, seed, reps=OT2S_TIMING_REPS, graph=True):
    """A level's encrypt and decrypt steps through ``secure_mod``'s packed
    entries (``secure.ot2s_encrypt_packed`` / ``ot2s_decrypt_packed`` of any
    tree of the port) on random inputs from ``seed``: per step its
    milliseconds (CUDA events, warm, mean of ``reps`` calls), device
    milliseconds (:func:`_device_ms`, by a CUDA graph unless ``graph`` is
    off) and host microseconds a call -> ({"encrypt": ..., "decrypt":
    ...}, the choices y, the outputs)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, s_block, x, m0, m1 = ot2s_inputs(torch, g, B, S, W)
    t, _, y, _, _ = ot2s_inputs(torch, g, B, S, W)
    idx0 = CHUNK_IDX0
    enc = lambda: secure_mod.ot2s_encrypt_packed(q, s_block, x, m1, m0, W, idx0)
    msg = enc()
    dec = lambda: secure_mod.ot2s_decrypt_packed(t, y, msg, W, idx0)
    pay = dec()
    out = {}
    for step, fn in (("encrypt", enc), ("decrypt", dec)):
        out[step] = {"ms": cuda_ms(fn, reps, warm=True),
                     "device_ms": _device_ms(torch, fn, reps, graph),
                     "device_by": "graph" if graph else "profiler",
                     "host_us": _host_us(torch, fn, reps)}
    del q, x, m0, m1, t
    return out, y, (msg, pay)


def ot2s_instantiation(fns: dict, which: str, S: int, W: int):
    """The entry of ``fns`` (keyed by mangled name) of the ot2s kernel
    ``which`` ("enc" or "dec") compiled for (S, W); else None."""
    names = [k for k in fns if f"fhh_ot2s_{which}_kernelILi{S}ELi{W}E" in k]
    return fns[names[0]] if len(names) == 1 else None


def ot2s_timing(torch, seed):
    """The ot2s timing line: each level's encrypt and decrypt step at each
    shape of OT2S_TIMING, with its bound, decrypt's sector floor at 32 and
    64 bytes, the ratios, and the ptxas registers and spills and the SASS
    instructions of the kernel it ran."""
    cb = _ops("cuda_build")
    from fuzzyheavyhitters_torch.protocol import secure

    ptx = ptxas_by_function(cb.log_path("ot2s").read_text())
    sass = sass_by_function(cb.lib_path("ot2s"))
    rows = []
    for i, (what, S, W, B) in enumerate(OT2S_TIMING):
        steps, y, outs = ot2s_time_shape(torch, secure, S, W, B, seed + i)
        del outs
        floors = {gr: ot2s_floor(y, W, gr) for gr in (32, 64, 128)}
        del y
        torch.cuda.empty_cache()
        for kn, which in (("ot2s_encrypt", "enc"), ("ot2s_decrypt", "dec")):
            st = steps["encrypt" if which == "enc" else "decrypt"]
            b_ms, b_by = secure_bound(kn, S, W, _ops("gc").padded_tests(B), B)
            px = ot2s_instantiation(ptx, which, S, W) or {}
            row = {"kernel": kn, "what": what, "S": S, "W": W, "B": B, **st,
                   "bound_ms": b_ms, "bound_by": b_by, "ratio": st["ms"] / b_ms,
                   "device_ratio": st["device_ms"] / b_ms,
                   "registers": px.get("registers"), "spill_stores": px.get("spill_stores"),
                   "spill_loads": px.get("spill_loads"),
                   "sass_instructions": ot2s_instantiation(sass, which, S, W)}
            if kn == "ot2s_decrypt":
                for gr, (f_ms, f_by, sectors) in floors.items():
                    row.update({f"floor{gr}_ms": f_ms, f"floor{gr}_by": f_by,
                                f"sectors{gr}": sectors})
                row["floor_ratio"] = st["ms"] / row["floor32_ms"]
                row["device_floor_ratio"] = st["device_ms"] / row["floor32_ms"]
            rows.append(row)
            floor = (f" floor32_ms={row['floor32_ms']:.4f} floor64_ms={row['floor64_ms']:.4f} "
                     f"floor128_ms={row['floor128_ms']:.4f} "
                     f"device/floor32={row['device_floor_ratio']:.3f} device/floor64="
                     f"{st['device_ms'] / row['floor64_ms']:.3f} device/floor128="
                     f"{st['device_ms'] / row['floor128_ms']:.3f}"
                     if kn == "ot2s_decrypt" else "")
            log(f"ot2s timing {kn} {what} S={S} W={W} B={B}: ms={st['ms']:.4f} "
                f"device_ms={st['device_ms']:.4f} host_us={st['host_us']:.1f} "
                f"bound_ms={b_ms:.4f} ({b_by}) device/bound={row['device_ratio']:.3f}{floor} "
                f"registers={row['registers']} spills={row['spill_stores']}/"
                f"{row['spill_loads']} B sass={row['sass_instructions']}")
    log(json.dumps({"ot2s_timing": rows}))
    return rows


def gc_time_shape(torch, gcc, S, W, bp, seed, reps=GC_TIMING_REPS):
    """Garble and eval of ``gcc`` (a ``gc_cuda`` module) at one shape on
    random inputs from ``seed``, each timed warm over ``reps`` launches
    (CUDA events) -> (garble ms, eval ms, every output of both)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    words = lambda r: torch.randint(-2**31, 2**31, (r, bp), dtype=torch.int32,
                                    device="cuda", generator=g)
    bits = lambda r: torch.randint(0, 2, (r, bp), dtype=torch.int32, device="cuda", generator=g)
    R = [int(v) for v in torch.randint(0, 2**32, (4,), generator=torch.Generator()
                                       .manual_seed(seed))]
    R[0] |= 1
    a = (R, words(4 * S), words(4 * S), bits(S), bits(1), words(W), words(W), CHUNK_IDX0)
    garbled = gcc.garble_planar(*a)
    g_ms = cuda_ms(lambda: gcc.garble_planar(*a), reps, warm=True)
    tab, gbl, dec, cts = garbled
    b = (gbl, words(4 * S), tab, dec, cts, CHUNK_IDX0)
    del a
    opened = gcc.eval_planar(*b)
    e_ms = cuda_ms(lambda: gcc.eval_planar(*b), reps, warm=True)
    return g_ms, e_ms, garbled + opened


def ptxas_by_function(text: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {mangled function: {"registers",
    "spill_stores", "spill_loads"}} (each ``Function properties for F``
    line, then its spill line and its ``Used N registers`` line)."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def sass_by_function(lib_path) -> dict:
    """{mangled function: SASS instructions} of a built library
    (``cuobjdump -sass``; {} where the toolkit has no cuobjdump)."""
    import re

    tool = os.path.join(os.path.dirname(_ops("cuda_build").nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 1
    return out


def gc_instantiation(fns: dict, which: str, S: int, W: int):
    """The entry of ``fns`` (keyed by mangled name) of the GC kernel
    ``which`` ("garble" or "eval") that runs (S, W): the one templated on W,
    or on (S, W) in a tree before S became a kernel argument; else None."""
    syms = (f"fhh_gc_{which}_kernelILi{W}EEv", f"fhh_gc_{which}_kernelILi{S}ELi{W}EEv")
    hits = [v for k, v in fns.items() if any(sym in k for sym in syms)]
    return hits[0] if len(hits) == 1 else None


def gc_timing(torch, seed):
    """The GC timing line: garble and eval at each shape of GC_TIMING, with
    its bound, the ratio, and the ptxas registers and spills and the SASS
    instructions of the instantiation it ran."""
    gcc, cb = _ops("gc_cuda"), _ops("cuda_build")
    ptx = ptxas_by_function(cb.log_path("gc").read_text())
    sass = sass_by_function(cb.lib_path("gc"))
    rows = []
    for i, (what, S, W, bp) in enumerate(GC_TIMING):
        g_ms, e_ms, outs = gc_time_shape(torch, gcc, S, W, bp, seed + i)
        del outs
        torch.cuda.empty_cache()
        for kn, which, ms in (("gc_garble", "garble", g_ms), ("gc_eval", "eval", e_ms)):
            b_ms, b_by = secure_bound(kn, S, W, bp)
            px = gc_instantiation(ptx, which, S, W) or {}
            row = {"kernel": kn, "what": what, "S": S, "W": W, "bp": bp, "ms": ms,
                   "bound_ms": b_ms, "bound_by": b_by, "ratio": ms / b_ms,
                   "registers": px.get("registers"), "spill_stores": px.get("spill_stores"),
                   "spill_loads": px.get("spill_loads"),
                   "sass_instructions": gc_instantiation(sass, which, S, W)}
            rows.append(row)
            log(f"gc timing {kn} {what} S={S} W={W} bp={bp}: ms={ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) ratio={row['ratio']:.3f} "
                f"registers={row['registers']} spills={row['spill_stores']}/"
                f"{row['spill_loads']} B sass={row['sass_instructions']}")
    log(json.dumps({"gc_timing": rows}))
    return rows


def _hitter_map(res):
    return {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}


def _mesh_widths(lead):
    """The frontier bucket at each level of a MeshLeader's last crawl."""
    from fuzzyheavyhitters_torch.protocol import collect

    r = lead.r
    return [r.min_bucket] + [collect.bucket_for(lead.survivors[lv], r.f_max, r.min_bucket)
                             for lv in range(r.data_len - 1)]


def mesh_cell_run(name, cfg, n, seed, tmp):
    """``bin.mesh.run`` on the card's 2 x 4 mesh of logical shards."""
    from fuzzyheavyhitters_torch.bin import mesh

    with open(os.path.join(tmp, f"{name}_events.jsonl"), "w") as out, json_logs(out):
        return mesh.run(cfg, n, device="cuda", seed=seed, devices=MESH_DEVICES,
                        csv_path=os.path.join(tmp, f"{name}_hitters.csv"))


def mesh_main_path(name, cfg, n, seed, tmp, per_level, want_hitters, base):
    """Phases 22-24: one mesh collection with every kernel count zeroed just
    before and read just after.  expand must launch 2 x MESH_SHARDS times a
    level and keygen once, each kernel of ``per_level`` MESH_SHARDS times a
    level, every other kernel never; the hitters must equal ``want_hitters``
    (the one-card cell ``base``'s) and the recount.  Returns (run,
    launches, figures)."""
    import torch

    from fuzzyheavyhitters_torch.protocol import secure

    torch.cuda.reset_peak_memory_stats()
    for kn in KERNELS:
        setattr(*_counter(kn), 0)
    run = mesh_cell_run(name, cfg, n, seed, tmp)
    launches = {kn: getattr(*_counter(kn)) for kn in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    lead, res = run.leader, run.result
    levels = len(lead.timings["level"])
    want = {kn: (MESH_SHARDS * levels if kn in per_level else 0) for kn in OT2S + GC}
    want.update(keygen=1, expand=2 * MESH_SHARDS * levels)
    if levels != cfg.data_len or launches != want:
        raise AssertionError(f"{name}: {levels} levels, launches {launches}, want {want}")
    got = _hitter_map(res)
    if got != want_hitters:
        raise AssertionError(f"{name}: {len(got)} hitters differ from {base}'s")
    recount = plaintext_counts(run.points, cfg.ball_size, res.paths)
    if not np.array_equal(res.counts, recount):
        raise AssertionError(f"{name}: counts != the plaintext recount")
    log(f"mesh {name}: N={n} mesh=2x{MESH_SHARDS} on {run.leader.r.mesh.placement()[0][0]} "
        f"secure={cfg.secure_exchange} eq_ot4={secure.EQ_OT4} levels={levels} "
        f"hitters={len(got)} (= {base}'s, each = the plaintext recount) "
        f"seconds={ {k: round(v, 3) for k, v in run.seconds.items()} } "
        f"max_memory_allocated={peak} launches={launches} "
        f"buckets_max={max(_mesh_widths(lead))}")
    return run, launches, {"n": n, "levels": levels, "hitters": len(got),
                           "seconds": run.seconds, "max_memory_allocated": peak,
                           "launches": launches}


def mesh_expand_checks(name, run, cfg, ex, collect, prg, torch):
    """Phase 22: replay the mesh crawl (the trusted exchange: the same
    counts, so the same frontiers) and hold expand against its plain
    version on shard (0, 0)'s frontier at the widest level with a child
    cache and at the last level."""
    lead, r = run.leader, run.leader.r
    L, n = r.data_len, run.points.shape[0]
    widths = _mesh_widths(lead)
    widest = max(range(L - 1), key=lambda lv: (widths[lv], -lv))
    targets, checks = {widest: "widest", L - 1: "last"}, []
    secure_flag, r.secure = r.secure, False
    try:
        lead._reset()
        lead._start()
        for level in range(L):
            if level in targets:
                st = r.frontier[0][0].states
                d, _, F, N = st.bit.shape
                d2, B = 2 * d, F * N
                cws, cwf = collect.level_cw_planar(r.keys[0][0], level)
                args = (st.seed.reshape(4, d2, B), st.bit.reshape(d2, B),
                        st.y_bit.reshape(d2, B), cws, cwf)
                last = level == L - 1
                err, ms, plain_ms = expand_check(ex, args, not last, prg.DERIVED_BITS, torch)
                b_ms, b_by = expand_bound(B, N, d2, not last, prg.DERIVED_BITS)
                checks.append({"kind": targets[level], "level": level, "F": F, "N": N,
                               "want_children": not last, "max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
                log(f"expand {name} shard (0, 0) level={level} ({targets[level]}) F={F} "
                    f"N={N} want_children={not last}: kernel == plain, max_abs_err={err} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
            if level < L - 1:
                lead._run_one_level(level, n, cfg.threshold)
    finally:
        r.secure = secure_flag
    return checks


def mesh_secure_checks(name, run, cfg, kns, levels, torch):
    """Phases 23-24: replay the mesh crawl, secure at ``levels`` (kind by
    level) and trusted elsewhere, and hold each kernel of ``kns`` against
    its plain version on the first shard's call at those levels."""
    lead, r = run.leader, run.leader.r
    n = run.points.shape[0]
    orig = {kn: getattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1]) for kn in kns}
    kept, on = {}, [False]

    def keeping(kn):
        def call(*a):
            out = orig[kn](*a)
            if on[0] and kn not in kept:
                kept[kn] = (a, out)
            return out
        return call

    checks = []
    widths = _mesh_widths(lead)
    for kn in kns:
        setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], keeping(kn))
    try:
        lead._reset()
        lead._start()
        for level in range(r.data_len):
            r.secure = on[0] = level in levels
            lead._run_one_level(level, n, cfg.threshold)
            on[0] = False
            for kn in kns if level in levels else ():
                a, out = kept.pop(kn)
                c = secure_check(kn, a, out, orig[kn], f"{name} shard 0 level={level} "
                                 f"({levels[level]}, F={widths[level]})")
                c.update(kernel=kn, level=level, kind=levels[level])
                checks.append(c)
                del a, out
            torch.cuda.empty_cache()
    finally:
        r.secure = True
        for kn in kns:
            setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], orig[kn])
    return checks


def mesh_two_process_run(name, cfg, n, seed, tmp):
    """Phase 25: two ``bin.mesh --devices 8 --processes 2`` processes on a
    gloo group at a free localhost port, one mesh row each on the card;
    both stopped if either outlives SOCKET_LEADER_S.  Returns each
    process's events."""
    work = os.path.join(tmp, name)
    os.makedirs(work)
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, **LOG_ENV,
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    coord = f"127.0.0.1:{free_ports()[0]}"
    logs = [os.path.join(work, f"p{pid}.log") for pid in (0, 1)]
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in (0, 1):
            procs.append(POOL.start(
                "fuzzyheavyhitters_torch.bin.mesh",
                ["-c", cfg_path, "-n", str(n), "--device", "cuda", "--seed", str(seed),
                 "--devices", str(MESH_DEVICES), "--processes", "2", "--process_id", str(pid),
                 "--coordinator", coord, "--csv", os.path.join(work, f"hh{pid}.csv")],
                work, env, logs[pid]))
        for p in procs:
            p.wait(timeout=max(1.0, SOCKET_LEADER_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[pid]) as f:
                raise AssertionError(f"{name}: process {pid} exited {p.returncode}:\n"
                                     f"{f.read()[-3000:]}")
    return [_events(path) for path in logs], time.perf_counter() - t0


def check_two_process_run(name, cfg, events, wall_s, want_hitters, points, secure):
    """Phase 25's checks: each process's hitters = ``want_hitters`` and the
    recount, its row held alone, its group bytes mirrored by the other's,
    and its launches: 4 expand a level (keygen once); secure, 4 encrypts a
    level it garbled (level % 2 == its row) and 4 decrypts a level it
    evaluated; no GC."""
    figs = []
    for pid, ev in enumerate(events):
        got = {e["value"]: e["count"] for e in ev if e["event"] == "hitter"}
        if got != want_hitters:
            raise AssertionError(f"{name}: process {pid}'s {len(got)} hitters differ")
        _recount(f"{name} p{pid}", got, cfg, points)
        place = next(e for e in ev if e["event"] == "mesh.placement")
        done = next(e for e in ev if e["event"] == "crawl.done")
        L = done["levels"]
        garbled = len([lv for lv in range(L) if lv % 2 == pid])
        want = {"keygen": 1, "expand": MESH_SHARDS * L, "gc_garble": 0, "gc_eval": 0,
                "ot2s_encrypt": MESH_SHARDS * garbled if secure else 0,
                "ot2s_decrypt": MESH_SHARDS * (L - garbled) if secure else 0}
        if place["held_rows"] != [pid] or done["launches"] != want or L != cfg.data_len:
            raise AssertionError(f"{name} p{pid}: rows {place['held_rows']}, {L} levels, "
                                 f"launches {done['launches']}, want {want}")
        figs.append({"crawl_s": done["seconds"], "group_bytes": done["group_bytes"],
                     "launches": done["launches"], "mesh_setup_s": place["seconds"]})
    if figs[0]["group_bytes"]["sent"] != figs[1]["group_bytes"]["received"]:
        raise AssertionError(f"{name}: group bytes {[f['group_bytes'] for f in figs]}")
    log(f"mesh {name}: 2 processes x 1 row of {MESH_SHARDS} shards on the card over gloo, "
        f"N={points.shape[0]} secure={secure}: both print the one-process hitters "
        f"({len(want_hitters)}, each = the plaintext recount); crawl_s="
        f"{[round(f['crawl_s'], 3) for f in figs]} group_bytes="
        f"{[f['group_bytes'] for f in figs]} launches={[f['launches'] for f in figs]} "
        f"wall_s={wall_s:.1f}")
    return {"processes": figs, "wall_s": wall_s, "hitters": len(want_hitters)}


def mesh_supervised_run(name, cfg, n, seed, want_hitters, torch):
    """Phase 26: rides' keys from the seed (``bin.mesh``'s sampling and
    keygen), ``MeshLeader.run_supervised`` on the 2 x 4 mesh with a
    snapshot every MESH_CKPT_EVERY levels under MESH_FAULTS, every kernel
    count zeroed just before and read just after."""
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.parallel import mesh as meshmod
    from fuzzyheavyhitters_torch.resilience.chaos import MeshChaos, parse_mesh_faults
    from fuzzyheavyhitters_torch.workloads import sample_points

    rng = np.random.default_rng(seed)
    pts = sample_points(cfg, n, rng)
    k0, k1 = ibdcf.gen_l_inf_ball(pts, cfg.ball_size, rng, device="cuda")
    runner = meshmod.MeshRunner(meshmod.make_mesh(MESH_DEVICES), k0, k1, cfg.f_max)
    del k0, k1
    snaps, restores = [], []
    snapshot, restore = runner.snapshot, runner.restore

    def timed_snapshot():
        t0 = time.perf_counter()
        snap = snapshot()
        snaps.append((sum(a.nbytes for a in snap.values()), time.perf_counter() - t0))
        return snap

    def timed_restore(snap):
        t0 = time.perf_counter()
        restore(snap)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)

    runner.snapshot, runner.restore = timed_snapshot, timed_restore
    chaos = MeshChaos(parse_mesh_faults(MESH_FAULTS))
    events = []
    lead = meshmod.MeshLeader(runner, emit=lambda e, **kw: events.append((e, kw)))
    for kn in KERNELS:
        setattr(*_counter(kn), 0)
    t0 = time.perf_counter()
    res = lead.run_supervised(n, cfg.threshold, checkpoint_every=MESH_CKPT_EVERY, chaos=chaos)
    torch.cuda.synchronize()
    crawl_s = time.perf_counter() - t0
    launches = {kn: getattr(*_counter(kn)) for kn in KERNELS}
    c = lead.counters
    runs = c["device_fetches"]  # one fetch per level run, the re-runs included
    want = dict.fromkeys(KERNELS, 0)
    want["expand"] = 2 * MESH_SHARDS * runs
    if (_hitter_map(res) != want_hitters or launches != want
            or (c["recoveries"], c["shards_rerun"], c["levels_rerun"]) != (2, 1, 1)
            or sorted(a for a, _ in chaos.fired) != ["delay", "drop", "kill"]):
        raise AssertionError(f"{name}: counters {c}, fired {chaos.fired}, launches {launches} "
                             f"(want {want}), hitters equal: {_hitter_map(res) == want_hitters}")
    recount = plaintext_counts(pts, cfg.ball_size, res.paths)
    if not np.array_equal(res.counts, recount):
        raise AssertionError(f"{name}: counts != the plaintext recount")
    log(f"mesh {name}: N={n} faults {MESH_FAULTS!r} fired {chaos.fired}: hitters = rides' "
        f"(each = the plaintext recount), counters={c} levels_run={runs} crawl_s={crawl_s:.3f} "
        f"snapshots (bytes, s)={[(b, round(t, 4)) for b, t in snaps]} "
        f"restore_s={[round(t, 4) for t in restores]} launches={launches}")
    return {"n": n, "counters": dict(c), "fired": chaos.fired, "crawl_s": crawl_s,
            "snapshots": snaps, "restore_s": restores, "launches": launches,
            "events": [e for e, _ in events]}


def mesh_phases(seed, cells, hitters, points, report, launches, errs, tmp, stage):
    """Phases 22-26 on the one-card cells' hitters and points; figures go to
    ``report["mesh"]``, launches and errors to ``launches`` and ``errs``."""
    import torch

    from fuzzyheavyhitters_torch.ops import expand_cuda, prg
    from fuzzyheavyhitters_torch.protocol import collect
    from fuzzyheavyhitters_torch.protocol import secure as secure_mod

    mesh_figs = report["mesh"] = {}
    # phase 22: config4_zipf on the 2 x 4 mesh of logical shards
    name, cfg4 = "config4_mesh", cells["config4_zipf"][0]
    run, launches[name], fig = mesh_main_path(name, cfg4, ZIPF_CLIENTS, seed, tmp, (),
                                              hitters["config4_zipf"], "config4_zipf")
    base = report["crawls"]["config4_zipf"]
    log(f"mesh {name}: crawl_s={run.seconds['crawl']:.3f} (config4_zipf: "
        f"{base['seconds']['crawl']:.3f}) keygen_s={run.seconds['keygen']:.3f} "
        f"max_memory_allocated={fig['max_memory_allocated']} (config4_zipf: "
        f"{base['max_memory_allocated']})")
    stage(f"{name} crawl")
    fig["expand_checks"] = mesh_expand_checks(name, run, cfg4, expand_cuda, collect, prg,
                                              torch)
    errs["expand"] += [c["max_abs_err"] for c in fig["expand_checks"]]
    mesh_figs[name] = fig
    del run
    torch.cuda.empty_cache()
    stage(f"{name} checks")
    # phases 23-24: secure rides on the mesh, the 1-of-16 table, then the GC
    rides_sec = cells["rides_secure"][0]
    for name, eq_ot4, kns in (("rides_mesh_secure", True, OT2S),
                              ("rides_mesh_secure_gc", False, GC)):
        secure_mod.EQ_OT4 = eq_ot4
        try:
            run, launches[name], fig = mesh_main_path(
                name, rides_sec, RIDES_SECURE_CLIENTS, seed, tmp, kns,
                hitters["rides_secure"], "rides_secure")
            stage(f"{name} crawl")
            widths, L = _mesh_widths(run.leader), rides_sec.data_len
            widest = max(range(L - 1), key=lambda lv: (widths[lv], -lv))
            levels = {widest: "widest_fe62"}
            if kns == OT2S:
                levels[L - 1] = "last_f255"
            fig["secure_checks"] = mesh_secure_checks(name, run, rides_sec, kns, levels,
                                                      torch)
        finally:
            secure_mod.EQ_OT4 = True
        for c in fig["secure_checks"]:
            errs[c["kernel"]].append(c["max_abs_err"])
        mesh_figs[name] = fig
        del run
        torch.cuda.empty_cache()
        stage(f"{name} secure checks")
    # phase 25: the mesh in two processes, one row each, over gloo
    name = "rides_mesh_2proc"
    ev, wall = mesh_two_process_run(name, cells["rides"][0], RIDES_CLIENTS, seed, tmp)
    mesh_figs[name] = check_two_process_run(name, cells["rides"][0], ev, wall,
                                            hitters["rides"], points["rides"], False)
    stage(f"{name} run")
    name = "rides_mesh_2proc_secure"
    one = mesh_cell_run(f"{name}_one", rides_sec, MESH_2PROC_SECURE_CLIENTS, seed, tmp)
    want_h, one_pts = _hitter_map(one.result), one.points
    if not np.array_equal(one.result.counts, plaintext_counts(
            one_pts, rides_sec.ball_size, one.result.paths)):
        raise AssertionError(f"{name}: the one-process counts != the plaintext recount")
    del one
    torch.cuda.empty_cache()
    ev, wall = mesh_two_process_run(name, rides_sec, MESH_2PROC_SECURE_CLIENTS, seed,
                                    tmp)
    mesh_figs[name] = check_two_process_run(name, rides_sec, ev, wall, want_h, one_pts, True)
    stage(f"{name} run")
    # phase 26: the supervised mesh crawl under MeshChaos
    name = "rides_mesh_supervised"
    mesh_figs[name] = mesh_supervised_run(name, cells["rides"][0], RIDES_CLIENTS, seed,
                                          hitters["rides"], torch)
    launches[name] = mesh_figs[name]["launches"]
    torch.cuda.empty_cache()
    stage(f"{name} run")

def _shard_flats(flat, ks, Sharded, torch):
    """A whole level's strings bool[B, S] as the kernel shards' slices of
    ``bloc`` tests (zero past B), on their devices."""
    pad = torch.zeros((ks.bp, flat.shape[1]), dtype=torch.bool, device=flat.device)
    pad[:flat.shape[0]] = flat
    return Sharded([pad[j * ks.bloc:(j + 1) * ks.bloc].to(dev)
                    for j, dev in enumerate(ks.devices)], 0)


def k3_check(name, kind, level, flats, field, path, garbler, seed, torch):
    """K3 at one level: (a) ``kernel_shard.run_level_pair`` over SHARDS logical
    shards of the card gives the u matrix, the frame and both parties' b2a
    values of the whole-level path (k = 1) on the same OT material; (b) each
    shard's kernel call equals its plain version on that shard's inputs; (c)
    each is timed beside its bound (:func:`secure_check`).  ``flats`` are the
    two servers' strings bool[F, C, N, S].  -> the per-shard checks."""
    import random

    from fuzzyheavyhitters_torch.ops import otext
    from fuzzyheavyhitters_torch.parallel import kernel_shard
    from fuzzyheavyhitters_torch.parallel.server_mesh import Sharded
    from fuzzyheavyhitters_torch.protocol import secure
    from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

    dev = torch.device("cuda")
    F, C, N, S = flats[0].shape
    B = F * C * N
    fs, fr = (f.reshape(B, S) for f in flats)
    base = np.arange(1, 5, dtype=np.uint32)
    gseed, bseed = secure.derive_seed(base, 1, level), secure.derive_seed(base, 2, level)
    snd1, rcv1 = otext.inprocess_pair(dev, rng=random.Random(seed))
    snd4, rcv4 = otext.inprocess_pair(dev, rng=random.Random(seed))
    t0 = time.perf_counter()
    u, t_rows, idx0 = secure.ev_step1_fused(rcv1, fr)
    u1 = words_to_numpy(u)
    msg, vs1 = secure.gb_step_level(snd1, words_from_numpy(u1, dev), fs, gseed, bseed, field,
                                    garbler, path)
    m1 = words_to_numpy(msg)
    vr1 = secure.ev_open_level(t_rows, fr, msg, B, S, field, idx0, path)
    del u, t_rows, msg
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    ks = kernel_shard.bind((dev,) * SHARDS, B, S, SHARDS)
    if ks is None or ks.k != SHARDS:
        raise AssertionError(f"{name}: level {level} binds {ks} kernel shards, want {SHARDS}")
    kns = OT2S if path == "ot2s" else GC
    orig = {kn: getattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1]) for kn in kns}
    kept = []

    def keeping(kn):
        def call(*a):
            out = orig[kn](*a)
            kept.append((kn, a, out))
            return out
        return call

    for kn in kns:
        setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], keeping(kn))
    try:
        t0 = time.perf_counter()
        u4, m4, vs4, vr4 = kernel_shard.run_level_pair(
            ks, snd4, rcv4, _shard_flats(fs, ks, Sharded, torch),
            _shard_flats(fr, ks, Sharded, torch), gseed, bseed, field, garbler, path)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    finally:
        for kn in kns:
            setattr(_ops(WRAPPERS[kn][0]), WRAPPERS[kn][1], orig[kn])
    what = f"{name} K3 level={level} ({kind}, F={F}, B={B}, S={S}, k={SHARDS})"
    if not (np.array_equal(u1, u4) and np.array_equal(m1, m4)):
        raise AssertionError(f"{what}: the sharded wire differs from the whole level's")
    for a, b, who in ((vs1, vs4, "sender"), (vr1, vr4, "receiver")):
        if not torch.equal(a, torch.cat(list(b))[:B]):
            raise AssertionError(f"{what}: the {who}'s b2a values differ")
    log(f"k3 {what}: u ({u1.nbytes} B) and frame ({m1.nbytes} B) byte-equal to k = 1, b2a "
        f"values equal; whole level {whole_s:.3f} s, sharded {sharded_s:.3f} s (both roles)")
    del vs1, vr1, vs4, vr4
    if len(kept) != 2 * SHARDS:
        raise AssertionError(f"{what}: {len(kept)} kernel calls, want {2 * SHARDS}")
    checks = []
    for i, (kn, a, out) in enumerate(kept):
        c = secure_check(kn, a, out, orig[kn], f"{what} shard={i % SHARDS}")
        c.update(kernel=kn, level=level, kind=kind, shard=i % SHARDS, B=B)
        checks.append(c)
    del kept, m1, m4
    torch.cuda.empty_cache()
    return checks


def k3_checks(name, cfg, n, seed, with_last, torch):
    """Phases 28-29's K3 checks on the socket cell's own inputs: its keys
    made again from the seed (``bin.leader.client_keys``), crawled in this
    process on the trusted exchange (the same counts, so the same
    frontiers) in rounds of the cell's radix; at the widest inner round and,
    ``with_last``, the F255 last round, both servers' strings go through
    :func:`k3_check`, the garbler that round's."""
    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.ops.fields import F255, FE62
    from fuzzyheavyhitters_torch.protocol import collect, driver, secure

    dev = torch.device("cuda")
    trusted = dataclasses.replace(cfg, secure_exchange=False)
    k0, k1 = leader_bin.client_keys(trusted, n, dev, seed)[1:3]
    lead = driver.Leader(*driver.make_servers(*(ibdcf.keys_from_numpy(k, dev) for k in (k0, k1))),
                         n_dims=cfg.n_dims, data_len=cfg.data_len, f_max=cfg.f_max,
                         radix=cfg.crawl_radix_bits)
    del k0, k1
    lead.run(nreqs=n, threshold=cfg.threshold)
    L, k, d = cfg.data_len, cfg.crawl_radix_bits, cfg.n_dims
    bases = list(range(0, L, k))
    inner = lead.buckets[:-1]
    targets = {bases[inner.index(max(inner))]: "widest_fe62"}
    if with_last:
        targets[bases[-1]] = "last_f255"
    checks = []
    lead.tree_init()
    try:
        for i, level in enumerate(bases):
            if level in targets:
                r = min(k, L - level)
                flats = [secure.child_strings_radix(collect.expand_share_bits_radix(
                    s.keys, s.frontier, level, r, want_children=False)[0], d, r)
                    for s in (lead.server0, lead.server1)]
                last = level + r == L
                checks += k3_check(name, targets[level], level, flats, F255 if last else FE62,
                                   secure.ot_path(2 * d * r, cfg.ot_path), i % 2, seed, torch)
                del flats
                if len(checks) == 2 * SHARDS * len(targets):
                    break
            lead.run_level(level, n, cfg.threshold)
    finally:
        for s in (lead.server0, lead.server1):
            s.frontier = s.children = None
        del lead
        torch.cuda.empty_cache()
    return checks


def check_sharded(name, rep, base, n, secure):
    """Phases 27-29's checks beside :func:`check_socket_run`'s: the hitters
    and every server's data-plane bytes and largest frame equal the
    unsharded cell ``base``'s (the wire is byte-identical), and each
    server's ``mesh`` section shows SHARDS data shards of n / SHARDS
    clients; secure, every level ran the kernel stage on SHARDS shards, none
    gathered.  -> the figures."""
    if rep["hitter_map"] != base["hitter_map"]:
        raise AssertionError(f"{name}: hitters differ from the unsharded cell's")
    for sid, (ex, bx) in enumerate(zip(rep["servers"], base["servers"])):
        for key in ("data_bytes_sent", "data_bytes_recv", "data_frame_max"):
            if ex[key] != bx[key]:
                raise AssertionError(f"{name}: server {sid} {key} {ex[key]} != the unsharded "
                                     f"cell's {bx[key]}")
        m = ex["mesh"]
        if (m is None or m["data_shards"] != SHARDS
                or m["shard_clients"] != [n // SHARDS] * SHARDS):
            raise AssertionError(f"{name}: server {sid} mesh {m}")
        if secure and (m["kernel_shards_max"] != SHARDS or m["kernel_gathers"] != 0
                       or m["kernel_shards"] != SHARDS):
            raise AssertionError(f"{name}: server {sid} kernel stage {m}")
    log(f"sharded {name}: hitters, data-plane bytes and largest frames = the unsharded "
        f"cell's; crawl_s={rep['crawl_s']:.3f} (unsharded {base['crawl_s']:.3f}) mesh="
        f"{[ex['mesh'] for ex in rep['servers']]} max_memory_allocated="
        f"{rep['max_memory_allocated']} (unsharded {base['max_memory_allocated']})")
    rep["mesh"] = [ex["mesh"] for ex in rep["servers"]]
    return rep


def sharded_phases(seed, cells, hitters, points, secure_cfg, report, errs, tmp, stage, torch):
    """Phases 27-31: the socket deployment with SHARDS data shards a server
    (``FHH_DATA_DEVICES``), against the unsharded cells of the same config,
    seed and N, then the device-kill drill."""
    from fuzzyheavyhitters_torch.workloads import sample_points

    sock = report["sockets"]
    env = {**SOCKET_ENV, **SHARD_ENV}
    rides_cfg = cells["rides"][0]
    # phase 27: trusted rides
    name = "rides_socket_sharded"
    run = socket_run(name, rides_cfg, RIDES_CLIENTS, seed, tmp, env)
    rep = check_socket_run(name, run, rides_cfg, points["rides"], hitters["rides"],
                           report["crawls"]["rides"]["seconds"]["crawl"], (), shards=SHARDS)
    sock[name] = check_sharded(name, rep, sock["rides_socket"], RIDES_CLIENTS, False)
    stage(f"{name} socket run")
    # phases 28-29: secure rides (ot2s at S = 4; GC at S' = 8, radix 2)
    secure_cells = {
        "rides_secure_socket_sharded": (cells["rides_secure"][0], RIDES_SECURE_CLIENTS, OT2S,
                                        "rides_secure_socket", True),
        "rides_secure_socket_radix2_sharded": (
            dataclasses.replace(rides_cfg, secure_exchange=True, ot_path="auto",
                                crawl_radix_bits=RIDES_RADIX),
            RIDES_RADIX_SECURE_CLIENTS, GC, "rides_secure_socket_radix2", False)}
    for name, (cfg, n, per_level, base, with_last) in secure_cells.items():
        run = socket_run(name, cfg, n, seed, tmp, env)
        pts = sample_points(cfg, n, np.random.default_rng(seed))
        rep = check_socket_run(name, run, cfg, pts, sock[base]["hitter_map"],
                               sock[base]["mesh_crawl_s"], per_level, shards=SHARDS)
        sock[name] = check_sharded(name, rep, sock[base], n, True)
        stage(f"{name} socket run")
        sock[name]["k3_checks"] = k3_checks(name, cfg, n, seed, with_last, torch)
        for c in sock[name]["k3_checks"]:
            errs[c["kernel"]].append(c["max_abs_err"])
        stage(f"{name} K3 checks")
    # phase 30: the malicious sketch at its batch, trusted exchange
    name, base = "zipf_malicious_socket_sharded", sock["zipf_malicious_socket"]
    cfg30 = dataclasses.replace(secure_cfg, secure_exchange=False)
    fig, _ = malicious_batch_run(name, cfg30, SKETCH_CLIENTS, seed, tmp, env, SHARDS)
    if fig["hitter_map"] != base["hitter_map"]:
        raise AssertionError(f"{name}: hitters differ from zipf_malicious_socket's")
    for sid, (sv, bv) in enumerate(zip(fig["servers"], base["servers"])):
        m = sv["mesh"]
        if (sv["sketch_verifies"] != bv["sketch_verifies"] or m is None
                or m["sketch_shards"] != SHARDS or m["data_shards"] != SHARDS
                or any(sv[k] != bv[k] for k in ("data_bytes_sent", "data_bytes_recv",
                                                "data_frame_max"))):
            raise AssertionError(f"{name}: server {sid} {sv} against {bv}")
    log(f"sharded {name}: all {SKETCH_CLIENTS} alive, hitters, sketch verbs and data-plane "
        f"bytes = zipf_malicious_socket's; rounds_s={fig['crawl_s']:.3f} (unsharded "
        f"{base['crawl_s']:.3f}) mesh={[sv['mesh'] for sv in fig['servers']]}")
    sock[name] = fig
    stage(f"{name} socket run")
    # phase 31: phase 27 supervised, server 1 losing a device at MESH_KILL_LEVEL
    name = "rides_socket_sharded_device_kill"
    L = rides_cfg.data_len
    ck_levels = [lv for lv in range(L - 1) if (lv + 1) % CKPT_EVERY == 0]
    if MESH_KILL_LEVEL - 1 not in ck_levels:
        raise AssertionError(f"{name}: level {MESH_KILL_LEVEL} follows no checkpoint "
                             f"({ck_levels})")
    run = socket_run(name, rides_cfg, RIDES_CLIENTS, seed, tmp, {**SUPERVISED_ENV, **SHARD_ENV},
                     supervise=True, server_env={1: {"FHH_MESH_FAULTS": MESH_KILL}})
    rep = check_supervised_run(name, run, rides_cfg, sock["rides_socket_sharded"]["hitter_map"],
                               points["rides"], shards=SHARDS, rerun_slack=SHARDS)
    s0, s1 = rep["servers"]
    ev = run["events"]
    reshard = [e for e in ev["server1"] if e["event"] == "resilience.mesh_reshard"]
    classified = [e for e in ev["leader"] if e["event"] == "resilience.loss_classified"]
    m0, m1 = s0["mesh"], s1["mesh"]
    if (m1["faults"] != 1 or m1["reshards"] != 1 or len(reshard) != 1
            or reshard[0]["level"] != MESH_KILL_LEVEL or m0["faults"] != 0
            or rep["counters"]["levels_rerun"] or rep["counters"]["recoveries"] or classified):
        raise AssertionError(f"{name}: server 1 mesh {m1}, reshard events {reshard}, server 0 "
                             f"mesh {m0}, counters {rep['counters']}, {classified}")
    extra = s1["launches"]["expand"] - s1["levels"] * SHARDS
    rep["reshard"] = {"level": MESH_KILL_LEVEL, "restored_level": MESH_KILL_LEVEL - 1,
                      "server1_restore_s": s1["checkpoint_restore_s"],
                      "extra_expand_launches": extra}
    log(f"sharded {name}: server 1 lost a device at level {MESH_KILL_LEVEL}, re-sharded "
        f"from the level-{MESH_KILL_LEVEL - 1} blob inside the verb (restore "
        f"{s1['checkpoint_restore_s']:.3f} s), the leader saw no fault (levels_rerun 0, "
        f"recoveries 0, "
        f"no loss_classified); hitters = rides_socket_sharded's; server 1 expand launches "
        f"{s1['launches']['expand']} = {s1['levels']} verbs x {SHARDS} + {extra} "
        f"({'a pre-expanded dispatch dropped and run again' if extra else 'no pre-expanded dispatch: the fault fired before the level expanded'}); "
        f"crawl_s={rep['crawl_s']:.3f}")
    sock[name] = rep
    stage(f"{name} socket run")


def check_window_run(name, run, cfg, points, windows, base_crawl_s, per_window_verbs,
                     malicious=False):
    """Phase 32's and 34's checks of a ``FHH_WINDOWS`` socket run: every
    window's hitters (its own ``hitter`` lines) the plaintext recount over
    that window's points, none empty; every client admitted; each server
    sealed each window with the same stats (and, malicious, the same root,
    the windows' roots apart), ran ``per_window_verbs`` crawl verbs a
    window and launched expand once per verb, no secure kernel; malicious,
    every client alive after each window's crawl.  -> the figures: each
    window's submissions (seconds, keys/s; those of windows that began
    while the previous window's crawl ran are the during-crawl rate), crawl
    and seal-to-hitters seconds."""
    n = points.shape[0]
    per_w = -(-n // windows)
    ev = run["events"]["leader"]
    wins = {e["window"]: e for e in ev if e["event"] == "ingest.window"}
    done = {e["window"]: e for e in ev if e["event"] == "window.done"}
    if sorted(wins) != list(range(windows)) or sorted(done) != list(range(windows)):
        raise AssertionError(f"{name}: windows {sorted(wins)} sealed, {sorted(done)} crawled")
    hitters = {}
    for w in range(windows):
        got = {e["value"]: e["count"] for e in run["hitters"] if e["window"] == w}
        if not got or done[w]["hitters"] != len(got):
            raise AssertionError(f"{name}: window {w} hitters {got}, window.done {done[w]}")
        _recount(f"{name} window {w}", got, cfg, points[w * per_w:(w + 1) * per_w])
        hitters[w] = got
        want_keys = min(per_w, n - w * per_w)
        if wins[w]["keys"] != want_keys or (malicious and done[w]["alive"] != want_keys):
            raise AssertionError(f"{name}: window {w} {wins[w]} {done[w]}, want {want_keys} "
                                 "keys, all alive")
    sealed = [[(e["window"], e["keys"], e["subs"], e["shed"], e["sk_root"])
               for e in run["events"][f"server{sid}"] if e["event"] == "ingest.window_sealed"]
              for sid in (0, 1)]
    roots = [s[4] for s in sealed[0]]
    if (sealed[0] != sealed[1] or len(sealed[0]) != windows
            or (malicious and (None in roots or len({tuple(r) for r in roots}) != windows))):
        raise AssertionError(f"{name}: seals {sealed}")
    verbs = per_window_verbs * windows
    for sid, ex in enumerate(run["exits"]):
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = verbs
        if (ex["launches"] != want_l or ex["levels"] != verbs or ex["windows_sealed"] != windows
                or ex["pool_admitted_keys"] != n or ex["checkpoint_writes"] != windows
                or (malicious and ex["sketch_verifies"] != verbs)):
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{ex['levels']} crawl verbs (want {want_l} over {verbs}), "
                                 f"sealed {ex['windows_sealed']}, admitted "
                                 f"{ex['pool_admitted_keys']}, {ex['checkpoint_writes']} "
                                 f"checkpoints, "
                                 f"{ex['sketch_verifies']} sketch verbs")
    fig = {"n": n, "windows": windows, "hitters": {w: len(h) for w, h in hitters.items()},
           "pure_ingest_keys_per_s": wins[0]["keys_per_s"],
           "ingest_during_crawl_keys_per_s": [wins[w]["keys_per_s"] for w in range(1, windows)
                                              if wins[w]["during_crawl"]],
           "submit_s": [wins[w]["seconds"] for w in range(windows)],
           "crawl_s": [done[w]["crawl_s"] for w in range(windows)],
           "seal_to_hitters_s": [done[w]["seal_to_hitters_s"] for w in range(windows)],
           "base_crawl_s": base_crawl_s, "leader_s": run["crawl"]["seconds"],
           "sk_roots": roots if malicious else None,
           "launches": {f"server{sid}": ex["launches"] for sid, ex in enumerate(run["exits"])},
           "servers": [{k: ex[k] for k in ("pool_submits", "pool_admitted_keys",
                                           "checkpoint_writes", "checkpoint_bytes",
                                           "checkpoint_write_s", "seal_to_hitters_s",
                                           "max_memory_allocated", "data_bytes_sent")}
                       | {"sketch_s": ex["seconds"]["sketch"]} for ex in run["exits"]]}
    log(f"windows {name}: N={n} in {windows} windows, each window's hitters "
        f"{fig['hitters']} = its plaintext recount; pure ingest "
        f"{fig['pure_ingest_keys_per_s']:.1f} keys/s (window 0), during a crawl "
        f"{[round(x, 1) for x in fig['ingest_during_crawl_keys_per_s']]} keys/s; crawl_s "
        f"{[round(x, 3) for x in fig['crawl_s']]} (the batch cell: {base_crawl_s:.3f}); "
        f"seal_to_hitters_s {[round(x, 3) for x in fig['seal_to_hitters_s']]}; seals equal on "
        f"both servers{'; roots ' + str(roots) if malicious else ''}; launches "
        f"{fig['launches']}; leader {fig['leader_s']:.3f} s; servers {fig['servers']}")
    return fig


def _slot_table(path, w):
    """Window ``w``'s pool in an ingest checkpoint blob: each slot's root
    seeds as bytes (leaf 1 of the entry tuple)."""
    with np.load(path) as z:
        i = list(z["ing_windows"]).index(w)
        lens = z[f"ing{i}_lens"]
        seeds = z[f"ing{i}_leaf1"]
    bounds = np.concatenate([[0], np.cumsum(lens)])
    return [seeds[bounds[e]:bounds[e + 1]].tobytes() for e in range(len(lens))]


def window_drill(name, cfg, n, seed, tmp, torch):
    """Phase 33: rides' config with reservoir shedding (``ingest_window_keys``
    half a window's submissions), two windows, the leader
    ``WindowedIngest`` in this process through a ``ChaosProxy`` that floods
    a ``submit_keys`` frame to server 0; server 1 SIGKILLed once window 0's
    crawl is under way while window 1 ingests (after window 0's ingest
    checkpoint) and started again on its ports and directory.  Each window's
    slot table (read from server 0's ingest checkpoint at its seal) must be
    what the port's own ``AdmissionController`` predicts from the seed and
    the offer order, its seal ``keys`` the cap, its hitters those of a batch
    crawl (``upload_keys`` + ``run``, at the end, same servers) over exactly
    the admitted keys and their plaintext recount; the restarted server
    answers at least one replayed submission from its recorded verdicts,
    the leader counts at least one ingest recovery, and each process
    launches expand once per crawl verb it began (the re-run crawl
    included), no secure kernel.  -> the figures."""
    import asyncio

    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.bin.server import split_addr
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol.leader_rpc import RpcLeader, WindowedIngest
    from fuzzyheavyhitters_torch.protocol.rpc import CollectorClient
    from fuzzyheavyhitters_torch.resilience.admission import AdmissionController

    ck = leader_bin.client_keys(cfg, n, torch.device("cuda"), seed)
    per_w, bs = n // DRILL_WINDOWS, cfg.addkey_batch_size
    chunks = [[(f"site{i % cfg.num_sites}", slice(lo, lo + bs))
               for i, lo in enumerate(range(w * per_w, (w + 1) * per_w, bs))]
              for w in range(DRILL_WINDOWS)]
    ctl = AdmissionController(max_window_keys=cfg.ingest_window_keys,
                              client_quota=cfg.ingest_client_quota, shed=cfg.ingest_shed,
                              seed=cfg.ingest_seed)
    predicted = []
    for w in range(DRILL_WINDOWS):
        wa, table = ctl.window(w), []
        for client, sl in chunks[w]:
            v = ctl.admit(wa, client, sl.stop - sl.start)
            if v.scope is not None:
                raise AssertionError(f"{name}: the predicted gate refused {client}: {v}")
            if v.admitted and v.slot is None:
                table.append(sl)
            elif v.admitted:
                table[v.slot] = sl
        predicted.append(table)
    blob0 = os.path.join(tmp, name, "ckpt0", "fhh_server0_l-1.npz")
    state = {"kill": False}

    async def lead_drill(lcfg):
        c0 = await CollectorClient.connect(*split_addr(lcfg.server0))
        c1 = await CollectorClient.connect(*split_addr(lcfg.server1))
        try:
            lead = RpcLeader(lcfg, c0, c1, emit=leader_bin.emit)
            await lead._both("reset")
            wi = WindowedIngest(lead)
            box, fig = {}, {"tables": [], "seals": [], "submit_s": []}

            async def trigger():  # window 0's crawl under way, window 1 ingesting
                while "crawl0" not in box or len(lead.buckets) < 2:
                    await asyncio.sleep(0.001)
                state["kill"] = True
                fig["kill_at_round"] = len(lead.buckets)

            trig = None
            for w in range(DRILL_WINDOWS):
                if w == 1:
                    trig = asyncio.ensure_future(trigger())
                t0 = time.perf_counter()
                for client, sl in chunks[w]:
                    await wi.submit(client, tuple(a[sl] for a in ck.keys0),
                                    tuple(a[sl] for a in ck.keys1))
                fig["submit_s"].append(time.perf_counter() - t0)
                fig["seals"].append(await wi.seal_window())
                fig["tables"].append(_slot_table(blob0, w))
                if w == 0:
                    box["crawl0"] = asyncio.ensure_future(wi.crawl_window(0))
            res = {0: await box["crawl0"], 1: await wi.crawl_window(1)}
            await trig
            fig["counters"], fig["windows"] = dict(wi.counters), dict(wi.windows)
            fig["results"] = {w: _hitter_map(r) for w, r in res.items()}
            # the servers' figures of the drill, before the batch crawls'
            # resets clear the collection's telemetry (as a JAX server's do)
            fig["status"] = [await c.call("status") for c in (c0, c1)]
            fig["batch"] = {}
            for w in range(DRILL_WINDOWS):  # the batch crawl over the admitted keys
                await lead._both("reset")
                k0, k1 = (ibdcf.IbDcfKeyBatch(*(np.concatenate([a[sl] for sl in predicted[w]])
                                                for a in k)) for k in (ck.keys0, ck.keys1))
                await lead.upload_keys(k0, k1)
                fig["batch"][w] = _hitter_map(await lead.run(k0.cw_seed.shape[0]))
            fig["epochs"] = [c0.epoch, c1.epoch]
            return fig
        finally:
            await c0.aclose()
            await c1.aclose()

    run = socket_run(name, cfg, n, seed, tmp, SOCKET_ENV, ckpt=True,
                     kill=lambda ev: state["kill"], ctl0_faults=DRILL_FLOOD,
                     leader_coro=lead_drill)
    fig = run["leader_result"]
    cap = cfg.ingest_window_keys
    for w in range(DRILL_WINDOWS):
        want = [ck.keys0.root_seed[sl].tobytes() for sl in predicted[w]]
        if fig["tables"][w] != want or len(set(want)) != len(want):
            raise AssertionError(f"{name}: window {w}'s slot table is not the predicted one")
        if fig["seals"][w]["keys"] != cap or fig["seals"][w]["shed_keys"] != per_w - cap:
            raise AssertionError(f"{name}: window {w} sealed {fig['seals'][w]}, want {cap} keys")
        got, batch = fig["results"][w], fig["batch"][w]
        if not got or got != batch:
            raise AssertionError(f"{name}: window {w} hitters {got} != the batch crawl's {batch}")
        idx = np.concatenate([np.arange(sl.start, sl.stop) for sl in predicted[w]])
        _recount(f"{name} window {w}", got, cfg, ck.points[idx])
    # the drill's figures from the servers' status before the batch crawls
    rows = [st["sessions"]["per_session"]["default"]["counters"] for st in fig["status"]]
    dedup = [st["dedup_hits"] for st in fig["status"]]
    if (run["proxy_fired"] != [("flood", "c2s", int(DRILL_FLOOD.split("msg=")[1].split(",")[0]))]
            or dedup[0] < 1 or rows[1]["pool_dup_submits"] < 1
            or rows[1]["checkpoint_restores"] != 1
            or fig["counters"]["ingest_recoveries"] < 1 or run["killed"].get("rc") != -9):
        raise AssertionError(f"{name}: fired {run['proxy_fired']}, server 0 dedup_hits "
                             f"{dedup[0]}, new server 1 pool_dup_submits "
                             f"{rows[1]['pool_dup_submits']} restores "
                             f"{rows[1]['checkpoint_restores']}, "
                             f"counters {fig['counters']}, killed {run['killed']}")
    # crawl verbs: the drill's, then a whole crawl a batch (its hitters are the
    # window's, so no batch dies out before the leaves)
    levels = [r["levels"] + DRILL_WINDOWS * cfg.data_len for r in rows]
    for sid, ex in enumerate(run["exits"]):
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = levels[sid]
        if ex["launches"] != want_l or levels[sid] < 4 * cfg.data_len + (sid == 0):
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{levels[sid]} crawl verbs begun")
    restored = [e for e in run["events"]["server1"] if e["event"] == "resilience.server_restore"]
    out = {"n": n, "windows": DRILL_WINDOWS, "cap_keys": cap,
           "hitters": {w: len(h) for w, h in fig["results"].items()},
           "submit_s": fig["submit_s"], "counters": fig["counters"],
           "window_crawl": fig["windows"], "kill_at_round": fig["kill_at_round"],
           "kill_to_spawn_s": run["killed"]["t_spawn"] - run["killed"]["t_kill"],
           "server1_restore": restored, "epochs": fig["epochs"],
           "pool_dup_submits": [r["pool_dup_submits"] for r in rows], "dedup_hits": dedup,
           "launches": {f"server{sid}": ex["launches"] for sid, ex in enumerate(run["exits"])},
           "levels": levels, "leader_wall_s": run["wall_s"]}
    log(f"windows {name}: N={n} in {DRILL_WINDOWS} windows, reservoir cap {cap} keys; slot "
        f"tables = the port's AdmissionController's prediction, seal keys = the cap, hitters "
        f"{out['hitters']} = the batch crawls over the admitted keys and the recount; flood "
        f"fired {run['proxy_fired']}, server 1 killed at round {out['kill_at_round']} of window "
        f"0's crawl and restored {[(e['level'], e.get('ingest_only')) for e in restored]}; "
        f"counters {out['counters']}; window crawls {out['window_crawl']}; "
        f"pool_dup_submits {out['pool_dup_submits']}, dedup_hits {out['dedup_hits']}; "
        f"crawl verbs {out['levels']}, launches {out['launches']}; epochs {out['epochs']}; "
        f"submit_s {[round(x, 3) for x in out['submit_s']]}")
    del ck
    return out


def window_phases(seed, cells, points, secure_cfg, report, tmp, stage, torch):
    """Phases 32-34: streaming ingestion on the socket deployment."""
    from fuzzyheavyhitters_torch.workloads import sample_points

    sock = report["sockets"]
    rides_cfg = cells["rides"][0]
    # phase 32: rides_socket's clients streamed through the front door
    name = "rides_socket_windows"
    run = socket_run(name, rides_cfg, RIDES_CLIENTS, seed, tmp,
                     {**SOCKET_ENV, "FHH_WINDOWS": str(WINDOWS)}, ckpt=True)
    sock[name] = check_window_run(name, run, rides_cfg, points["rides"], WINDOWS,
                                  sock["rides_socket"]["crawl_s"], rides_cfg.data_len)
    stage(f"{name} socket run")
    # phase 33: reservoir shedding, a flooded frame and a killed server 1
    name = "rides_socket_windows_drill"
    cfg33 = dataclasses.replace(rides_cfg, ingest_shed="reservoir", ingest_seed=DRILL_SEED,
                                ingest_window_keys=DRILL_CLIENTS // DRILL_WINDOWS // 2)
    sock[name] = window_drill(name, cfg33, DRILL_CLIENTS, seed, tmp, torch)
    stage(f"{name} socket run")
    # phase 34: phase 21's malicious sketch, the sketch leaves riding each submission
    name = "zipf_malicious_socket_windows"
    cfg34 = dataclasses.replace(secure_cfg, secure_exchange=False)
    run = socket_run(name, cfg34, SKETCH_WINDOW_CLIENTS, seed, tmp,
                     {**SOCKET_ENV, "FHH_WINDOWS": str(SKETCH_WINDOWS)}, ckpt=True)
    pts = sample_points(cfg34, SKETCH_WINDOW_CLIENTS, np.random.default_rng(seed))
    base = sock["zipf_malicious_socket"]
    fig = check_window_run(name, run, cfg34, pts, SKETCH_WINDOWS, base["crawl_s"],
                           cfg34.data_len, malicious=True)
    fig["sketch_s_per_window"] = [sv["sketch_s"] / SKETCH_WINDOWS for sv in fig["servers"]]
    fig["batch_sketch_s"] = [sv["sketch_s"] for sv in base["servers"]]
    log(f"windows {name}: every client alive in each window; sketch verb seconds a window "
        f"{[round(x, 3) for x in fig['sketch_s_per_window']]} against phase 21's "
        f"{[round(x, 3) for x in fig['batch_sketch_s']]} for the whole batch (a window "
        f"holds {SKETCH_WINDOW_CLIENTS // SKETCH_WINDOWS} of its {SKETCH_CLIENTS} clients)")
    sock[name] = fig
    stage(f"{name} socket run")


def _take(keys, sl):
    from fuzzyheavyhitters_torch.ops import ibdcf

    return ibdcf.IbDcfKeyBatch(*(a[sl] for a in keys))


def _session_rows(ex):
    """A ``server.exit`` line's collections: {collection: its row}."""
    return ex["sessions"]["per_session"]


def _check_session_sums(name, ex):
    """Every collection's counters sum to the server's totals."""
    rows = _session_rows(ex)
    for k in ("levels", "levels_done", "add_keys", "checkpoint_writes", "data_bytes_sent",
              "data_bytes_recv", "warmup_shapes", "pool_submits"):
        got = sum(r["counters"][k] for r in rows.values())
        if got != ex[k]:
            raise AssertionError(f"{name}: server {ex['server']}'s collections count {got} "
                                 f"{k}, its total {ex[k]}")


def tenants_run(name, cfg, n, seed, tmp, tenants, warm, torch):
    """Phases 35-36: ``tenants`` collections ``t0``, ``t1``, ... of ``n``
    clients each (keys from ``bin.leader.client_keys`` at seeds ``seed + t``)
    on one pair of ``bin.server`` processes with a ``FHH_CKPT_DIR`` each, the
    leader in this process: first ``t0``'s keys crawled alone in the default
    collection (``RpcLeader.run_supervised``: the solo run), then, with
    ``warm``, ``t0`` uploaded in its collection and warmed over the solo
    run's buckets, then every collection at once through
    ``MultiCollectionDriver.run_collections`` (supervised, warmed with
    ``warm``, checkpoints every ``TENANT_CKPT_EVERY`` levels).  Each
    collection's hitters must equal the plaintext recount and ``t0``'s the
    solo run's bit for bit; ``status`` must count the collections and the
    default one, each keyed on both servers (``plane_epoch`` >= 1), and
    device turns; each server's collections must sum to its totals and each
    collection checkpoint in its own namespace; with ``warm`` the first
    warmup must warm every shape and every collection's warmup in the run
    (``t0``'s second) warm none and hit the ladder once for each of them; each server launches expand once per crawl verb
    and twice per warmed shape, and in secure mode each ot2s kernel once
    per verb of a round it garbled (encrypt) or evaluated (decrypt).
    -> the figures."""
    import asyncio

    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.bin.server import split_addr
    from fuzzyheavyhitters_torch.protocol.leader_rpc import MultiCollectionDriver, RpcLeader
    from fuzzyheavyhitters_torch.protocol.rpc import CollectorClient

    keys = [f"t{t}" for t in range(tenants)]
    dev = torch.device("cpu" if cfg.backend == "cpu" else "cuda")
    cks = {k: leader_bin.client_keys(cfg, n, dev, seed + t) for t, k in enumerate(keys)}

    async def lead(lcfg):
        (h0, p0), (h1, p1) = split_addr(lcfg.server0), split_addr(lcfg.server1)
        fig = {}
        c0 = await CollectorClient.connect(h0, p0)
        c1 = await CollectorClient.connect(h1, p1)
        try:
            solo = RpcLeader(lcfg, c0, c1, emit=leader_bin.emit)
            t0 = time.perf_counter()
            fig["solo"] = await solo.run_supervised(n, cks["t0"].keys0, cks["t0"].keys1,
                                                    checkpoint_every=TENANT_CKPT_EVERY)
            fig["solo_s"] = time.perf_counter() - t0
            fig["solo_seconds"], fig["buckets"] = dict(solo.seconds), sorted(set(solo.buckets))
        finally:
            await c0.aclose()
            await c1.aclose()
        drv = MultiCollectionDriver(lcfg, h0, p0, h1, p1, emit=leader_bin.emit)
        try:
            if warm:  # t0 warms first: the others' warmups find its shapes
                first = await drv.open("t0")
                await first.upload_keys(cks["t0"].keys0, cks["t0"].keys1)
                fig["first_warmup"] = await first.warmup(fig["buckets"])
            jobs = [{"collection": k, "nreqs": n, "keys0": cks[k].keys0, "keys1": cks[k].keys1}
                    for k in keys]
            t0 = time.perf_counter()
            fig["results"] = await drv.run_collections(
                jobs, warmup=warm, warm_buckets=fig["buckets"],
                checkpoint_every=TENANT_CKPT_EVERY)
            fig["multi_s"] = time.perf_counter() - t0
            fig["seconds"] = {k: dict(ld.seconds) for k, ld in drv.leaders.items()}
            fig["status"] = [await drv.leaders["t0"].c0.call("status"),
                             await drv.leaders["t0"].c1.call("status")]
        finally:
            await drv.close()
        return fig

    run = socket_run(name, cfg, n, seed, tmp, SOCKET_ENV, ckpt=True, leader_coro=lead)
    fig = run["leader_result"]
    hitters = {}
    for k in keys:
        res = fig["results"][k]
        if isinstance(res, BaseException):
            raise AssertionError(f"{name}: collection {k} failed: {type(res).__name__}: {res}")
        hitters[k] = _hitter_map(res)
        if not hitters[k]:
            raise AssertionError(f"{name}: collection {k} has no hitter")
        _recount(f"{name} {k}", hitters[k], cfg, cks[k].points)
    solo = fig["solo"]
    if not (np.array_equal(fig["results"]["t0"].paths, solo.paths)
            and np.array_equal(fig["results"]["t0"].counts, solo.counts)):
        raise AssertionError(f"{name}: t0's hitters differ from its solo run's")
    crawls = tenants + 1  # the solo run and the collections
    r_per = -(-cfg.data_len // cfg.crawl_radix_bits)
    warmed = len(fig["buckets"]) if warm else 0
    for sid, (st, ex) in enumerate(zip(fig["status"], run["exits"])):
        sess = st["sessions"]
        if (sess["count"] != tenants + 1 or sess["scheduler"]["device_turns"] <= 0
                or sorted(sess["per_session"]) != sorted(keys + ["default"])
                or any(sess["per_session"][k]["plane_epoch"] < 1 for k in keys + ["default"])):
            raise AssertionError(f"{name}: server {sid} status sessions {sess}")
        _check_session_sums(name, ex)
        rows = _session_rows(ex)
        if warm:
            first = fig["first_warmup"][f"s{sid}"]
            got = {k: (rows[k]["counters"]["warmup_shapes"],
                       rows[k]["counters"]["warmup_ladder_hits"]) for k in keys}
            # every collection's supervised run resets it first, and a reset
            # clears the collection's telemetry (as a JAX server's does): t0's
            # row holds its second warmup, all ladder hits, like the others'
            want = {k: (0, first["shapes"]) for k in keys}
            if first != {"shapes": warmed, "ladder_hits": 0} or got != want:
                raise AssertionError(f"{name}: server {sid} warmups {first}, then "
                                     f"(shapes, ladder hits) {got}, want {want}")
        want_l = {kn: 0 for kn in KERNELS}
        want_l["expand"] = crawls * r_per + 2 * warmed
        if cfg.secure_exchange:
            for kn in OT2S:  # the garbler of round i is i % 2
                want_l[kn] = crawls * len([i for i in range(r_per) if (i % 2 == sid)
                                           == (kn == "ot2s_encrypt")])
        if ex["launches"] != want_l or ex["levels"] != crawls * r_per:
            raise AssertionError(f"{name}: server {sid} launched {ex['launches']} over "
                                 f"{ex['levels']} crawl verbs, want {want_l}")
        names = os.listdir(os.path.join(run["work"], f"ckpt{sid}"))
        for k in keys + ["default"]:
            pre = f"fhh_server{sid}_l" if k == "default" else f"fhh_server{sid}_c{k}_l"
            if not any(nm.startswith(pre) for nm in names):
                raise AssertionError(f"{name}: server {sid} has no checkpoint of {k}: {names}")
    exits = run["exits"]
    out = {"n": n, "tenants": tenants, "hitters": {k: len(h) for k, h in hitters.items()},
           "solo_s": fig["solo_s"], "solo_rounds_s": fig["solo_seconds"]["levels"],
           "solo_clients_per_s": n / fig["solo_s"], "multi_s": fig["multi_s"],
           "aggregate_clients_per_s": tenants * n / fig["multi_s"],
           "tenant_seconds": fig["seconds"], "buckets": fig["buckets"],
           "first_warmup": fig.get("first_warmup"),
           "scheduler": [ex["sessions"]["scheduler"] for ex in exits],
           "launches": {f"server{sid}": ex["launches"] for sid, ex in enumerate(exits)},
           "max_memory_allocated": [ex["max_memory_allocated"] for ex in exits],
           "plane_handshake_s": [{k: r["counters"]["plane_handshake_s"]
                                  / max(1, r["counters"]["plane_handshake_calls"])
                                  for k, r in _session_rows(ex).items()} for ex in exits],
           "data_bytes_sent": [ex["data_bytes_sent"] for ex in exits]}
    log(f"tenants {name}: {tenants} collections of {n} clients at once, each collection's "
        f"hitters {out['hitters']} = its plaintext recount, t0's = its solo run's; aggregate "
        f"{out['aggregate_clients_per_s']:.1f} clients/s ({fig['multi_s']:.3f} s) against the "
        f"solo run's {out['solo_clients_per_s']:.1f} ({fig['solo_s']:.3f} s); rounds s "
        f"{ {k: round(v['levels'], 3) for k, v in fig['seconds'].items()} } (solo "
        f"{out['solo_rounds_s']:.3f}); scheduler {out['scheduler']}; first warmup "
        f"{out['first_warmup']}; launches {out['launches']}; peak memory "
        f"{out['max_memory_allocated']}; handshake s a session {out['plane_handshake_s']}")
    return out


def tenant_isolation_drill(name, cfg, seed, tmp, torch):
    """Phase 37 (JAX ``tests/test_sessions.py:454`` at the card's size): both
    servers in reject mode with the ``TENANT_GATE`` bucket; collection
    ``ta`` floods its gate with ``FLOOD_KEYS`` keys in submissions of
    ``addkey_batch_size`` (one attempt each: a refusal is final) while
    collection ``tb`` streams ``ISOLATION_CLIENTS`` clients into one window
    through ``WindowedIngest``, seals it (the ingest-only checkpoint) and
    crawls it; server 1 is SIGKILLed once round 2 of ``tb``'s crawl is under
    way and started again on its ports and directory.  ``tb``'s window
    hitters must equal the plaintext recount over its admitted keys (all of
    them), ``tb``'s gate on both servers must show no refusal and no shed
    while ``ta``'s refused, each collection's checkpoints lie in its own
    namespace (none for ``ta``, which banks none, and none for the default
    collection), and the leader counts at least one ingest recovery.
    -> the figures: the kill-to-hitters seconds, the journal replays."""
    import asyncio

    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.bin.server import split_addr
    from fuzzyheavyhitters_torch.protocol.leader_rpc import (IngestOverloadedError,
                                                             MultiCollectionDriver, RpcLeader,
                                                             WindowedIngest)
    from fuzzyheavyhitters_torch.resilience.policy import RetryPolicy

    dev = torch.device("cpu" if cfg.backend == "cpu" else "cuda")
    cka = leader_bin.client_keys(cfg, FLOOD_KEYS, dev, seed + 10)
    ckb = leader_bin.client_keys(cfg, ISOLATION_CLIENTS, dev, seed + 11)
    bs = cfg.addkey_batch_size
    state = {"kill": False}

    async def lead(lcfg):
        (h0, p0), (h1, p1) = split_addr(lcfg.server0), split_addr(lcfg.server1)
        drv = MultiCollectionDriver(lcfg, h0, p0, h1, p1, emit=leader_bin.emit)
        fig = {"flood_subs": 0, "flood_refused": 0}
        try:
            la, lb = await drv.open("ta"), await drv.open("tb")
            wa = WindowedIngest(la, checkpoint=False, policy=RetryPolicy(attempts=1))
            wb = WindowedIngest(lb)

            async def flood():
                for lo in range(0, FLOOD_KEYS, bs):
                    sl = slice(lo, lo + bs)
                    try:
                        await wa.submit("flooder", _take(cka.keys0, sl), _take(cka.keys1, sl))
                    except (IngestOverloadedError, ConnectionError, TimeoutError, RuntimeError):
                        fig["flood_refused"] += 1
                    fig["flood_subs"] += 1

            async def trigger():  # round 2 of tb's crawl under way
                while len(lb.buckets) < 3 or "crawl" not in fig:
                    await asyncio.sleep(0.001)
                state["kill"] = True
                fig["kill_at_round"] = len(lb.buckets) - 1

            fl = asyncio.ensure_future(flood())
            t0 = time.perf_counter()
            for i, lo in enumerate(range(0, ISOLATION_CLIENTS, bs)):
                sl = slice(lo, lo + bs)
                await wb.submit(f"site{i % cfg.num_sites}", _take(ckb.keys0, sl),
                                _take(ckb.keys1, sl))
            fig["tb_submit_s"] = time.perf_counter() - t0
            fig["seal"] = await wb.seal_window()
            trig = asyncio.ensure_future(trigger())
            fig["crawl"] = True
            res = await wb.crawl_window(0, max_recoveries=8)
            fig["t_hitters"] = time.time()
            await trig
            await fl
            fig["result"] = res
            fig["counters"], fig["window"] = dict(wb.counters), dict(wb.windows[0])
            fig["flood_counters"] = dict(wa.counters)
            # a probe absorbs the restart a client of ta may not have met yet
            fig["status"] = {k: [await RpcLeader._probe(ld.c0), await RpcLeader._probe(ld.c1)]
                             for k, ld in (("ta", la), ("tb", lb))}
            return fig
        finally:
            await drv.close()

    run = socket_run(name, cfg, ISOLATION_CLIENTS, seed, tmp, SOCKET_ENV, ckpt=True,
                     kill=lambda ev: state["kill"], leader_coro=lead)
    fig = run["leader_result"]
    got = _hitter_map(fig["result"])
    if not got:
        raise AssertionError(f"{name}: tb's window has no hitter")
    _recount(f"{name} tb", got, cfg, ckb.points)
    ing = {k: [st["ingest"] for st in fig["status"][k]] for k in ("ta", "tb")}
    if (any(i["rejected"] or i["shed"] or i["admitted"] != ISOLATION_CLIENTS for i in ing["tb"])
            or ing["ta"][0]["rejected"] <= 0 or fig["seal"]["keys"] != ISOLATION_CLIENTS
            or fig["counters"]["ingest_recoveries"] < 1 or run["killed"].get("rc") != -9):
        raise AssertionError(f"{name}: ingest {ing}, seal {fig['seal']}, counters "
                             f"{fig['counters']}, killed {run['killed']}")
    for sid in (0, 1):
        names = os.listdir(os.path.join(run["work"], f"ckpt{sid}"))
        if not names or not all(nm.startswith(f"fhh_server{sid}_ctb_l") for nm in names):
            raise AssertionError(f"{name}: server {sid}'s checkpoints {names}")
    exits = run["exits"]
    out = {"tb_clients": ISOLATION_CLIENTS, "flood_keys": FLOOD_KEYS,
           "hitters": len(got), "kill_at_round": fig["kill_at_round"],
           "kill_to_hitters_s": fig["t_hitters"] - run["killed"]["t_kill"],
           "kill_to_spawn_s": run["killed"]["t_spawn"] - run["killed"]["t_kill"],
           "tb_submit_s": fig["tb_submit_s"], "window": fig["window"],
           "counters": fig["counters"], "flood_subs": fig["flood_subs"],
           "flood_refused": fig["flood_refused"], "flood_counters": fig["flood_counters"],
           "ingest": ing, "launches": {f"server{sid}": ex["launches"]
                                       for sid, ex in enumerate(exits)},
           "max_memory_allocated": [ex["max_memory_allocated"] for ex in exits],
           "scheduler": [ex["sessions"]["scheduler"] for ex in exits]}
    log(f"tenants {name}: ta flooded {FLOOD_KEYS} keys in {fig['flood_subs']} submissions "
        f"({fig['flood_refused']} refused; ta's gate {ing['ta']}), tb's "
        f"{ISOLATION_CLIENTS} clients all admitted (tb's gate {ing['tb']}), server 1 killed at "
        f"round {out['kill_at_round']} of tb's crawl: kill to hitters "
        f"{out['kill_to_hitters_s']:.3f} s (spawn {out['kill_to_spawn_s']:.3f} s), counters "
        f"{out['counters']}, tb's hitters ({len(got)}) = the recount; checkpoints only in tb's "
        f"namespace; launches {out['launches']}; peak memory {out['max_memory_allocated']}")
    return out


def tenant_phases(seed, cells, report, tmp, stage, torch):
    """Phases 35-37: many collections on one server pair."""
    sock = report["sockets"]
    rides_cfg = cells["rides"][0]
    name = "rides_socket_tenants"
    sock[name] = tenants_run(name, rides_cfg, TENANT_CLIENTS, seed, tmp, TENANTS, True, torch)
    stage(f"{name} socket run")
    name = "rides_secure_socket_tenants"
    sock[name] = tenants_run(name, cells["rides_secure"][0], SECURE_TENANT_CLIENTS, seed, tmp,
                             SECURE_TENANTS, False, torch)
    stage(f"{name} socket run")
    name = "rides_socket_tenant_isolation"
    sock[name] = tenant_isolation_drill(name, dataclasses.replace(rides_cfg, **TENANT_GATE),
                                        seed, tmp, torch)
    stage(f"{name} socket run")


def fleet_run(name, cfg, tmp, pairs, leader_coro):
    """Phases 38-40: for each pair named in ``pairs`` two ``bin.server``
    processes on free ports, every server with ``FHH_FLEET`` (one fleet
    directory), ``FHH_FLEET_PAIR`` its pair's name and one ``FHH_CKPT_DIR``
    shared by all (a fleet's shared store), all started together (on the CPU
    one after another); once all serve, the leader ``leader_coro(fleet_dir,
    ckpt_dir, kill)`` in this process, its events written to its log;
    ``kill(pair)`` SIGKILLs both of that pair's processes and returns the
    instant.  Then SIGTERM to the live servers: each must exit 143 (the
    SIGTERM contract of ``obs.exit_report``) without a traceback, a killed
    one -9.  Returns the leader's result, each server's
    events and ``server.exit`` line by ``<pair><id>``, the kill instants and
    the directories."""
    import asyncio
    import contextlib
    import signal

    work = os.path.join(tmp, name)
    fleet_dir, ckpt_dir = os.path.join(work, "fleet"), os.path.join(work, "ckpt")
    os.makedirs(ckpt_dir)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, **LOG_ENV, "FHH_FLEET": fleet_dir, "FHH_CKPT_DIR": ckpt_dir,
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    device = "cpu" if cfg.backend == "cpu" else "cuda"
    procs, logs, killed = {}, {}, {}

    def spawn(pair, sid, cfg_path):
        who = f"{pair}{sid}"
        logs[who] = os.path.join(work, f"server_{who}.log")
        procs[who] = POOL.start("fuzzyheavyhitters_torch.bin.server",
                                ["--config", cfg_path, "--device", device, "--server_id",
                                 str(sid)], work, {**env, "FHH_FLEET_PAIR": pair}, logs[who])

    def kill(pair):
        t = time.time()
        for sid in (0, 1):
            procs[f"{pair}{sid}"].kill()
        for sid in (0, 1):
            procs[f"{pair}{sid}"].wait()
        killed[pair] = t
        return t

    rcs, result = {}, None
    try:
        for pair in pairs:
            p0, p1 = free_ports()
            cfg_path = os.path.join(work, f"config_{pair}.json")
            with open(cfg_path, "w") as f:
                json.dump(dict(dataclasses.asdict(cfg), server0=f"127.0.0.1:{p0}",
                               server1=f"127.0.0.1:{p1}"), f)
            spawn(pair, 1, cfg_path)
            if device == "cpu":  # start-ups contend for the cores
                _wait_event(logs[f"{pair}1"], "server.plane_listening", procs[f"{pair}1"],
                            SOCKET_START_S)
            spawn(pair, 0, cfg_path)
            if device == "cpu":
                _wait_event(logs[f"{pair}0"], "server.serving", procs[f"{pair}0"],
                            SOCKET_START_S)
        for who in procs:
            _wait_event(logs[who], "server.serving", procs[who], SOCKET_START_S)
        with open(os.path.join(work, "leader.log"), "w") as out, \
                contextlib.redirect_stdout(out), json_logs():
            result = asyncio.run(asyncio.wait_for(leader_coro(fleet_dir, ckpt_dir, kill),
                                                  SOCKET_LEADER_S))
        for who, p in procs.items():
            if who[:-1] not in killed:
                p.send_signal(signal.SIGTERM)
        for who, p in procs.items():
            rcs[who] = p.wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for who, path in logs.items():
        with open(path) as f:
            text = f.read()
        want = -signal.SIGKILL if who[:-1] in killed else SIGTERM_RC
        if rcs.get(who) != want or "Traceback" in text:
            raise AssertionError(f"{name}: server {who} exited {rcs.get(who)} (want {want}):\n"
                                 f"{text[-3000:]}")
    events = {who: _events(path) for who, path in logs.items()}
    exits = {who: next((e for e in ev if e["event"] == "server.exit"), None)
             for who, ev in events.items()}
    return {"work": work, "fleet_dir": fleet_dir, "ckpt_dir": ckpt_dir, "events": events,
            "exits": exits, "killed": killed, "leader_result": result}


def _fleet_chunks(cfg, n, windows):
    """Each window's submissions: (client id, slice) of ``addkey_batch_size``
    keys, the window's last one shorter, as ``bin.leader`` cuts them."""
    per_w, bs = n // windows, cfg.addkey_batch_size
    return [[(f"site{i % cfg.num_sites}", slice(lo, min(lo + bs, (w + 1) * per_w)))
             for i, lo in enumerate(range(w * per_w, (w + 1) * per_w, bs))]
            for w in range(windows)]


def _banked_window_keys(ckpt_dir, w):
    """Window ``w``'s admitted keys as the pair banked them: each server's
    level -1 ingest blob in the shared store, the pool's entries in slot
    order.  -> (server 0's, server 1's) ``IbDcfKeyBatch`` of host arrays."""
    from fuzzyheavyhitters_torch.ops import ibdcf

    nk = len(ibdcf.IbDcfKeyBatch._fields)
    out = []
    for sid in (0, 1):
        with np.load(os.path.join(ckpt_dir, f"fhh_server{sid}_l-1.npz")) as z:
            i = list(z["ing_windows"]).index(w)
            out.append(ibdcf.IbDcfKeyBatch(*(z[f"ing{i}_leaf{j}"] for j in range(nk))))
    return out


def _batch_crawl(cfg, keys0, keys1, points, torch):
    """The in-process batch crawl (``driver.Leader``, secure with fresh
    base-OT sessions) over exactly these keys; -> a ``bin.mesh.MeshRun``."""
    from fuzzyheavyhitters_torch.bin.mesh import MeshRun
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.protocol import driver

    dev = torch.device("cuda")
    k0, k1 = (ibdcf.keys_from_numpy(k, dev) for k in (keys0, keys1))
    sessions = (driver.make_sessions(driver.session_material(), dev)
                if cfg.secure_exchange else None)
    lead = driver.Leader(*driver.make_servers(k0, k1), n_dims=cfg.n_dims,
                         data_len=cfg.data_len, f_max=cfg.f_max, secure=sessions,
                         ot_path=cfg.ot_path)
    t0 = time.perf_counter()
    res = lead.run(nreqs=points.shape[0], threshold=cfg.threshold)
    torch.cuda.synchronize()
    return MeshRun(points=points, result=res, leader=lead,
                   seconds={"crawl": time.perf_counter() - t0})


def fleet_move(name, cfg, n, ck, tmp, torch, failover=False):
    """Phases 38-40 (JAX ``tests/test_fleet.py``'s choreographies on the
    card): a collection of ``n`` clients (``ck``, ``bin.leader.client_keys``)
    in ``FLEET_WINDOWS`` windows on two pairs of ``bin.server`` processes
    (``fleet_run``), the leader in this process.  The script's
    ``FleetDirectory`` scans the two pairs the processes registered and
    places the collection on the first; window 0 is submitted and sealed
    there (its ingest checkpoint banked) and half of window 1 submitted.
    Then either ``FleetPlacer.migrate`` moves it to the second pair, or
    (``failover``) a ``host:kill@window=0`` clause fires, both processes of
    the first pair are SIGKILLed, the directory's bounded probe marks it
    dead and ``recover_dead_pair`` fails the collection over to the second
    from the level -1 blob and the journal.  The rest of window 1 goes to
    the second pair, window 1 is sealed, and both windows crawl there.
    -> the figures and the leader's results by window."""
    import asyncio

    from fuzzyheavyhitters_torch.bin import leader as leader_bin
    from fuzzyheavyhitters_torch.protocol.fleet import FleetDirectory, FleetPlacer, status_probe
    from fuzzyheavyhitters_torch.protocol.leader_rpc import RpcLeader, WindowedIngest
    from fuzzyheavyhitters_torch.protocol.rpc import CollectorClient
    from fuzzyheavyhitters_torch.resilience.chaos import HostChaos, parse_host_faults

    src, dst = ("C", "D") if failover else ("A", "B")
    chunks = _fleet_chunks(cfg, n, FLEET_WINDOWS)
    half = len(chunks[1]) // 2

    async def submit(wi, part):
        for client, sl in part:
            await wi.submit(client, tuple(a[sl] for a in ck.keys0),
                            tuple(a[sl] for a in ck.keys1))

    async def lead(fleet_dir, ckpt_dir, kill):
        emit = leader_bin.emit
        fig, clients = {}, []
        fd = FleetDirectory(fleet_dir, emit=emit)
        fig["scanned"] = await fd.scan()
        pairs = {p.name: p for p in await fd.pairs()}
        fig["pairs"] = {k: (p.boot0, p.boot1) for k, p in pairs.items()}
        placer = FleetPlacer(fd, emit=emit)

        async def connect(pair):
            cs = [await CollectorClient.connect(*pair.addr(i)) for i in (0, 1)]
            clients.extend(cs)
            return RpcLeader(cfg, *cs, emit=emit)

        try:
            fig["placed"] = (await placer.place("default")).name
            la = await connect(pairs[src])
            await la._both("reset")
            wi = WindowedIngest(la)
            t0 = time.perf_counter()
            await submit(wi, chunks[0])
            fig["seals"] = [await wi.seal_window()]
            await submit(wi, chunks[1][:half])
            fig["submit_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if not failover:
                lb = await connect(pairs[dst])
                fig["stats"] = await placer.migrate(wi, lb, session="default", dest=dst)
                fig["src_status"] = [await c.call("status") for c in (la.c0, la.c1)]
            else:
                hc = HostChaos(parse_host_faults("host:kill@window=0"), emit=emit)
                if hc.before_window(0):
                    fig["t_kill"] = kill(src)
                fig["fired"] = list(hc.fired)
                fig["died"] = await fd.probe(status_probe(pairs, FLEET_PROBE_S))
                fig["probe_s"] = time.perf_counter() - t0

                async def make_ingest(session, dest):
                    return wi, await connect(dest)

                fig["stats"] = (await placer.recover_dead_pair(src, make_ingest))["default"]
            fig["move_s"] = time.perf_counter() - t0
            await submit(wi, chunks[1][half:])
            fig["seals"].append(await wi.seal_window())
            fig["results"] = {w: await wi.crawl_window(w) for w in range(FLEET_WINDOWS)}
            fig["t_hitters"] = time.time()
            fig["windows"] = dict(wi.windows)
            fig["counters"] = dict(wi.counters)
            fig["dst_status"] = [await c.call("status") for c in (wi.lead.c0, wi.lead.c1)]
            fig["placer"], fig["directory"] = placer.status(), await fd.status()
            return fig
        finally:
            for c in clients:
                await c.aclose()

    run = fleet_run(name, cfg, tmp, (src, dst), lead)
    fig = run["leader_result"]
    ev, exits = run["events"], run["exits"]
    registered = {who: next(e["boot_id"] for e in evs if e["event"] == "fleet.registered")
                  for who, evs in ev.items()}
    want_pairs = {p: (registered[f"{p}0"], registered[f"{p}1"]) for p in (src, dst)}
    if fig["scanned"] != 2 or fig["pairs"] != want_pairs or fig["placed"] != src:
        raise AssertionError(f"{name}: scanned {fig['scanned']} pairs {fig['pairs']} (the "
                             f"processes registered {want_pairs}), placed on {fig['placed']}")
    per_w = n // FLEET_WINDOWS
    replayed = len(chunks[0]) + half
    if (fig["stats"].get("replayed") != replayed
            or [s["keys"] for s in fig["seals"]] != [per_w] * FLEET_WINDOWS
            or fig["counters"]["ingest_admitted"] != n):
        raise AssertionError(f"{name}: move {fig['stats']} (want {replayed} replayed), seals "
                             f"{fig['seals']}, counters {fig['counters']}")
    # exactly once: what the destination imported answers as duplicates (a
    # migration's export carries every journaled submission, a failover's
    # checkpoint window 0's), the rest lands fresh
    dups = replayed if not failover else len(chunks[0])
    dst_exits = [exits[f"{dst}{sid}"] for sid in (0, 1)]
    for sid, ex in enumerate(dst_exits):
        _check_session_sums(name, ex)
        st = fig["dst_status"][sid]["fleet"]
        if ex["pool_dup_submits"] < dups or st["session_imports"] != 1:
            raise AssertionError(f"{name}: {dst}{sid} answered {ex['pool_dup_submits']} "
                                 f"duplicates (want >= {dups}), fleet {st}")
    if failover:
        if (fig["fired"] != [("kill", 0)] or fig["died"] != [src]
                or fig["stats"]["imported"] is not True
                or fig["placer"]["session_failovers"] != 1
                or fig["directory"]["pairs"][src]["alive"] is not False
                or any(exits[f"{src}{sid}"] is not None for sid in (0, 1))):
            raise AssertionError(f"{name}: fired {fig['fired']}, died {fig['died']}, "
                                 f"{fig['stats']}, placer {fig['placer']}, "
                                 f"directory {fig['directory']}")
    else:
        src_st = fig["src_status"]
        if (fig["stats"]["windows"] != list(range(FLEET_WINDOWS))
                or fig["placer"]["session_migrations"] != 1
                or any(st["ingest"]["windows"] or st["fleet"]["session_exports"] != 1
                       for st in src_st)):
            raise AssertionError(f"{name}: {fig['stats']}, placer {fig['placer']}, source "
                                 f"status {[(st['ingest'], st['fleet']) for st in src_st]}")
    if fig["directory"]["placements"] != {"default": dst}:
        raise AssertionError(f"{name}: placements {fig['directory']['placements']}")
    out = {"n": n, "windows": FLEET_WINDOWS, "pairs": (src, dst), "move": fig["stats"],
           "move_s": fig["move_s"], "submit_s": fig["submit_s"],
           "window_crawl_s": [fig["windows"][w]["crawl_s"] for w in range(FLEET_WINDOWS)],
           "seal_to_hitters_s": [fig["windows"][w]["seal_to_hitters_s"]
                                 for w in range(FLEET_WINDOWS)],
           "replayed": replayed, "placer": fig["placer"],
           "dup_submits": [ex["pool_dup_submits"] for ex in dst_exits],
           "launches": {who: (ex or {}).get("launches") for who, ex in exits.items()},
           "plane_handshake_calls": {who: ex["plane_handshake_calls"]
                                     for who, ex in exits.items() if ex is not None},
           "plane_epoch": [ex["sessions"]["per_session"]["default"]["plane_epoch"]
                           for ex in dst_exits],
           "max_memory_allocated": {who: ex["max_memory_allocated"]
                                    for who, ex in exits.items() if ex is not None}}
    if failover:
        out["kill_to_hitters_s"] = fig["t_hitters"] - fig["t_kill"]
        out["probe_s"] = fig["probe_s"]
    else:
        xp = [e for who in (f"{src}0", f"{src}1") for e in ev[who]
              if e["event"] == "fleet.session_exported"]
        out["export_bytes"] = [e["bytes"] for e in xp]
    return out, fig["results"], run


def _fleet_launch_check(name, out, cfg, src, dst, kernels):
    """The source pair launched nothing; each destination server launched
    expand once per crawl verb of the two windows and each kernel of
    ``kernels`` once per verb of a round it garbled (encrypt) or evaluated
    (decrypt), the garbler of round i being i % 2; nothing else."""
    r_per = -(-cfg.data_len // cfg.crawl_radix_bits)
    for who, got in out["launches"].items():
        want = {kn: 0 for kn in KERNELS}
        if who.startswith(dst):
            sid = int(who[-1])
            want["expand"] = FLEET_WINDOWS * r_per
            for kn in kernels:
                want[kn] = FLEET_WINDOWS * len([i for i in range(r_per)
                                                if (i % 2 == sid) == (kn == "ot2s_encrypt")])
        if got is not None and got != want:
            raise AssertionError(f"{name}: server {who} launched {got}, want {want}")
        if got is None and not who.startswith(src):
            raise AssertionError(f"{name}: server {who} printed no server.exit")


def _fleet_hitters(name, cfg, results, run, ck, torch, secure_checks=False):
    """Each window's hitters against the in-process batch crawl over the
    window's keys as the destination banked them (equal to the window's
    slice of the client keys: reject mode admits everything, in order) and
    the plaintext recount; expand (or, ``secure_checks``, the ot2s pair as
    phase 20's replay does) held against its plain version on the batch
    crawl of the last window.  -> (hitters by window, the kernel checks)."""
    from fuzzyheavyhitters_torch.ops import expand_cuda, prg
    from fuzzyheavyhitters_torch.protocol import collect

    per_w = ck.points.shape[0] // FLEET_WINDOWS
    hitters, checks = {}, []
    for w in range(FLEET_WINDOWS):
        sl = slice(w * per_w, (w + 1) * per_w)
        k0, k1 = _banked_window_keys(run["ckpt_dir"], w)
        for got, want in ((k0, ck.keys0), (k1, ck.keys1)):
            if any(a.tobytes() != b[sl].tobytes() for a, b in zip(got, want)):
                raise AssertionError(f"{name}: window {w}'s banked keys are not its clients'")
        batch = _batch_crawl(cfg, k0, k1, ck.points[sl], torch)
        res = results[w]
        if not (np.array_equal(res.paths, batch.result.paths)
                and np.array_equal(res.counts, batch.result.counts)):
            raise AssertionError(f"{name}: window {w}'s hitters differ from the batch crawl's")
        hitters[w] = _hitter_map(res)
        if not hitters[w]:
            raise AssertionError(f"{name}: window {w} has no hitter")
        _recount(f"{name} window {w}", hitters[w], cfg, ck.points[sl])
        if w == FLEET_WINDOWS - 1:
            if secure_checks:
                checks = measure_secure(name, batch, cfg, OT2S, torch)
            else:
                checks = measure_expand(name, batch, cfg, expand_cuda, collect, prg, torch)
        del batch
        torch.cuda.empty_cache()
    return hitters, checks


def fleet_phases(seed, cells, report, errs, tmp, stage, torch):
    """Phases 38-40: the collector fleet on the socket deployment."""
    from fuzzyheavyhitters_torch.bin import leader as leader_bin

    fleet = report["fleet"] = {}
    dev = torch.device("cuda")
    rides_cfg = cells["rides"][0]
    base_crawl_s = report["sockets"]["rides_socket_windows"]["crawl_s"]

    def client_keys(name, cfg, n):
        """The leader's keygen (the script is the leader), its launches
        zeroed just before and read just after."""
        mod, attr = _counter("keygen")
        setattr(mod, attr, 0)
        ck = leader_bin.client_keys(cfg, n, dev, seed)
        launches = getattr(mod, attr)
        if launches <= 0:
            raise AssertionError(f"{name}: the leader's keygen never launched its kernel")
        return ck, launches

    ck, kg = client_keys("rides_socket_fleet_migrate", rides_cfg, FLEET_CLIENTS)
    # phase 38: a live migration between two pairs mid-stream
    name = "rides_socket_fleet_migrate"
    out, results, run = fleet_move(name, rides_cfg, FLEET_CLIENTS, ck, tmp, torch)
    _fleet_launch_check(name, out, rides_cfg, "A", "B", ())
    out["leader_keygen_launches"] = kg
    hitters38, checks = _fleet_hitters(name, rides_cfg, results, run, ck, torch)
    errs["expand"] += [c["max_abs_err"] for c in checks]
    out["expand_checks"], out["hitters"] = checks, {w: len(h) for w, h in hitters38.items()}
    log(f"fleet {name}: N={FLEET_CLIENTS} in {FLEET_WINDOWS} windows, migrated A -> B after "
        f"window 0's seal and half of window 1's submissions: migration {out['move_s']:.3f} s, "
        f"export blob "
        f"{out['export_bytes']} B a server, {out['replayed']} submissions replayed "
        f"(duplicates on B {out['dup_submits']}); window crawls "
        f"{[round(x, 3) for x in out['window_crawl_s']]} s on B (phase 32: "
        f"{[round(x, 3) for x in base_crawl_s]}); hitters {out['hitters']} = the batch crawls "
        f"over B's banked keys and the recount; launches {out['launches']}")
    fleet[name] = out
    stage(f"{name} fleet run")
    # phase 39: the same at rides_secure's config, ot2s at S = 4
    name = "rides_secure_socket_fleet_migrate"
    sec_cfg = cells["rides_secure"][0]
    ck39, kg = client_keys(name, sec_cfg, FLEET_SECURE_CLIENTS)
    out, results, run = fleet_move(name, sec_cfg, FLEET_SECURE_CLIENTS, ck39, tmp, torch)
    _fleet_launch_check(name, out, sec_cfg, "A", "B", OT2S)
    out["leader_keygen_launches"] = kg
    if (out["plane_epoch"] != [1, 1] or [out["plane_handshake_calls"][f"B{i}"] for i in (0, 1)]
            != [1, 1] or [out["plane_handshake_calls"][f"A{i}"] for i in (0, 1)] != [0, 0]):
        raise AssertionError(f"{name}: plane epochs {out['plane_epoch']}, handshakes "
                             f"{out['plane_handshake_calls']}: B must key once a server, A never")
    hitters, checks = _fleet_hitters(name, sec_cfg, results, run, ck39, torch,
                                     secure_checks=True)
    for c in checks:
        errs[c["kernel"]].append(c["max_abs_err"])
    out["secure_checks"], out["hitters"] = checks, {w: len(h) for w, h in hitters.items()}
    log(f"fleet {name}: N={FLEET_SECURE_CLIENTS} in {FLEET_WINDOWS} windows, migrated A -> B:"
        f" {out['move_s']:.3f} s, export {out['export_bytes']} B a server; B keyed once a "
        f"server (plane epochs {out['plane_epoch']}, handshakes "
        f"{out['plane_handshake_calls']}); "
        f"window crawls {[round(x, 3) for x in out['window_crawl_s']]} s; hitters "
        f"{out['hitters']} = the batch crawls and the recount; launches {out['launches']}")
    fleet[name] = out
    del ck39
    stage(f"{name} fleet run")
    # phase 40: phase 38's keys on fresh pairs, the source pair killed
    name = "rides_socket_fleet_host_kill"
    out, results, run = fleet_move(name, rides_cfg, FLEET_CLIENTS, ck, tmp, torch,
                                   failover=True)
    _fleet_launch_check(name, out, rides_cfg, "C", "D", ())
    out["leader_keygen_launches"] = fleet["rides_socket_fleet_migrate"]["leader_keygen_launches"]
    got = {w: _hitter_map(r) for w, r in results.items()}
    if got != hitters38:
        raise AssertionError(f"{name}: hitters differ from phase 38's")
    out["hitters"] = {w: len(h) for w, h in got.items()}
    log(f"fleet {name}: pair C SIGKILLed after window 0's seal with half of window 1 in; "
        f"probe {out['probe_s']:.3f} s, failover to D {out['move_s']:.3f} s ({out['move']}), "
        f"kill to hitters {out['kill_to_hitters_s']:.3f} s; hitters {out['hitters']} = phase "
        f"38's window for window; launches {out['launches']}")
    fleet[name] = out
    del ck
    stage(f"{name} fleet run")


def _profile_kernels(path) -> dict:
    """Device microseconds by kernel symbol in one profile capture's Chrome
    trace (``torch.profiler``'s ``kernel`` events)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    return out


def observed_phase(seed, cells, points, hitters, report, tmp, stage, torch):
    """Phase 41: ``rides_secure_socket`` with the run reports, the traces,
    the level profiles and the heartbeat on (see the module doc)."""
    from fuzzyheavyhitters_torch.obs import trace as obstrace

    name, cell = "rides_secure_socket_observed", "rides_secure"
    cfg, n, per_level = cells[cell][0], cells[cell][1], cells[cell][2]
    obs_dir = os.path.join(tmp, f"{name}_obs")
    trace_dir = os.path.join(obs_dir, "trace")
    env = dict(SOCKET_ENV, FHH_RUN_REPORT=os.path.join(obs_dir, "report.json"),
               FHH_TRACE_DIR=trace_dir, FHH_PROFILE=os.path.join(obs_dir, "profile"),
               FHH_PROFILE_LEVELS=",".join(str(lv) for lv in OBSERVED_LEVELS),
               FHH_HEARTBEAT_S="1")
    run = socket_run(name, cfg, n, seed, tmp, env)
    base = report["sockets"]["rides_secure_socket"]
    rep = check_socket_run(name, run, cfg, points[cell], hitters[cell],
                           report["crawls"][cell]["seconds"]["crawl"], per_level)
    if rep["hitter_map"] != base["hitter_map"]:
        raise AssertionError(f"{name}: hitters differ from rides_secure_socket's")
    reports = {}
    for who, suffix in (("leader", ""), ("s0", ".s0"), ("s1", ".s1")):
        with open(os.path.join(obs_dir, f"report{suffix}.json")) as f:
            reports[who] = json.load(f)
        if reports[who].get("schema") != "fhh-run-report/1":
            raise AssertionError(f"{name}: the {who} run report has schema "
                                 f"{reports[who].get('schema')}")
    L = cfg.data_len
    regs = [reports[f"s{sid}"]["registries"][f"server{sid}"] for sid in (0, 1)]
    for sid, reg in enumerate(regs):
        for ph in ("fss", "gc_ot", "field"):
            got = set(reg["phases"][ph]["by_level"])
            if got != {str(lv) for lv in range(L)}:
                raise AssertionError(f"{name}: server {sid}'s {ph} covers levels {sorted(got)}")
    sent = [r["counters"]["data_bytes_sent"]["total"] for r in regs]
    recv = [r["counters"]["data_bytes_recv"]["total"] for r in regs]
    if sent != recv[::-1]:
        raise AssertionError(f"{name}: data_bytes_sent {sent} against data_bytes_recv {recv}")
    if regs[0]["counters"]["gc_tests"]["by_level"] != regs[1]["counters"]["gc_tests"]["by_level"]:
        raise AssertionError(f"{name}: the servers' gc_tests by level differ")
    # the merged timeline of the three processes
    events = obstrace.load_events(trace_dir)
    verdict = obstrace.merge(trace_dir, os.path.join(obs_dir, "trace.json"))
    if not verdict["ok"] or len(verdict["traces"]) != 1 or not verdict["traces"][0].startswith(
            "crawl-"):
        raise AssertionError(f"{name}: the merged trace: {verdict}")
    spans = {e["span"]: e for e in events if e.get("ph") == "X"}
    verbs = [e for e in spans.values() if e["name"].startswith("verb:")]
    for e in verbs:
        parent = spans.get(e.get("parent"))
        if parent is None or parent["comp"] != "leader" or not parent["name"].startswith("call:"):
            raise AssertionError(f"{name}: server verb span {e} has no leader call span above it")
    if {e["comp"] for e in verbs} != {"server0", "server1"}:
        raise AssertionError(f"{name}: verb spans from {sorted({e['comp'] for e in verbs})}")
    # each server's level captures: the expand and ot2s kernels with device time
    captures = {}
    for sid in (0, 1):
        caps = reports[f"s{sid}"].get("slo", {}).get("profile", [])
        if [c["level"] for c in caps] != list(OBSERVED_LEVELS) or any(
                c["trace"] != verdict["traces"][0] for c in caps):
            raise AssertionError(f"{name}: server {sid}'s captures {caps}")
        us = {}
        for c in caps:
            for k, v in _profile_kernels(c["path"]).items():
                us[k] = us.get(k, 0.0) + v
        captures[f"server{sid}"] = {kn: sum(v for k, v in us.items() if sym in k)
                                    for kn, sym in KERNEL_SYMBOLS.items()}
        if not all(v > 0 for v in captures[f"server{sid}"].values()):
            raise AssertionError(f"{name}: server {sid}'s profiles name {sorted(us)} with device "
                                 f"us {captures[f'server{sid}']}")
    # the card's memory and the builds, from the servers' reports: a server
    # samples at each level's end and at exit, so its watermark holds the
    # key plane the crawl kept on the card and stays within the allocator's
    # peak (server.exit's max_memory_allocated)
    capacity = torch.cuda.mem_get_info()[1]
    memory = []
    for sid, reg in enumerate(regs):
        g = {k: reg["gauges"].get(k, {}).get("last") for k in (
            "hbm_in_use_bytes", "hbm_watermark_bytes", "hbm_limit_bytes", "key_plane_bytes")}
        g["max_memory_allocated"] = run["exits"][sid]["max_memory_allocated"]
        if not (g["hbm_in_use_bytes"] or 0) > 0 or not (
                g["key_plane_bytes"] or 0) <= (g["hbm_watermark_bytes"] or 0) <= (
                g["max_memory_allocated"] or 0) or not (g["key_plane_bytes"] or 0) > 0 or (
                g["hbm_limit_bytes"] != capacity):
            raise AssertionError(f"{name}: server {sid}'s memory gauges {g} (capacity "
                                 f"{capacity})")
        memory.append(g)
        builds = sum(r["counters"].get("fresh_compiles", {}).get("total", 0)
                     for r in reports[f"s{sid}"]["registries"].values())
        if builds:
            raise AssertionError(f"{name}: server {sid} built {builds} kernel libraries")
    beats = [e for who in ("server0", "server1", "leader") for e in run["events"][who]
             if e["event"] == "heartbeat" and e.get("span")]
    if not beats:
        raise AssertionError(f"{name}: no heartbeat named an active span")
    keygen = run["crawl"]["launches"]["keygen"]
    if keygen <= 0:
        raise AssertionError(f"{name}: the leader's keygen launched {keygen} times")
    per = {ph: [round(regs[0]["phases"][ph]["by_level"].get(str(lv), 0.0), 6)
                for lv in range(L)] for ph in ("fss", "gc_ot", "otext", "field")}
    ratio = rep["crawl_s"] / base["crawl_s"]
    log(f"observed {name} server0 per-level seconds: {per}")
    log(f"observed {name}: hitters = rides_secure_socket's; crawl_s={rep['crawl_s']:.3f} "
        f"(rides_secure_socket {base['crawl_s']:.3f}; ratio {ratio:.3f}, no gate) trace "
        f"events={verdict['events']} spans={verdict['spans']} verb spans={len(verbs)} "
        f"capture kernel device us={captures} memory={memory} heartbeats naming a span="
        f"{len(beats)} leader keygen launches={keygen} launches={rep['launches']}")
    rep.update(per_level_s=per, crawl_s_ratio=ratio, trace=verdict, captures=captures,
               memory=memory, heartbeats=len(beats), leader_keygen_launches=keygen,
               secure_kernels=reports["s0"].get("secure_kernels"),
               slo={who: reports[who].get("slo", {}).get("level_latency")
                    for who in reports})
    report["sockets"][name] = rep
    stage(f"{name} socket run")


def free_port_run(n=3) -> int:
    """A base port of localhost with ``base`` .. ``base + n - 1`` free."""
    import socket

    while True:
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", socks[0].getsockname()[1] + i if i else 0))
            return socks[0].getsockname()[1]
        except (OSError, OverflowError):  # taken, or past the last port
            continue
        finally:
            for sk in socks:
                sk.close()


class _Scraper:
    """Phase 42's scrape thread: every ``LIVE_SCRAPE_S`` a GET of /metrics
    from the leader and both servers (``base`` + 0, 1, 2), each answer timed,
    sized and parsed; once both servers' expositions name their ``slo_burn``
    and ``hbm_high_water`` alerts, one ``python -m
    fuzzyheavyhitters_torch.obs.ops top --once`` against the base (unless
    ``top`` is False)."""

    def __init__(self, base, env, log, top=True):
        import threading

        self.targets = {"leader": base, "server0": base + 1, "server1": base + 2}
        self.scrapes = {who: [] for who in self.targets}
        self.last = {}
        self.base, self.env, self.log, self.want_top = base, env, log, top
        self.top = None
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def get(self, who):
        """One scrape of ``who`` -> its text (None when it does not answer)."""
        import urllib.request

        from fuzzyheavyhitters_torch.obs import ops

        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{self.targets[who]}/metrics",
                                        timeout=5) as resp:
                body = resp.read()
        except OSError:
            return None
        ms = (time.perf_counter() - t0) * 1e3
        text = body.decode()
        lines = [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]
        self.scrapes[who].append({"ms": ms, "bytes": len(body), "lines": len(lines),
                                  "samples": len(ops.parse_prometheus(text))})
        self.last[who] = text
        return text

    def _loop(self):
        while not self.stop.is_set():
            for who in self.targets:
                self.get(who)
            if self.want_top and self.top is None and all(
                    f'fhh_alert_active{{rule="{rule}",subject="server{sid}"}}' in
                    self.last.get(f"server{sid}", "")
                    for sid in (0, 1) for rule in ("slo_burn", "hbm_high_water")):
                self.top = POOL.start("fuzzyheavyhitters_torch.obs.ops", ["top", "--once"],
                                      os.path.dirname(self.log),
                                      {**self.env, "FHH_METRICS_PORT": str(self.base)}, self.log)
            self.stop.wait(LIVE_SCRAPE_S)


def _alert_keys(recs) -> list:
    return sorted((r["rule"], r["subject"]) for r in recs)


def live_phase(seed, cells, points, hitters, report, tmp, stage):
    """Phase 42: ``rides_secure_socket`` with the live plane and both
    sanitizers on (see the module doc)."""
    import asyncio
    import glob

    from fuzzyheavyhitters_torch.obs import exporter as obsexporter
    from fuzzyheavyhitters_torch.obs import ops
    from fuzzyheavyhitters_torch.obs.hist import Histogram
    from fuzzyheavyhitters_torch.protocol.rpc import CollectorClient

    name, cell = "rides_secure_socket_live", "rides_secure"
    cfg, n, per_level = cells[cell][0], cells[cell][1], cells[cell][2]
    obs_dir = os.path.join(tmp, f"{name}_obs")
    trace_dir = os.path.join(obs_dir, "trace")
    os.makedirs(obs_dir)
    base = free_port_run(3)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(SOCKET_ENV, **LIVE_ENV, FHH_METRICS_PORT=str(base), FHH_TRACE_DIR=trace_dir,
               FHH_RUN_REPORT=os.path.join(obs_dir, "report.json"))
    scraper = _Scraper(base, {**os.environ, **LOG_ENV, **env, "PYTHONPATH": repo + os.pathsep +
                              os.environ.get("PYTHONPATH", "")},
                       os.path.join(obs_dir, "ops_top.log"))

    def after_leader(ports, logs):
        """The crawl is over: stop the scrape thread, wait for the frame of
        ``ops top``, hold the servers past the stall budget, scrape them
        again, then ask each its status."""
        t_end = time.time()
        scraper.stop.set()
        scraper.thread.join(30)
        top_rc = None if scraper.top is None else scraper.top.wait(timeout=120)
        time.sleep(LIVE_STALL_S + 1.5)
        post = {sid: scraper.get(f"server{sid}") for sid in (0, 1)}

        async def statuses():
            out = []
            for p in ports:
                c = await CollectorClient.connect("127.0.0.1", p)
                try:
                    out.append(await c.call("status"))
                finally:
                    await c.aclose()
            return out

        return {"t_end": t_end, "top_rc": top_rc, "post": post,
                "status": asyncio.run(asyncio.wait_for(statuses(), 60))}

    scraper.thread.start()
    try:
        run = socket_run(name, cfg, n, seed, tmp, env, after_leader=after_leader)
    finally:
        scraper.stop.set()
        scraper.thread.join(30)
        if scraper.top is not None and scraper.top.poll() is None:
            scraper.top.kill()
            scraper.top.wait()
    base_run = report["sockets"]["rides_secure_socket"]
    rep = check_socket_run(name, run, cfg, points[cell], hitters[cell],
                           report["crawls"][cell]["seconds"]["crawl"], per_level)
    if rep["hitter_map"] != base_run["hitter_map"]:
        raise AssertionError(f"{name}: hitters differ from rides_secure_socket's")
    after = run["after"]
    for who in ("leader", "server0", "server1"):
        with open(os.path.join(run["work"], f"{who}.log")) as f:
            text = f.read()
        if "GuardViolation" in text or "TaintViolation" in text:
            raise AssertionError(f"{name}: a sanitizer fired in {who}'s log:\n{text[-3000:]}")
        offset = obsexporter.PORT_OFFSETS["leader" if who == "leader" else f"s{who[-1]}"]
        bound = [e["port"] for e in run["events"][who] if e["event"] == "metrics.listening"]
        if bound != [base + offset] or any(e["event"] == "metrics.disabled"
                                           for e in run["events"][who]):
            raise AssertionError(f"{name}: {who}'s exporter bound {bound}, want "
                                 f"[{base + offset}]")
        # every answer parsed line for line (a leader's first ones hold no
        # sample yet), at least two during the crawl
        got = scraper.scrapes[who]
        if (len(got) < 2 + (who != "leader") or any(sc["samples"] != sc["lines"] for sc in got)
                or not any(sc["samples"] for sc in got)):
            raise AssertionError(f"{name}: {who}'s scrapes {got}")
    reports = {}
    for sid in (0, 1):
        with open(os.path.join(obs_dir, f"report.s{sid}.json")) as f:
            reports[sid] = json.load(f)
    scraped, counters_advanced, alerts, markers = {}, {}, {}, {}
    for sid in (0, 1):
        reg_name = f"server{sid}"
        reg = reports[sid]["registries"][reg_name]
        samples = ops.parse_prometheus(after["post"][sid] or "")

        def series(family, key=None):
            """The server registry's samples of ``family`` (its ``key`` label
            ``key``; le labels kept)."""
            return [(lb, v) for nm, lb, v in samples if nm == family and lb.get(
                "registry") == reg_name and "collection" not in lb and lb.get("key") == key]

        # the level latency: the scrape carries the report's bucket counts,
        # count and sum; its p95 is the report's unless the report's is
        # clamped to the observed extremes, which the exposition lacks
        snap = reg["hists"]["level_latency"]
        (_, sum_s), = series("fhh_level_latency_seconds_sum")
        (_, count), = series("fhh_level_latency_seconds_count")
        h = ops.hist_from_series(series("fhh_level_latency_seconds_bucket"), sum_s, int(count))
        want_h = Histogram.from_snapshot(snap)
        p95 = h.quantile(0.95)
        slo = reports[sid]["slo"]["level_latency"]["by_registry"][reg_name]
        h.min, h.max = want_h.min, want_h.max
        if (h.counts != want_h.counts or (h.count, snap["count"]) != (cfg.data_len,) * 2
                or round(h.sum, 6) != snap["sum_s"] or round(h.quantile(0.95), 6) != slo["p95_s"]
                or (round(p95, 6) != slo["p95_s"] and slo["p95_s"] not in (
                    slo["max_s"], slo["min_s"]))):
            raise AssertionError(f"{name}: server {sid}'s scraped level_latency (p95 {p95}, "
                                 f"count {h.count}) against its report's {slo}")
        scraped[reg_name] = {"p95_s": p95, "report_p95_s": slo["p95_s"], "count": h.count}
        # the crawl's counters in that scrape against the report's at exit
        differ = {}
        for cname, ent in reg["counters"].items():
            fam, extra = obsexporter._split_key(cname)
            vals = [v for _, v in series(f"fhh_{fam}_total", extra.get("key"))]
            if vals != [float(ent["total"])]:
                differ[cname] = (vals, ent["total"])
        if not set(differ) <= LIVE_ADVANCED:
            raise AssertionError(f"{name}: server {sid}'s scraped counters differ from its "
                                 f"report's: {differ}")
        counters_advanced[reg_name] = differ
        # the alerts: each rule once a subject, the same on every surface
        want = sorted([("hbm_high_water", reg_name), ("slo_burn", reg_name),
                       ("tenant_stall", f"{reg_name}/default")])
        status = after["status"][sid]["alerts"]
        instants = []
        for path in glob.glob(os.path.join(trace_dir, f"fhh_trace_s{sid}_*.jsonl*")):
            with open(path) as f:
                instants += [json.loads(ln) for ln in f if ln.startswith("{") and ln.endswith("\n")]
        surfaces = {
            "status": _alert_keys(status["fired"]),
            "report": _alert_keys(reports[sid].get("alerts", {}).get("fired", [])),
            "log": sorted((e["event"][len("alert."):], e["subject"])
                          for e in run["events"][reg_name] if e["event"].startswith("alert.")),
            "trace": sorted((e["name"][len("alert:"):], e["args"]["subject"]) for e in instants
                            if e.get("ph") == "i" and e["name"].startswith("alert:")),
        }
        stall = [r for r in status["fired"] if r["rule"] == "tenant_stall"]
        if (any(v != want for v in surfaces.values()) or status["count"] != len(want)
                or stall[0]["ts"] < after["t_end"] - 0.5
                or stall[0]["last_progress_s"] < LIVE_STALL_S):
            raise AssertionError(f"{name}: server {sid}'s alerts {surfaces} (status "
                                 f"{status}), want {want}, the stall after "
                                 f"{after['t_end']:.3f}")
        alerts[reg_name] = status["fired"]
        markers[reg_name] = run["exits"][sid].get("taint_markers")
        if not markers[reg_name]:
            raise AssertionError(f"{name}: server {sid} registered no secret "
                                 f"({run['exits'][sid]})")
    # the one frame of ops top, taken during the crawl
    if after["top_rc"] != 0:
        raise AssertionError(f"{name}: ops top exited {after['top_rc']}")
    with open(scraper.log) as f:
        frame = f.read()
    lines = frame.splitlines()
    for sid in (0, 1):
        for rule in ("slo_burn", "hbm_high_water"):
            if not any(ln.split() == ["!!", rule, f"server{sid}"] for ln in lines):
                raise AssertionError(f"{name}: the ops top frame lacks {rule} of server "
                                     f"{sid}:\n{frame}")
        if not any(ln.split()[:2] == [f"server{sid}", "default"] for ln in lines):
            raise AssertionError(f"{name}: the ops top frame lacks server {sid}'s default "
                                 f"collection row:\n{frame}")
    med = {who: {k: sorted(sc[k] for sc in got)[len(got) // 2] for k in ("ms", "bytes")}
           for who, got in scraper.scrapes.items()}
    ratio = rep["crawl_s"] / base_run["crawl_s"]
    log(f"live {name}: hitters = rides_secure_socket's; crawl_s={rep['crawl_s']:.3f} "
        f"(rides_secure_socket {base_run['crawl_s']:.3f}; ratio {ratio:.3f}, no gate) scrapes="
        f"{ {w: len(g) for w, g in scraper.scrapes.items()} } median ms/bytes={med} "
        f"exporter base={base} level_latency={scraped} counters the status call and the exit "
        f"advance={ {r: sorted(d) for r, d in counters_advanced.items()} } alerts="
        f"{ {r: [(a['rule'], a['subject']) for a in v] for r, v in alerts.items()} } "
        f"taint markers={markers} ops top frame={lines[:2]} launches={rep['launches']}")
    rep.update(crawl_s_ratio=ratio, scrapes={w: len(g) for w, g in scraper.scrapes.items()},
               scrape_median=med, level_latency=scraped, counters_advanced=counters_advanced,
               alerts=alerts, taint_markers=markers, ops_top=frame,
               leader_keygen_launches=run["crawl"]["launches"]["keygen"])
    report["sockets"][name] = rep
    stage(f"{name} socket run")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--profile", action="store_true",
                    help="also crawl each cell once more under torch.profiler")
    ap.add_argument("--out", default=None, help="also write all figures to this JSON file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from fuzzyheavyhitters_torch.ops import cuda_build, expand_cuda, ibdcf, keygen_cuda, prg
    from fuzzyheavyhitters_torch.protocol import collect
    from fuzzyheavyhitters_torch.utils import config as configmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    stage_s, clock = {}, [time.perf_counter()]

    def stage(what):
        """Log and keep the seconds since the previous stage ended."""
        now = time.perf_counter()
        stage_s[what] = now - clock[0]
        log(f"stage {what}: {stage_s[what]:.1f} s")
        clock[0] = now

    libs = cuda_build.build()
    log(f"built {sorted(libs)}")
    from fuzzyheavyhitters_torch import native

    # the ingest front door's reservoir (phase 33) and the rides CSV sampler:
    # the native library built with the host's g++, or its Python twin
    native_lib = "loaded" if native.available() else "not built (the Python twin serves)"
    log(f"native reservoir library: {native_lib} ({native.lib_path()})")
    stage("build")
    for name in libs:
        for line in cuda_build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    errs = {kn: [] for kn in KERNELS}
    errs["keygen"].append(check_keygen_chunks(keygen_cuda, torch, rng))
    stage("keygen_chunk")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "config.json")) as f:
        rides_raw = json.load(f)
    # name: (config, clients, kernels launched once per level, driver, least
    # hitters); covid wants every hot county and its 3 x 3 ulp ball
    covid_cfg = configmod.Config(**COVID)
    cells = {
        "config4_zipf": (configmod.Config(**CONFIG4), ZIPF_CLIENTS, (), mesh_run, 1),
        "rides": (configmod.Config(**rides_raw), RIDES_CLIENTS, (), mesh_run, 1),
        "config4_zipf_secure": (configmod.Config(**CONFIG4, secure_exchange=True,
                                                 ot_path="auto"), ZIPF_SECURE_CLIENTS, OT2S,
                                mesh_run, 1),
        "rides_secure_gc": (configmod.Config(**dict(rides_raw, secure_exchange=True,
                                                    ot_path="gc")), RIDES_CLIENTS, GC,
                            mesh_run, 1),
        "rides_secure": (configmod.Config(**dict(rides_raw, secure_exchange=True,
                                                 ot_path="auto")), RIDES_SECURE_CLIENTS, OT2S,
                         mesh_run, 1),
        "covid": (covid_cfg, COVID_CLIENTS, (), covid_run, covid_cfg.num_sites * 9),
    }
    # phase 9: socket cell -> the in-process cell of the same config, seed and N
    sockets = {"rides_socket": "rides", "rides_secure_socket": "rides_secure"}
    report = {"device": smi, "crawls": {}, "sockets": {}, "stage_s": stage_s}
    points, launches, hitters = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cfg, n, per_level, drive, min_hitters) in cells.items():
            run, launches[name], fig = run_main_path(name, cfg, n, args.seed, tmp,
                                                     per_level, drive, min_hitters)
            stage(f"{name} crawl")
            if args.profile:
                window = None
                if per_level:  # PROFILE_LEVELS secure levels from the widest FE62 one
                    w0 = run.leader.buckets.index(max(run.leader.buckets[:-1]))
                    window = list(range(w0, min(cfg.data_len, w0 + PROFILE_LEVELS)))
                fig["profile"] = profile_crawl(name, run, cfg, torch, window)
                stage(f"{name} profile")
            if per_level:
                fig["secure_checks"] = measure_secure(name, run, cfg, per_level, torch)
                for c in fig["secure_checks"]:
                    errs[c["kernel"]].append(c["max_abs_err"])
                stage(f"{name} secure checks")
            fig["expand_checks"] = measure_expand(name, run, cfg, expand_cuda, collect,
                                                  prg, torch)
            errs["expand"] += [c["max_abs_err"] for c in fig["expand_checks"]]
            points[name] = run.points
            hitters[name] = {str(row.tolist()): int(c) for row, c in
                             zip(run.result.decode_ints(), run.result.counts)}
            stage(f"{name} expand checks")
            report["crawls"][name] = fig
            del run
            torch.cuda.empty_cache()
        # phase 13: config4_zipf's keys crawled in fused rounds of ZIPF_RADIX levels
        name = "config4_zipf_radix3"
        cfg_r = dataclasses.replace(cells["config4_zipf"][0], crawl_radix_bits=ZIPF_RADIX)
        tail = {}
        run, launches[name], fig = run_main_path(name, cfg_r, ZIPF_CLIENTS, args.seed, tmp, (),
                                                 functools.partial(radix_run, tail=tail), 1)
        got = {str(row.tolist()): int(c) for row, c in
               zip(run.result.decode_ints(), run.result.counts)}
        if got != hitters["config4_zipf"]:
            raise AssertionError(f"{name}: hitters differ from config4_zipf's")
        # r passes of the kernel per fused round and server: 2 x data_len
        want_ex, rounds = 2 * cfg_r.data_len, -(-cfg_r.data_len // ZIPF_RADIX)
        if launches[name]["expand"] != want_ex or len(run.leader.buckets) != rounds:
            raise AssertionError(f"{name}: {launches[name]['expand']} expand launches over "
                                 f"{len(run.leader.buckets)} rounds, want {want_ex} over {rounds}")
        main4 = report["crawls"]["config4_zipf"]
        log(f"radix {name}: hitters={len(got)} (= config4_zipf's, each = the plaintext recount) "
            f"rounds={rounds} crawl_s={run.seconds['crawl']:.3f} (config4_zipf: "
            f"{main4['seconds']['crawl']:.3f}) max_memory_allocated={fig['max_memory_allocated']} "
            f"(config4_zipf: {main4['max_memory_allocated']}) expand_launches="
            f"{launches[name]['expand']} (= {want_ex}) buckets_max={max(run.leader.buckets)}")
        stage(f"{name} crawl")
        if args.profile:
            fig["profile"] = profile_crawl(name, run, cfg_r, torch)
            stage(f"{name} profile")
        fig["radix_checks"] = measure_radix(name, run, cfg_r, tail, expand_cuda, collect, prg,
                                            torch)
        errs["expand"] += [c["max_abs_err"] for c in fig["radix_checks"]]
        stage(f"{name} checks")
        report["crawls"][name] = fig
        del run
        torch.cuda.empty_cache()
        # phases 10-11: the streamed config-4 crawl from host keys, and its resume
        name, cfg4 = "config4_zipf_stream", cells["config4_zipf"][0]
        run, launches[name], fig = run_main_path(name, cfg4, ZIPF_CLIENTS, args.seed, tmp,
                                                 (), stream_run, 1)
        lead = run.leader
        got = {str(row.tolist()): int(c) for row, c in
               zip(run.result.decode_ints(), run.result.counts)}
        if got != hitters["config4_zipf"]:
            raise AssertionError(f"{name}: hitters differ from config4_zipf's")
        want_ex = stream_launches(lead.buckets, STREAM["stream_chunk"])
        want_kg = -(-ZIPF_CLIENTS // KEYGEN_HOST_CHUNK)
        if launches[name]["expand"] != want_ex or launches[name]["keygen"] != want_kg:
            raise AssertionError(f"{name}: launches {launches[name]}, want expand={want_ex} "
                                 f"keygen={want_kg}")
        keys = (lead.server0.keys, lead.server1.keys)
        # the parties share their correction words: count each tensor once
        fig["host_key_bytes"] = sum(t.nbytes for t in {id(t): t for k in keys for t in k}.values())
        log(f"stream {name}: hitters={len(got)} (= config4_zipf's, each = the plaintext "
            f"recount) keygen_s={run.seconds['keygen']:.3f} (chunks of {KEYGEN_HOST_CHUNK} "
            f"into host memory) crawl_s={run.seconds['crawl']:.3f} host_key_bytes="
            f"{fig['host_key_bytes']} max_memory_allocated={fig['max_memory_allocated']} "
            f"(cached config4_zipf: "
            f"{report['crawls']['config4_zipf']['max_memory_allocated']}) "
            f"expand_launches={launches[name]['expand']} (= {want_ex}) "
            f"buckets_max={max(lead.buckets)}")
        stage(f"{name} crawl")
        if args.profile:
            fig["profile"] = profile_crawl(name, run, cfg4, torch)
            stage(f"{name} profile")
        # from here on the cells' processes start warm: the first cell's
        # interpreters warm during these checks, which time on the card
        POOL.on = True
        POOL.fill()
        fig["stream_checks"] = measure_stream_expand(name, run, cfg4, expand_cuda, prg, torch)
        errs["expand"] += [c["max_abs_err"] for c in fig["stream_checks"]]
        kg = measure_keygen(f"{name} chunk", run.points[:KEYGEN_HOST_CHUNK], cfg4, keygen_cuda,
                            ibdcf, torch, rng)
        fig["keygen_check"] = kg
        errs["keygen"].append(kg["max_abs_err"])
        stage(f"{name} checks")
        fig["resume"] = resume_run("config4_zipf_resume", run, cfg4, tmp, got)
        stage("config4_zipf_resume")
        report["crawls"][name] = fig
        del run, lead, keys
        torch.cuda.empty_cache()
        for name, cell in sockets.items():
            cfg, n, per_level = cells[cell][0], cells[cell][1], cells[cell][2]
            run = socket_run(name, cfg, n, args.seed, tmp, SOCKET_ENV)
            report["sockets"][name] = check_socket_run(
                name, run, cfg, points[cell], hitters[cell],
                report["crawls"][cell]["seconds"]["crawl"], per_level)
            stage(f"{name} socket run")
        # phase 12: the same socket cells crawled in node spans, pipelined
        for base in list(sockets):
            name, cell = f"{base}_spans", sockets[base]
            cfg, n, per_level = cells[cell][0], cells[cell][1], cells[cell][2]
            extra = dict(SPANS, **({"secure_whole_level": False} if cfg.secure_exchange else {}))
            cfg = dataclasses.replace(cfg, **extra)
            run = socket_run(name, cfg, n, args.seed, tmp, SOCKET_ENV)
            rep = check_socket_run(name, run, cfg, points[cell], hitters[cell],
                                   report["crawls"][cell]["seconds"]["crawl"], per_level)
            whole = report["sockets"][base]
            if rep["hitter_map"] != whole["hitter_map"]:
                raise AssertionError(f"{name}: hitters differ from {base}'s")
            log(f"spans {name}: {extra} hitters = {base}'s; data_frame_max={rep['data_frame_max']}"
                f" ({base}: {whole['data_frame_max']}) crawl_s={rep['crawl_s']:.3f} ({base}: "
                f"{whole['crawl_s']:.3f}) crawl_verbs_per_server={rep['crawl_verbs']} "
                f"pipeline={rep['pipeline']}")
            report["sockets"][name] = rep
            stage(f"{name} socket run")
        # phases 14-15: rides over sockets in fused rounds of RIDES_RADIX levels
        rides_cfg = cells["rides"][0]
        radix_sockets = {
            "rides_socket_radix2": (
                dataclasses.replace(rides_cfg, crawl_radix_bits=RIDES_RADIX), RIDES_CLIENTS, (),
                "rides_socket"),
            "rides_secure_socket_radix2": (
                dataclasses.replace(rides_cfg, secure_exchange=True, ot_path="auto",
                                    crawl_radix_bits=RIDES_RADIX),
                RIDES_RADIX_SECURE_CLIENTS, GC, "rides_secure_socket"),
        }
        for name, (cfg, n, per_level, base) in radix_sockets.items():
            if n == RIDES_CLIENTS:  # the rides cell: bin.mesh at this config, seed and N
                pts, want_h = points["rides"], hitters["rides"]
                mesh_s = report["crawls"]["rides"]["seconds"]["crawl"]
            else:  # bin.mesh at this config, seed and N, which crawls one level a round
                mrun = mesh_run(f"{name}_mesh", cfg, n, args.seed, tmp)
                res = mrun.result
                if len(mrun.leader.timings["expand"]) != cfg.data_len:
                    raise AssertionError(f"{name}: bin.mesh crawled "
                                         f"{len(mrun.leader.timings['expand'])} rounds")
                if not np.array_equal(res.counts, plaintext_counts(mrun.points, cfg.ball_size,
                                                                   res.paths)):
                    raise AssertionError(f"{name}: bin.mesh counts != the plaintext recount")
                pts, mesh_s = mrun.points, mrun.seconds["crawl"]
                want_h = {str(row.tolist()): int(c) for row, c in
                          zip(res.decode_ints(), res.counts)}
                del mrun, res
                torch.cuda.empty_cache()
            run = socket_run(name, cfg, n, args.seed, tmp, SOCKET_ENV)
            rep = check_socket_run(name, run, cfg, pts, want_h, mesh_s, per_level)
            whole = report["sockets"][base]
            log(f"radix {name}: crawl_radix_bits={RIDES_RADIX} N={n} hitters = bin.mesh's; "
                f"crawl_verbs_per_server={rep['crawl_verbs']} ({base}: {whole['crawl_verbs']}) "
                f"data_bytes_sent={rep['data_bytes_sent']} ({base} at N={whole['n']}: "
                f"{whole['data_bytes_sent']}) data_frame_max={rep['data_frame_max']} "
                f"crawl_s={rep['crawl_s']:.3f} ({base}: {whole['crawl_s']:.3f})")
            report["sockets"][name] = rep
            stage(f"{name} socket run")
        # phase 16: phase 14 again, its leader warming the buckets that crawl walked
        name, base = "rides_socket_radix2_warm", "rides_socket_radix2"
        cfg, cold = radix_sockets[base][0], report["sockets"][base]
        run = socket_run(name, cfg, RIDES_CLIENTS, args.seed, tmp,
                         warm_buckets=sorted(set(cold["buckets"])))
        if run["warmup"] is None:
            raise AssertionError(f"{name}: the leader ran no warmup (FHH_WARMUP=0 is set)")
        rep = check_socket_run(name, run, cfg, points["rides"], hitters["rides"],
                               report["crawls"]["rides"]["seconds"]["crawl"], ())
        if rep["hitter_map"] != cold["hitter_map"]:
            raise AssertionError(f"{name}: hitters differ from {base}'s")
        log(f"warmup {name}: f_buckets={run['warmup']['f_buckets']} shapes="
            f"{run['warmup']['shapes']} warmup_s={run['warmup']['seconds']:.3f} hitters = "
            f"{base}'s; crawl_s={rep['crawl_s']:.3f} ({base}, no warmup: {cold['crawl_s']:.3f}) "
            f"server max_memory_allocated={rep['max_memory_allocated']} ({base}: "
            f"{cold['max_memory_allocated']}) expand_launches="
            f"{[rep['launches'][w]['expand'] for w in ('server0', 'server1')]}")
        report["sockets"][name] = rep
        stage(f"{name} socket run")
        # phase 17: rides_socket under the supervised crawl, no fault
        name, rides_cfg = "rides_socket_supervised", cells["rides"][0]
        run = socket_run(name, rides_cfg, RIDES_CLIENTS, args.seed, tmp, SUPERVISED_ENV,
                         supervise=True)
        sup = check_supervised_run(name, run, rides_cfg, report["sockets"]["rides_socket"][
            "hitter_map"], points["rides"])
        want_ck = len([lv for lv in range(CKPT_EVERY, rides_cfg.data_len, CKPT_EVERY)])
        if sup["counters"]["recoveries"] or any(sv["checkpoint_writes"] != want_ck
                                                for sv in sup["servers"]):
            raise AssertionError(f"{name}: {sup['counters']}, checkpoints "
                                 f"{[sv['checkpoint_writes'] for sv in sup['servers']]}, want "
                                 f"{want_ck} each and no recovery")
        base = report["sockets"]["rides_socket"]
        log(f"supervised {name}: crawl_s={sup['crawl_s']:.3f} (reset, upload and rounds; "
            f"rides_socket: rounds {base['crawl_s']:.3f}, upload {base['addkeys_s']:.3f}) "
            f"rounds_s={sup['seconds_by_part']['levels']:.3f} checkpoints a server={want_ck}")
        report["sockets"][name] = sup
        stage(f"{name} socket run")
        # phase 18: phase 17 with server 1 killed at its first checkpoint
        name = "rides_socket_supervised_kill"
        run = socket_run(name, rides_cfg, RIDES_CLIENTS, args.seed, tmp, SUPERVISED_ENV,
                         supervise=True, kill=True)
        rep = check_supervised_run(name, run, rides_cfg, sup["hitter_map"], points["rides"])
        if rep["counters"]["recoveries"] < 1 or rep["counters"]["levels_rerun"] < 1:
            raise AssertionError(f"{name}: counters {rep['counters']} after a kill")
        stage(f"{name} socket run")
        from fuzzyheavyhitters_torch.bin import leader as leader_bin

        keys1 = leader_bin.client_keys(rides_cfg, RIDES_CLIENTS, torch.device("cuda"),
                                       args.seed).keys1
        rep["restored_check"] = restored_expand_check(name, run["killed"]["restored_blob"],
                                                      rides_cfg, keys1, expand_cuda, collect,
                                                      prg, torch)
        del keys1
        errs["expand"].append(rep["restored_check"]["max_abs_err"])
        report["sockets"][name] = rep
        stage(f"{name} restored check")
        # phase 19: secure rides (ot2s at S = 4), the leader's link to server 0
        # severed in the answer's direction at level CKPT_EVERY's crawl verb, and
        # server 1 killed at its first checkpoint
        name = "rides_secure_socket_supervised_sever"
        cfg = cells["rides_secure"][0]
        chunks = -(-RIDES_SEVER_CLIENTS // cfg.addkey_batch_size)
        # frames to the leader: hello, reset, the chunks, tree_init, a crawl and
        # a prune a level, the checkpoint after the round ending at CKPT_EVERY
        at = chunks + 3 + 2 * CKPT_EVERY + 2
        run = socket_run(name, cfg, RIDES_SEVER_CLIENTS, args.seed, tmp, SUPERVISED_ENV,
                         supervise=True, kill=True, ctl0_faults=f"ctl0:sever@msg={at},dir=s2c")
        from fuzzyheavyhitters_torch.protocol import driver

        trusted = dataclasses.replace(cfg, secure_exchange=False)
        pts, k0, k1 = leader_bin.client_keys(trusted, RIDES_SEVER_CLIENTS,
                                             torch.device("cuda"), args.seed)[:3]
        lead = driver.Leader(*driver.make_servers(
            *(ibdcf.keys_from_numpy(k, "cuda") for k in (k0, k1))), n_dims=cfg.n_dims,
            data_len=cfg.data_len, f_max=cfg.f_max)
        res = lead.run(nreqs=RIDES_SEVER_CLIENTS, threshold=cfg.threshold)
        want_h = {str(row.tolist()): int(c) for row, c in zip(res.decode_ints(), res.counts)}
        del lead, res, k0, k1
        torch.cuda.empty_cache()
        rep = check_supervised_run(name, run, cfg, want_h, pts, OT2S)
        s0 = rep["servers"][0]
        if (s0["dedup_hits"] < 1 or rep["epochs"][0] < 2 or rep["counters"]["recoveries"] < 1
                or run["proxy_fired"] != [("sever", "s2c", at)]):
            raise AssertionError(f"{name}: dedup_hits={s0['dedup_hits']} epochs={rep['epochs']} "
                                 f"counters={rep['counters']} fired={run['proxy_fired']}")
        rep["sever_at"] = at
        log(f"supervised {name}: sever at ctl0 s2c frame {at} fired, server 0 dedup_hits="
            f"{s0['dedup_hits']}, leader epochs={rep['epochs']}, hitters = driver.Leader's "
            f"(trusted, same keys); data_bytes_sent={[sv['data_bytes_sent'] for sv in rep['servers']]}")
        report["sockets"][name] = rep
        stage(f"{name} socket run")
        # phase 20: configs/secure.json, malicious, its leader in this process
        # forging 18 clients' sketch keys
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "secure.json")) as f:
            secure_cfg = configmod.Config(**json.load(f))
        name = "secure_malicious_socket"
        fig = malicious_forged_run(name, secure_cfg, MALICIOUS_CLIENTS, args.seed, tmp,
                                   expand_cuda, collect, prg, torch)
        errs["expand"].append(fig["restored_check"]["max_abs_err"])
        report["sockets"][name] = fig
        stage(f"{name} socket run")
        # its ot2s kernels at its widest FE62 level and its F255 leaf: the
        # same ibDCF keys (sketch keys do not touch them) in process, the
        # malicious flag off
        name = "secure_malicious_replay"
        cfg = dataclasses.replace(secure_cfg, malicious=False)
        run, launches[name], rfig = run_main_path(name, cfg, MALICIOUS_CLIENTS, args.seed,
                                                  tmp, OT2S, mesh_run, 1)
        rfig["secure_checks"] = measure_secure(name, run, cfg, OT2S, torch)
        for c in rfig["secure_checks"]:
            errs[c["kernel"]].append(c["max_abs_err"])
        report["crawls"][name] = rfig
        del run
        torch.cuda.empty_cache()
        stage(f"{name} secure checks")
        # phase 21: the same config on the trusted exchange at the sketch batch
        name = "zipf_malicious_socket"
        cfg21 = dataclasses.replace(secure_cfg, secure_exchange=False)
        fig, pts21 = malicious_batch_run(name, cfg21, SKETCH_CLIENTS, args.seed, tmp)
        report["sockets"][name] = fig
        stage(f"{name} socket run")
        # its semi-honest twin (malicious off, supervised alike): the sketch's
        # overhead, bench.py:1096 bench_sketch's malicious_overhead_vs_semi_honest
        twin = "zipf_semi_honest_socket"
        run = socket_run(twin, dataclasses.replace(cfg21, malicious=False), SKETCH_CLIENTS,
                         args.seed, tmp, SOCKET_ENV, supervise=True)
        rep = check_supervised_run(twin, run, cfg21, fig["hitter_map"], pts21)
        fig["semi_honest_rounds_s"] = rep["seconds_by_part"]["levels"]
        fig["malicious_overhead_vs_semi_honest"] = fig["crawl_s"] / fig["semi_honest_rounds_s"]
        log(f"malicious {name}: rounds {fig['crawl_s']:.3f} s against {twin}'s "
            f"{fig['semi_honest_rounds_s']:.3f} s (hitters equal): "
            f"malicious_overhead_vs_semi_honest={fig['malicious_overhead_vs_semi_honest']:.3f}")
        report["sockets"][twin] = rep
        stage(f"{twin} socket run")
        kg = measure_keygen(name, pts21, cfg21, keygen_cuda, ibdcf, torch, rng,
                            both_modes=True)
        fig["keygen_check"] = kg
        errs["keygen"].append(kg["max_abs_err"])
        del pts21
        stage(f"{name} keygen check")
        mesh_phases(args.seed, cells, hitters, points, report, launches, errs, tmp, stage)
        sharded_phases(args.seed, cells, hitters, points, secure_cfg, report, errs, tmp, stage,
                       torch)
        window_phases(args.seed, cells, points, secure_cfg, report, tmp, stage, torch)
        tenant_phases(args.seed, cells, report, tmp, stage, torch)
        fleet_phases(args.seed, cells, report, errs, tmp, stage, torch)
        observed_phase(args.seed, cells, points, hitters, report, tmp, stage, torch)
        live_phase(args.seed, cells, points, hitters, report, tmp, stage)
    for name in points:
        kg = measure_keygen(name, points[name], cells[name][0], keygen_cuda, ibdcf, torch, rng)
        report["crawls"][name]["keygen_check"] = kg
        errs["keygen"].append(kg["max_abs_err"])
    stage("keygen checks")
    report["chunk_checks"] = chunk_checks(torch, args.seed)
    stage("chunk checks")
    report["gc_timing"] = gc_timing(torch, args.seed)
    stage("gc timing")
    report["ot2s_timing"] = ot2s_timing(torch, args.seed)
    stage("ot2s timing")
    for kn, cs in report["chunk_checks"].items():
        errs[kn] += [c["max_abs_err"] for c in cs]

    main4 = report["crawls"]["config4_zipf"]
    widest = lambda cell, kn: next(c for c in report["crawls"][cell]["secure_checks"]
                                   if c["kind"] == "widest_fe62" and c["kernel"] == kn)
    meas = {"keygen": (main4["keygen_check"], "config4_zipf"),
            "expand": (max((c for c in main4["expand_checks"] if c["want_children"]),
                           key=lambda c: c["B"]), "config4_zipf")}
    for kn in OT2S:
        meas[kn] = (widest("config4_zipf_secure", kn), "config4_zipf_secure")
    for kn in GC:
        meas[kn] = (widest("rides_secure_gc", kn), "rides_secure_gc")
    rows = []
    for kn, (_, _, source, replaces) in KERNELS.items():
        m, cell = meas[kn]
        sock = {f"{c}/{who}": report["sockets"][c]["launches"][who][kn]
                for c in report["sockets"] for who in ("server0", "server1")}
        log(f"kernel {kn}: cell={cell} ms={m['ms']:.4f} plain_ms={m['plain_ms']:.4f} "
            f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
            f"launches={ {c: launches[c][kn] for c in launches} } socket_launches={sock} "
            f"checks={len(errs[kn])} max_abs_err={max(errs[kn])}")
        rows.append({"name": kn, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[cell][kn], "max_abs_err": max(errs[kn]),
                     "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"], "library_ms": None})
        if kn == "expand":  # the streamed path's inputs, under the same launch counter
            rows[-1]["stream_checks"] = [
                {k: c[k] for k in ("kind", "level", "F", "want_children", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms")}
                for c in report["crawls"]["config4_zipf_stream"]["stream_checks"]]
            rows[-1]["stream_launches"] = launches["config4_zipf_stream"][kn]
            rows[-1]["radix_checks"] = [
                {k: c[k] for k in ("kind", "level", "r", "F", "want_children", "max_abs_err",
                                   "ms", "kernel_ms", "plain_ms", "bound_ms")}
                for c in report["crawls"]["config4_zipf_radix3"]["radix_checks"]]
            rows[-1]["radix_launches"] = launches["config4_zipf_radix3"][kn]
            rows[-1]["restored_check"] = report["sockets"]["rides_socket_supervised_kill"][
                "restored_check"]
            rows[-1]["malicious_restored_check"] = report["sockets"][
                "secure_malicious_socket"]["restored_check"]
        if kn == "keygen":  # data_len 32, at phase 21's K
            rows[-1]["malicious_keygen_check"] = report["sockets"]["zipf_malicious_socket"][
                "keygen_check"]
        if kn in OT2S:
            rows[-1]["malicious_checks"] = [
                c for c in report["crawls"]["secure_malicious_replay"]["secure_checks"]
                if c["kernel"] == kn]
        # phases 22-26: launches on the mesh (per process in phase 25) and
        # the kernel held on a shard's inputs
        rows[-1]["mesh_launches"] = {c: launches[c][kn] for c in (
            "config4_mesh", "rides_mesh_secure", "rides_mesh_secure_gc", "rides_mesh_supervised")}
        for c in ("rides_mesh_2proc", "rides_mesh_2proc_secure"):
            rows[-1]["mesh_launches"][c] = [p["launches"][kn]
                                            for p in report["mesh"][c]["processes"]]
        rows[-1]["mesh_checks"] = (
            [{k: c[k] for k in ("kind", "level", "F", "max_abs_err", "ms", "plain_ms",
                                "bound_ms")}
             for c in report["mesh"]["config4_mesh"]["expand_checks"]] if kn == "expand" else
            [{k: c[k] for k in ("kind", "level", "S", "W", "bp", "max_abs_err", "ms",
                                "plain_ms", "bound_ms")}
             for cell in ("rides_mesh_secure", "rides_mesh_secure_gc")
             for c in report["mesh"][cell].get("secure_checks", ()) if c["kernel"] == kn])
        # phases 27-31: launches per server process with four data shards, and
        # K3 (the row-sharded kernel stage) held per shard at phases 28-29
        rows[-1]["sharded_launches"] = {
            c: [report["sockets"][c]["launches"][w][kn] for w in ("server0", "server1")]
            for c in ("rides_socket_sharded", "rides_secure_socket_sharded",
                      "rides_secure_socket_radix2_sharded", "zipf_malicious_socket_sharded",
                      "rides_socket_sharded_device_kill")}
        # phases 32-34: launches per server process of the windowed runs (phase
        # 33: the new server 1; its crawl verbs include the re-run crawl)
        rows[-1]["windowed_launches"] = {
            c: [report["sockets"][c]["launches"][w][kn] for w in ("server0", "server1")]
            for c in ("rides_socket_windows", "rides_socket_windows_drill",
                      "zipf_malicious_socket_windows")}
        # phases 35-37: launches per server process of the collections' runs
        # (phase 37: the new server 1)
        rows[-1]["tenant_launches"] = {
            c: [report["sockets"][c]["launches"][w][kn] for w in ("server0", "server1")]
            for c in ("rides_socket_tenants", "rides_secure_socket_tenants",
                      "rides_socket_tenant_isolation")}
        # phases 38-40: launches per server process of the fleet's pairs (the
        # source pair's, killed in phase 40, are not known), and keygen's in
        # the script, the leader (phase 40 reuses phase 38's keys)
        rows[-1]["fleet_launches"] = {
            c: {who: (ls or {}).get(kn) for who, ls in f["launches"].items()}
            | ({"leader": f["leader_keygen_launches"]} if kn == "keygen" else {})
            for c, f in report["fleet"].items()}
        # phase 41: launches per server process of the observed run, and the
        # leader process's keygen
        obs41 = report["sockets"]["rides_secure_socket_observed"]
        rows[-1]["observed_launches"] = (
            {w: obs41["launches"][w][kn] for w in ("server0", "server1")}
            | ({"leader": obs41["leader_keygen_launches"]} if kn == "keygen" else {}))
        # phase 42: launches per server process of the sanitized, scraped run
        live42 = report["sockets"]["rides_secure_socket_live"]
        rows[-1]["live_launches"] = (
            {w: live42["launches"][w][kn] for w in ("server0", "server1")}
            | ({"leader": live42["leader_keygen_launches"]} if kn == "keygen" else {}))
        if kn not in ("keygen", "expand"):
            rows[-1]["k3_checks"] = [
                {k: c[k] for k in ("kind", "level", "shard", "S", "W", "bp", "max_abs_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by")}
                for cell in ("rides_secure_socket_sharded", "rides_secure_socket_radix2_sharded")
                for c in report["sockets"][cell]["k3_checks"] if c["kernel"] == kn]
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    log(f"chip_smoke wall_s={report['wall_s']:.1f} (build, checks, ten crawls, a resume, "
        "twenty-five socket runs, three fleet runs and six mesh runs)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        POOL.close()
    sys.exit(rc)
