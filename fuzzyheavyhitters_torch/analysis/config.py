"""fhh-lint configuration: defaults + ``[tool.fhh-lint]`` in lint_torch.toml.

Schema: every :class:`LintConfig` field name is a valid ``[tool.fhh-lint]``
key (list fields as TOML string arrays, ``baseline`` as a string), plus
the ``guards``, ``taint`` and ``severity`` tables.  The checked-in
``lint_torch.toml`` at the repository root is the operative copy for the
port; the dataclass defaults below mirror it so the linter behaves
identically when pointed at a tree with no such file (a drift test in
``tests/test_torch_analysis.py`` keeps the two in sync — edit the file,
it will tell you to update here).  The reader is :mod:`tomllib`, so any
TOML file with a ``[tool.fhh-lint]`` table (a ``pyproject.toml`` too)
can be passed to :func:`load_config`.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field

# the fhh-race guard map shipped for the port (mirrored by lint_torch.toml
# [tool.fhh-lint.guards] — the drift test keeps the two in sync): each
# shared attribute of the server verb plane / windowed-ingest driver is
# bound to the asyncio lock that owns it.  Module-level globals (obs,
# native, ops/cuda_build) are bound inline via `# fhh-guard:` — a
# dotless key here would apply to every module in scope.
_DEFAULT_GUARDS = {
    # CollectionSession (protocol/sessions.py): everything one
    # collection's verb plane mutates serializes on the SESSION's own
    # _verb_lock; the deliberately-unlocked fast paths (add_keys /
    # submit_keys / the frame-arrival pre-expand / the session-table
    # bind) carry VERIFIED `# fhh-race: atomic` contracts + runtime
    # guards.unguarded() windows.
    "CollectionSession.frontier": "_verb_lock",
    "CollectionSession.keys": "_verb_lock",
    "CollectionSession.keys_parts": "_verb_lock",
    "CollectionSession.alive_keys": "_verb_lock",
    "CollectionSession.children": "_verb_lock",
    "CollectionSession.last_shares": "_verb_lock",
    "CollectionSession._shard_children": "_verb_lock",
    "CollectionSession._shard_last": "_verb_lock",
    "CollectionSession._expand_ready": "_verb_lock",
    "CollectionSession._ingest_pools": "_verb_lock",
    "CollectionSession._admission": "_verb_lock",
    "CollectionSession._sketch_parts": "_verb_lock",
    "CollectionSession._sketch_root": "_verb_lock",
    "CollectionSession._ratchet_digest": "_verb_lock",
    "CollectionSession._window_sketch_root": "_verb_lock",
    # fleet migration stamps (the session_export/session_import verbs
    # dispatch under the session's _verb_lock)
    "CollectionSession._export_epoch": "_verb_lock",
    "CollectionSession._import_seen": "_verb_lock",
    # CollectorServer infra: the replay-dedup session table
    "CollectorServer._sessions": "_verb_lock",
    # WindowedIngest: gate-order == mirror-order state serializes on
    # _submit_lock (recovery additionally takes _recover_lock INSIDE it,
    # so every journal access holds _submit_lock)
    "WindowedIngest.window": "_submit_lock",
    "WindowedIngest._journal": "_submit_lock",
    "WindowedIngest._journaled": "_submit_lock",
    "WindowedIngest._sealed": "_submit_lock",
    # FleetDirectory (protocol/fleet.py): host-pair rows + session
    # placements serialize on the directory's own asyncio lock
    "FleetDirectory._hosts": "_lock",
    "FleetDirectory._placements": "_lock",
}


# the fhh-taint source table shipped for THIS repo (mirrored by
# lint_torch.toml [tool.fhh-lint.taint] and the runtime twin
# utils/taint_guard._DEFAULT_SOURCES — both drift-tested): dotted keys
# bind attribute READS (matched by attr name, receiver-agnostic — the
# names are chosen distinctive for exactly that reason); dotless keys
# bind function-call RETURNS (matched by last segment, so
# ``secure.derive_seed(...)`` matches cross-module).  Values document
# the key material; the analyzer reports the key as the source label.
_DEFAULT_TAINT = {
    # per-session secrets (protocol/sessions.py; read through the
    # rpc/mesh delegation properties under the same attr names)
    "CollectionSession._sec_seed": "per-session GC/b2a PRG root seed",
    "CollectionSession._sketch_seed": "sketch challenge coin (server-server secret)",
    "CollectionSession._ratchet_digest": "crawl transcript ratchet digest",
    "CollectionSession.last_shares": "expanded field share planes",
    # reconstructed migration payload (protocol/rpc.py session_import
    # rebuilds every pool buffer it lands under this label)
    "CollectionSession._imported_pool_shares":
        "migrated ingest-pool key shares (session_import)",
    # ibDCF/DPF key material (protocol/sketch.py)
    "SketchKeyBatch.root_seed": "sketch DPF root seeds",
    # IKNP OT-extension endpoint state (ops/otext.py)
    "OtExtSender.s_bits": "OT sender choice bits (= free-XOR offset R)",
    "OtExtSender.s_block": "packed OT sender choice block",
    "OtExtSender._s_dev": "device copy of the OT sender choice bits",
    "OtExtSender._seeds": "base-OT seeds selected by s",
    "OtExtReceiver._seeds0": "base-OT seed column 0",
    "OtExtReceiver._seeds1": "base-OT seed column 1",
    # function-return sources
    "derive_seed": "per-(purpose, level, ctr) PRG seed off the session seed",
    "ratchet_seed": "per-level sketch challenge seed",
    "transcript_init": "transcript ratchet digest root",
    "transcript_absorb": "advanced transcript ratchet digest",
    "gen_triples": "Beaver triple shares",
    "_seed_from_point": "base-OT seed H(index, point)",
    "seeds": "base-OT seed columns (ops/baseot.py endpoints)",
}


@dataclass
class LintConfig:
    # host-sync rule: path prefixes whose loop bodies are hot, and
    # function names that ARE the per-level crawl path (their in-module
    # transitive callees inherit hotness)
    hot_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/ops",
        "fuzzyheavyhitters_torch/parallel",
    )
    hot_roots: tuple = (
        "run_level",
        "tree_crawl",
        "tree_crawl_last",
        "tree_prune",
        "tree_prune_last",
        "sketch_verify",
        "expand_share_bits",
        "expand_share_bits_from_cw",
        "advance_from_children",
        "advance_from_cw",
        # the rpc expand stage: frame-arrival dispatch, per-level work
        "_maybe_pre_expand",
    )
    # secret-to-sink rule: identifier segments naming key material (split
    # on "_"; an identifier matches when any segment is in the lexicon)
    secret_lexicon: tuple = (
        "seed",
        "seeds",
        "cw",
        "cws",
        "cwf",
        "cwv",
        "delta",
        "label",
        "labels",
        "triples",
        "mac",
        "secret",
    )
    sink_calls: tuple = ("emit", "print")
    # bare-print rule: applies under print_scope minus print_allowed
    print_scope: tuple = ("fuzzyheavyhitters_torch",)
    print_allowed: tuple = (
        "fuzzyheavyhitters_torch/workloads/ride_austin_visualization.py",
        "fuzzyheavyhitters_torch/workloads/covid_data_visualization.py",
        # the linter's own CLI: stdout IS its program-output channel
        "fuzzyheavyhitters_torch/analysis/cli.py",
        # `ops top` live screen: stdout IS the rendered view
        "fuzzyheavyhitters_torch/obs/ops.py",
    )
    # unguarded-shared-state rule: modules whose module-level mutables
    # must only be written under a registered lock
    shared_state_modules: tuple = (
        "fuzzyheavyhitters_torch/obs",
        "fuzzyheavyhitters_torch/native",
        "fuzzyheavyhitters_torch/protocol/rpc.py",
    )
    # unbounded-await rule: transport modules where every await on a
    # network read / event wait / dial must carry a timeout or deadline
    # (parallel/ included: mesh-transport awaits are transport awaits)
    await_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/resilience",
        "fuzzyheavyhitters_torch/parallel",
    )
    # chunked-device-readback rule: secure-kernel hot roots where a loop
    # of per-chunk device readbacks (incl. the sanctioned _fetch helper)
    # must never grow back — the whole-level batching this repo's
    # secure path rests on.  parallel/ (both mesh paths: a readback loop
    # there fetches once per SHARD) and protocol/rpc.py (the crawl
    # verbs' expand/open stages) joined the scope with the multi-chip
    # refactor.
    # protocol/sketch.py + protocol/mpc.py joined with the fused
    # malicious verify: the old chunked sketch_batch_size loop form
    # (per-chunk cor/out fetches) is exactly what this rule exists to
    # keep from growing back.
    readback_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol/secure.py",
        "fuzzyheavyhitters_torch/protocol/rpc.py",
        "fuzzyheavyhitters_torch/protocol/sketch.py",
        "fuzzyheavyhitters_torch/protocol/mpc.py",
        "fuzzyheavyhitters_torch/ops",
        "fuzzyheavyhitters_torch/parallel",
    )
    # unbounded-queue rule: ingest/transport modules where every
    # producer/consumer buffer (asyncio.Queue, deque) must carry a
    # maxsize/maxlen bound — the overload-never-OOMs invariant of the
    # streaming front door
    queue_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/resilience",
    )
    # span-discipline rule: modules where obs spans must be context
    # managers and emit()/observe() telemetry must stay out of
    # jit-traced bodies (the obs layer itself + its heaviest consumers)
    span_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/obs",
        "fuzzyheavyhitters_torch/parallel",
    )
    # metric-naming rule: modules where registry metric names (literal
    # first args of the metric_calls methods) must be valid Prometheus
    # identifier chunks — lowercase ``[a-z][a-z0-9_]*`` with optional
    # ``:sub`` parts (the exporter folds a colon into a ``key`` label) —
    # and where a full ``fhh_...`` exported-series literal must end with
    # a recognized unit suffix (Prometheus consumers key on the unit
    # token; obs/exporter.py appends _total/_seconds itself, so only
    # hand-rolled exposition literals need the suffix spelled out)
    metric_modules: tuple = (
        "fuzzyheavyhitters_torch/obs",
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/parallel",
        "tests",
    )
    metric_calls: tuple = ("count", "gauge", "observe", "timer_add")
    metric_unit_suffixes: tuple = (
        "_total",
        "_seconds",
        "_bytes",
        "_bucket",
        "_sum",
        "_count",
        "_info",
        "_ratio",
        "_keys",
        "_shards",
        "_entries",
        "_epoch",
        "_active",
    )
    # fhh-race rules (analysis/concurrency.py): modules whose asyncio
    # lock discipline is analyzed interprocedurally — the server verb
    # plane, the driver/ingest plane, and the threading-locked obs/
    # native/compile-cache globals the guard annotations live in
    race_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/resilience",
        "fuzzyheavyhitters_torch/obs",
        "fuzzyheavyhitters_torch/native",
        "fuzzyheavyhitters_torch/ops/cuda_build.py",
    )
    # fhh-race guard map: "ClassName.attr" -> owning lock attribute.
    # The operative copy lives in lint_torch.toml [tool.fhh-lint.guards];
    # the runtime twin maps (sessions._SESSION_GUARDS, rpc._SERVER_GUARDS,
    # leader_rpc._INGEST_GUARDS, fleet._FLEET_GUARDS) are drift-tested
    # against it in tests/test_torch_concurrency.py.
    guards: dict = field(
        default_factory=lambda: dict(_DEFAULT_GUARDS)
    )
    # fhh-taint rules (analysis/taint.py): modules whose secret flows
    # are analyzed interprocedurally — the protocol planes where the
    # sources live, and the obs plane where the sinks live
    taint_modules: tuple = (
        "fuzzyheavyhitters_torch/protocol",
        "fuzzyheavyhitters_torch/ops",
        "fuzzyheavyhitters_torch/parallel",
        "fuzzyheavyhitters_torch/obs",
    )
    # fhh-taint source table: "Class.attr" -> attribute-read sources,
    # "fn" -> call-return sources.  Operative copy: lint_torch.toml
    # [tool.fhh-lint.taint]; runtime twin: utils/taint_guard.
    taint: dict = field(
        default_factory=lambda: dict(_DEFAULT_TAINT)
    )
    # sink boundaries: the obs emit/trace/alert/metric call names taint
    # must never reach (exception messages are always sinks)
    taint_sinks: tuple = (
        "emit",
        "print",
        "instant",
        "span",
        "call_event",
        "fire",
        "_fire",
        "count",
        "gauge",
        "observe",
        "timer_add",
    )
    # wire boundaries for unmasked-wire: the frame-send entry points
    taint_wire_calls: tuple = ("_send", "_dp_send")
    # declared declassifiers: masking/opening operations whose output
    # is public by protocol argument — pad-XOR encryptions, share
    # openings, one-way commitments.  `declassified(reason)` contracts
    # must name one of these (and the analyzer checks it is called).
    taint_declassifiers: tuple = (
        "ot2s_encrypt",
        "ot2s_encrypt_packed",
        "ot4_encrypt",
        "b2a_encrypt",
        "ev_open_ot4",
        "ev_open_level",
        "ev_open_fused",
        "window_root",
        "np_add",
    )
    severity_overrides: dict = field(default_factory=dict)
    baseline: str = "lint_baseline_torch.json"
    # the port's package, its tests and its scripts (glob patterns are
    # expanded from the repository root)
    default_paths: tuple = (
        "fuzzyheavyhitters_torch",
        "tests/test_torch_*.py",
        "tests/torch_*.py",
        "chip_smoke.py",
        "scripts/live_cost.py",
        "scripts/socket_ab.py",
        "scripts/nvcc_split_check.py",
        "scripts/gc_ab.py",
        "scripts/ot2s_ab.py",
        "scripts/kernel_ab.py",
        "scripts/ot2s_sector_probe.py",
    )


CONFIG_FILE = "lint_torch.toml"


def find_repo_root(start: str | None = None) -> str:
    """Nearest ancestor holding lint_torch.toml (else ``start`` itself)."""
    cur = os.path.abspath(start or os.getcwd())
    probe = cur
    while True:
        if os.path.exists(os.path.join(probe, CONFIG_FILE)):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            return cur
        probe = parent


def load_config(root: str | None = None, path: str | None = None) -> LintConfig:
    """Config from ``[tool.fhh-lint]`` of ``path`` (default: ``root``'s
    lint_torch.toml) merged over the defaults."""
    cfg = LintConfig()
    if path is None:
        if root is None:
            root = find_repo_root()
        path = os.path.join(root, CONFIG_FILE)
    if not os.path.exists(path):
        return cfg
    try:
        with open(path, "rb") as f:
            doc = tomllib.load(f)
    except (OSError, tomllib.TOMLDecodeError):
        return cfg
    section = doc.get("tool", {}).get("fhh-lint", {})
    if not isinstance(section, dict):
        return cfg
    for key in (
        "hot_modules",
        "hot_roots",
        "secret_lexicon",
        "sink_calls",
        "print_scope",
        "print_allowed",
        "shared_state_modules",
        "await_modules",
        "readback_modules",
        "queue_modules",
        "span_modules",
        "metric_modules",
        "metric_calls",
        "metric_unit_suffixes",
        "race_modules",
        "taint_modules",
        "taint_sinks",
        "taint_wire_calls",
        "taint_declassifiers",
        "default_paths",
    ):
        val = section.get(key)
        if isinstance(val, list):
            setattr(cfg, key, tuple(val))
    if isinstance(section.get("baseline"), str):
        cfg.baseline = section["baseline"]
    guards = section.get("guards")
    if isinstance(guards, dict):
        # the table REPLACES the default map (a merge could never retire
        # a default binding from the file alone)
        cfg.guards = {
            k: v
            for k, v in guards.items()
            if isinstance(k, str) and isinstance(v, str)
        }
    taint = section.get("taint")
    if isinstance(taint, dict):
        # same table-replaces-default semantics as guards: retiring a
        # source declaration must be possible from the file alone
        cfg.taint = {
            k: v
            for k, v in taint.items()
            if isinstance(k, str) and isinstance(v, str)
        }
    sev = section.get("severity")
    if isinstance(sev, dict):
        cfg.severity_overrides = {
            k: v for k, v in sev.items() if isinstance(v, str)
        }
    return cfg
