"""fhh-race: interprocedural asyncio lock-discipline + await-atomicity
analysis.

The 2PC transcript is bit-identical only because both servers execute
verbs in frame-arrival order under a strict lock discipline — and since
the pipelined crawl the same bug class has kept coming back, caught by
hand: shared server/driver state read before an ``await`` and mutated
after, or touched outside its owning lock (the stale-window-id read and
the half-mirrored-seal interleave of the streaming front door, the
ingest-only-checkpoint recovery hole of the multi-chip refactor).  The
intra-function rules structurally cannot see it; these two can:

- ``guarded-state-unlocked`` — an access to a **guarded attribute**
  (the declared guard map binds each shared attribute to its owning
  lock) at a program point where the lock-held set does not contain the
  owner.  The held set is computed interprocedurally: lexical
  ``with``/``async with`` blocks on known locks, plus entry-lock sets
  propagated through the module call graph (a helper called only from
  inside lock blocks inherits them), plus declared dispatch contracts
  (``# fhh-race: holds=<lock>`` for verbs reached via dynamic dispatch
  under a lock the analyzer cannot see).
- ``stale-read-across-await`` — a guarded value bound to a local, then
  a **suspension point** (an ``await``, an ``async with`` lock acquire,
  an ``async for`` step) at which the owning lock was released or never
  held, then a use of the local: the stale-window-id shape.
  A lock held *across* the await (asyncio locks stay held through
  suspension) keeps the snapshot fresh and is clean.

Guard map sources (merged):

- ``[tool.fhh-lint.guards]`` in lint_torch.toml — keys are
  ``"ClassName.attr"`` (checked on ``self.attr`` accesses in that
  class's methods, any file in ``race_modules``); values name the
  owning lock attribute.
- inline ``# fhh-guard: <attr>=<lock>`` — inside a class body binds
  ``self.<attr>`` for that class; at module level binds the module
  global ``<attr>`` to the module-level lock ``<lock>``.

Approximations, by design (this is a linter, not a model checker): call
resolution is name-based within one module (``self.m()`` resolves to the
enclosing class's method, bare ``f()`` to a module function; anything
else is unresolved and contributes no locks), construction code
(``__init__``/``__post_init__``/module top level) is exempt, and
``holds=`` annotations are *declared contracts*, validated dynamically
by the runtime sanitizer (:mod:`fuzzyheavyhitters_torch.utils.guards`,
``FHH_DEBUG_GUARDS=1``) riding the e2e chaos suites.

Deliberately-unlocked sites declare ``# fhh-race: atomic (reason)`` on
the def: the safety argument for the lock-free ingest fast path, the
frame-arrival pre-expand, and the session table is event-loop atomicity
(they never suspend, so no task interleaves), and the annotation makes
that argument CHECKED — the analyzer verifies the function has no
suspension point and flags the contract the moment someone adds an
``await``.  At runtime the same sites run inside
``guards.unguarded(reason)`` windows, the dynamic twin of the written
justification.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize

from .engine import Rule, SourceModule, dotted_name, last_segment

# annotation grammar (same placement rules as fhh-lint suppressions: on
# the line itself, or standing alone on the line above the code it
# binds to — blank/comment lines between are skipped)
_HOLDS_RE = re.compile(
    r"#\s*fhh-race:\s*holds=([A-Za-z_][A-Za-z0-9_]*"
    r"(?:\s*,\s*[A-Za-z_][A-Za-z0-9_]*)*)"
)
# `# fhh-race: atomic (reason)` on a def: this function touches guarded
# state WITHOUT the owning lock, and its safety argument is event-loop
# atomicity — it never suspends, so no other task can interleave.  The
# annotation is a CHECKED contract, not a suppression: the analyzer
# verifies the function body has no suspension point (await / async
# with / async for / async-generator yield) and flags any that appears,
# so the justification cannot silently rot when someone adds an await.
_ATOMIC_RE = re.compile(r"#\s*fhh-race:\s*atomic\b")
_GUARD_RE = re.compile(
    r"#\s*fhh-guard:\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*"
    r"([A-Za-z_][A-Za-z0-9_]*)"
)

_LOCK_CTOR_SEGS = {"Lock", "RLock"}
_CTOR_FNS = ("__init__", "__post_init__")


def _annotation_lines(text: str, regex: re.Pattern) -> dict[int, list]:
    """lineno -> list of regex match groups bound there.  A comment
    sharing a line with code binds to that line; a standalone comment
    binds to the next CODE line (so a `# fhh-race: holds=...` above an
    ``async def`` annotates the def)."""
    out: dict[int, list] = {}
    lines = text.splitlines()

    def next_code_line(after: int) -> int:
        for i in range(after, len(lines)):
            stripped = lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i + 1
        return after + 1

    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = regex.search(tok.string)
            if m is None:
                continue
            line = tok.start[0]
            if tok.line[: tok.start[1]].strip() == "":
                line = next_code_line(line)
            out.setdefault(line, []).append(m.groups())
    except tokenize.TokenError:
        pass
    return out


def _mentions_lock_ctor(node: ast.AST) -> bool:
    """True when ``node`` constructs a lock: ``asyncio.Lock()``,
    ``threading.RLock()``, or a dataclass ``field(default_factory=
    asyncio.Lock)``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            seg = last_segment(dotted_name(n.func))
            if seg in _LOCK_CTOR_SEGS:
                return True
            if seg == "field":
                for kw in n.keywords:
                    if kw.arg == "default_factory":
                        if (
                            last_segment(dotted_name(kw.value))
                            in _LOCK_CTOR_SEGS
                        ):
                            return True
    return False


class _Fn:
    """One function/method in the module."""

    __slots__ = ("node", "qual", "cls", "holds", "atomic", "callsites",
                 "entry", "_shadowed")

    def __init__(self, node, qual: str, cls: str | None, holds, atomic):
        self.node = node
        self.qual = qual
        self.cls = cls
        self.holds = holds  # frozenset | None (declared entry contract)
        self.atomic = atomic  # bool: declared event-loop-atomic
        self.callsites: list = []  # (caller_qual, lexical_held) pairs
        self.entry: frozenset = frozenset()
        self._shadowed: set | None = None  # lazy _fn_locals_without_global

    @property
    def shadowed(self) -> set:
        """This scope's local bindings (memoized: the unlocked-global
        check consults it per Name access — a fresh scope walk per
        access is O(accesses x function size))."""
        if self._shadowed is None:
            self._shadowed = _fn_locals_without_global(self.node)
        return self._shadowed


class _RaceInfo:
    """Everything both rules need, computed once per module."""

    __slots__ = (
        "locks", "class_guards", "module_guards", "fns", "fn_of_node",
        "class_of_fn",
    )


def _guard_maps(mod: SourceModule, cfg, class_spans):
    """(class_guards {cls: {attr: lock}}, module_guards {name: lock})
    from the config table plus inline ``# fhh-guard`` annotations."""
    class_guards: dict[str, dict] = {}
    module_guards: dict[str, str] = {}
    for key, lock in getattr(cfg, "guards", {}).items():
        if not isinstance(key, str) or not isinstance(lock, str):
            continue
        if "." in key:
            cls, attr = key.split(".", 1)
            class_guards.setdefault(cls, {})[attr] = lock
        # a dotless config key would apply to EVERY module in scope —
        # module-level guards are inline-only, where they name one file
    for line, entries in _annotation_lines(mod.text, _GUARD_RE).items():
        owner = None
        for cls, (lo, hi) in class_spans.items():
            if lo < line <= hi:  # inside the class body (below the def)
                owner = cls
                break
        for attr, lock in entries:
            if owner is not None:
                class_guards.setdefault(owner, {})[attr] = lock
            else:
                module_guards[attr] = lock
    return class_guards, module_guards


def _lexical_held(mod: SourceModule, node: ast.AST, locks: set) -> frozenset:
    """Locks held by ``with``/``async with`` blocks lexically enclosing
    ``node``, up to the nearest function boundary (lambdas pass
    through — they execute in the enclosing context here)."""
    held = set()
    for a in mod.ancestors(node):
        if isinstance(a, (ast.With, ast.AsyncWith)):
            held |= _with_locks(a, locks)
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
    return frozenset(held)


def _with_locks(w, locks: set) -> set:
    out = set()
    for item in w.items:
        for n in ast.walk(item.context_expr):
            if isinstance(n, ast.Name) and n.id in locks:
                out.add(n.id)
            elif isinstance(n, ast.Attribute) and n.attr in locks:
                out.add(n.attr)
    return out


def analyze(mod: SourceModule, cfg) -> _RaceInfo:
    """Build (and cache on ``mod``) the module's race-analysis state:
    lock inventory, guard maps, function table, and the entry-lock
    fixpoint over the module call graph."""
    cached = getattr(mod, "_fhh_race_info", None)
    if cached is not None and cached[0] is cfg:
        return cached[1]
    info = _RaceInfo()

    # -- classes + their line spans (inline guard attribution) ----------
    class_spans: dict[str, tuple] = {}
    class_of_fn: dict[int, str] = {}  # id(fn node) -> class name
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            class_spans[node.name] = (
                node.lineno, getattr(node, "end_lineno", node.lineno)
            )
            for child in node.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_of_fn[id(child)] = node.name

    info.class_guards, info.module_guards = _guard_maps(
        mod, cfg, class_spans
    )

    # -- lock inventory ---------------------------------------------------
    locks: set[str] = set()
    for stmt in mod.tree.body:  # module-level lock objects
        targets = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        if _mentions_lock_ctor(value):
            locks.update(
                t.id for t in targets if isinstance(t, ast.Name)
            )
    for node in ast.walk(mod.tree):  # class/instance lock attributes
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if value is None or not _mentions_lock_ctor(value):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    locks.add(t.id)
                elif isinstance(t, ast.Attribute):
                    locks.add(t.attr)
    for guards in info.class_guards.values():  # declared owners count too
        locks.update(guards.values())
    locks.update(info.module_guards.values())

    # -- function table + holds/atomic annotations ------------------------
    holds_by_line = _annotation_lines(mod.text, _HOLDS_RE)
    atomic_lines = _annotation_lines(mod.text, _ATOMIC_RE)
    fns: dict[str, _Fn] = {}
    fn_of_node: dict[int, _Fn] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = class_of_fn.get(id(node))
        qual = f"{cls}.{node.name}" if cls else node.name
        holds = None
        for groups in holds_by_line.get(node.lineno, []):
            names = {s.strip() for s in groups[0].split(",") if s.strip()}
            holds = frozenset(names) if holds is None else holds | names
            locks.update(names)
        fn = _Fn(node, qual, cls, holds, node.lineno in atomic_lines)
        # first definition wins on a name collision (rare; documented)
        fns.setdefault(qual, fn)
        fn_of_node[id(node)] = fns[qual]
    info.locks = locks
    info.fns = fns
    info.fn_of_node = fn_of_node
    info.class_of_fn = class_of_fn

    # -- call graph: (callee) <- (caller, lexical locks at the site) ------
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = mod.enclosing_functions(node)
        caller = fn_of_node.get(id(chain[0])) if chain else None
        callee = None
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")
            and caller is not None
            and caller.cls is not None
        ):
            callee = fns.get(f"{caller.cls}.{f.attr}")
        elif isinstance(f, ast.Name):
            callee = fns.get(f.id)
        if callee is None:
            continue
        lex = _lexical_held(mod, node, locks)
        callee.callsites.append((caller.qual if caller else None, lex))

    # -- entry-lock fixpoint ----------------------------------------------
    all_locks = frozenset(locks)
    for fn in fns.values():
        if fn.holds is not None:
            fn.entry = fn.holds  # declared contract wins (sanitizer-checked)
        elif fn.callsites:
            fn.entry = all_locks  # start at top, meet downward
        else:
            fn.entry = frozenset()  # public entry point: nothing held
    changed = True
    while changed:
        changed = False
        for fn in fns.values():
            if fn.holds is not None or not fn.callsites:
                continue
            new = None
            for caller_qual, lex in fn.callsites:
                held = lex | (
                    fns[caller_qual].entry if caller_qual in fns else frozenset()
                )
                new = held if new is None else (new & held)
            if new != fn.entry:
                fn.entry = new
                changed = True

    mod._fhh_race_info = (cfg, info)
    return info


def _in_scope(mod: SourceModule, cfg) -> bool:
    prefixes = getattr(cfg, "race_modules", ())
    return any(
        mod.relpath == p or mod.relpath.startswith(p.rstrip("/") + "/")
        for p in prefixes
    )


def _span(node: ast.AST):
    return node.lineno, getattr(node, "end_lineno", node.lineno)


def _suspension_points(fn_node) -> list:
    """(lineno, kind) for every suspension point in the function's OWN
    body — awaits, async-with acquires, async-for steps, and async-
    generator yields.  Nested defs/lambdas are excluded: they run in
    their own execution context, not inline."""
    out: list = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(child, ast.Await):
                out.append((child.lineno, "await"))
            elif isinstance(child, ast.AsyncWith):
                out.append((child.lineno, "async with"))
            elif isinstance(child, ast.AsyncFor):
                out.append((child.lineno, "async for"))
            elif isinstance(child, (ast.Yield, ast.YieldFrom)) and isinstance(
                fn_node, ast.AsyncFunctionDef
            ):
                out.append((child.lineno, "yield"))
            walk(child)

    walk(fn_node)
    return out


def _fn_locals_without_global(fn) -> set[str]:
    """Names the function binds locally (so a same-named module global is
    shadowed, not accessed) — THIS scope's assignment targets and
    parameters minus `global` decls.  Nested def/lambda subtrees are
    skipped (their bindings live in their own scope and shadow nothing
    out here — an `ast.walk` would sweep them in and exempt an outer
    unlocked global read behind an inner parameter); the nested def's
    NAME itself does bind here and counts."""
    decls: set[str] = set()
    assigned: set[str] = {
        a.arg for a in ast.walk(fn.args) if isinstance(a, ast.arg)
    }

    def scope_walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                assigned.add(child.name)
                continue  # inner scope: its bindings are not ours
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, ast.Global):
                decls.update(child.names)
            elif isinstance(child, ast.Name) and isinstance(
                child.ctx, (ast.Store, ast.Del)
            ):
                assigned.add(child.id)
            scope_walk(child)

    scope_walk(fn)
    return assigned - decls


class GuardedStateUnlocked(Rule):
    """Guard-map violations: a ``self.<attr>`` access in a method of the
    attribute's class (or a module-global access) at a point where the
    owning lock is provably absent from the interprocedural held set."""

    name = "guarded-state-unlocked"
    default_severity = "error"

    def check(self, mod: SourceModule, cfg):
        if not _in_scope(mod, cfg):
            return
        info = analyze(mod, cfg)
        # atomic contracts verify even with no guard map: the annotation
        # asserts no-suspension, and a rotted assertion must flag
        for fn in info.fns.values():
            if not fn.atomic:
                continue
            for lineno, kind in _suspension_points(fn.node):
                yield (
                    lineno, lineno,
                    f"'{fn.qual}' is declared `# fhh-race: atomic` "
                    f"(event-loop-atomic, lock-free by justification) but "
                    f"contains a suspension point ({kind}) — another task "
                    "can now interleave mid-function; hold the owning "
                    "lock instead, or hoist the suspension out",
                )
        if not info.class_guards and not info.module_guards:
            return
        for node in ast.walk(mod.tree):
            hit = self._guarded_access(mod, info, node)
            if hit is None:
                continue
            fn, owner, lock, label = hit
            if fn.atomic:
                # declared event-loop-atomic (and verified suspension-free
                # above): lock-free access is the documented design
                continue
            held = fn.entry | _lexical_held(mod, node, info.locks)
            if lock in held:
                continue
            contract = (
                "hold it around the access, have every caller hold it "
                "(the call graph propagates), declare the dispatch "
                "contract with `# fhh-race: holds=...`, or suppress "
                "with a written justification"
            )
            yield (
                *_span(node),
                f"guarded state '{label}' accessed in '{fn.qual}' "
                f"without its owning lock '{lock}' held — {contract}",
            )

    @staticmethod
    def _guarded_access(mod, info, node):
        """(fn, owner, lock, label) when ``node`` is a guarded access in
        checkable scope; None otherwise.  Construction code is exempt."""
        if isinstance(node, ast.Attribute):
            if not (
                isinstance(node.value, ast.Name) and node.value.id == "self"
            ):
                return None
            chain = mod.enclosing_functions(node)
            if not chain:
                return None
            fn = info.fn_of_node.get(id(chain[0]))
            if fn is None or fn.cls is None:
                return None
            if fn.node.name in _CTOR_FNS:
                return None
            lock = info.class_guards.get(fn.cls, {}).get(node.attr)
            if lock is None or node.attr == lock:
                return None
            return fn, fn.cls, lock, f"{fn.cls}.{node.attr}"
        if isinstance(node, ast.Name) and node.id in info.module_guards:
            chain = mod.enclosing_functions(node)
            if not chain:
                return None  # module-level init is construction
            fn = info.fn_of_node.get(id(chain[0]))
            if fn is None:
                return None
            if node.id in fn.shadowed:
                return None  # a local shadows the module global
            lock = info.module_guards[node.id]
            if node.id == lock:
                return None
            return fn, None, lock, node.id
        return None


class _Taint:
    __slots__ = ("field", "lock", "line", "crossed", "reported_lines")

    def __init__(self, field, lock, line):
        self.field, self.lock, self.line = field, lock, line
        self.crossed = False
        # every stale USE line reports (dedup per line, not per taint):
        # a one-taint flag would let a suppression on the FIRST use
        # silently absorb every later unsuppressed use of the same local
        self.reported_lines: set[int] = set()


class StaleReadAcrossAwait(Rule):
    """The stale-window-id bug shape: a guarded value snapshotted into a local, a
    suspension point crossed while the owning lock was not held (so the
    field may have moved), then the stale local used as if fresh."""

    name = "stale-read-across-await"
    default_severity = "error"

    def check(self, mod: SourceModule, cfg):
        if not _in_scope(mod, cfg):
            return
        info = analyze(mod, cfg)
        if not info.class_guards and not info.module_guards:
            return
        for fn in info.fns.values():
            if not isinstance(fn.node, ast.AsyncFunctionDef):
                continue
            if fn.node.name in _CTOR_FNS:
                continue
            if fn.atomic:
                continue  # suspension-free by verified contract
            guards = info.class_guards.get(fn.cls, {}) if fn.cls else {}
            if not guards and not info.module_guards:
                continue
            yield from self._scan_fn(fn, guards, info)

    def _scan_fn(self, fn, guards, info):
        taints: dict[str, _Taint] = {}
        findings: list = []
        shadowed = fn.shadowed if info.module_guards else set()

        def guarded_reads(expr):
            """(field-label, lock) pairs read directly in ``expr``."""
            out = []
            for n in ast.walk(expr):
                if (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    and n.attr in guards
                ):
                    out.append((n.attr, guards[n.attr]))
                elif (
                    isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Load)
                    and n.id in info.module_guards
                    and n.id not in shadowed
                ):
                    out.append((n.id, info.module_guards[n.id]))
            return out

        def suspend(held):
            for t in taints.values():
                if t.lock not in held:
                    t.crossed = True

        def use(node):
            t = taints.get(node.id)
            if t is not None and t.crossed and node.lineno not in t.reported_lines:
                t.reported_lines.add(node.lineno)
                findings.append((
                    *_span(node),
                    f"'{node.id}' snapshots guarded '{t.field}' "
                    f"(line {t.line}) and is used after a suspension "
                    f"point crossed without '{t.lock}' held — the field "
                    "may have moved while this task slept; re-read it "
                    "under the lock after the await (the "
                    "stale-window-id shape)",
                ))

        def visit_expr(node, held):
            """Execution-ordered walk: children (argument evaluation)
            before the await's suspension."""
            if isinstance(node, ast.Await):
                visit_expr(node.value, held)
                suspend(held)
                return
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                use(node)
            if isinstance(node, ast.Lambda):
                return  # deferred execution: out of linear order
            for child in ast.iter_child_nodes(node):
                visit_expr(child, held)

        def bind_targets(stmt, held):
            reads = guarded_reads(
                stmt.value if stmt.value is not None else ast.Constant(None)
            )
            targets = (
                stmt.targets if isinstance(stmt, ast.Assign)
                else [stmt.target]
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    if reads:
                        field, lock = reads[0]
                        taints[t.id] = _Taint(field, lock, stmt.lineno)
                    else:
                        taints.pop(t.id, None)
                else:
                    # tuple/list/starred/attribute targets: every name
                    # bound here is REBOUND — its old snapshot taint is
                    # gone (conservatively untainted even when the RHS
                    # reads guarded state; a linter prefers the miss to
                    # the false positive)
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            taints.pop(n.id, None)

        def visit_stmt(stmt, held):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                if stmt.value is not None:
                    visit_expr(stmt.value, held)
                bind_targets(stmt, held)
                return
            if isinstance(stmt, ast.AugAssign):
                visit_expr(stmt.value, held)
                if isinstance(stmt.target, ast.Name):
                    use(stmt.target)  # read-modify-write reads the local
                return
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                newly = _with_locks(stmt, info.locks)
                for item in stmt.items:
                    visit_expr(item.context_expr, held)
                if isinstance(stmt, ast.AsyncWith):
                    # acquiring a contended asyncio lock suspends; the
                    # lock is NOT yet held at that point
                    suspend(held)
                inner = held | newly
                for s in stmt.body:
                    visit_stmt(s, inner)
                # NB: asyncio.Lock release is synchronous — the exit of
                # an async with is NOT a suspension point
                return
            if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    visit_expr(stmt.iter, held)
                    if isinstance(stmt, ast.AsyncFor):
                        suspend(held)
                    for t in ast.walk(stmt.target):
                        if isinstance(t, ast.Name):
                            taints.pop(t.id, None)
                else:
                    visit_expr(stmt.test, held)
                # two passes over the body: an await late in the body
                # precedes (in execution) a use early in the body on the
                # next iteration — the single-pass scan would miss it
                for _ in range(2):
                    for s in stmt.body:
                        visit_stmt(s, held)
                if isinstance(stmt, ast.While):
                    # the condition re-evaluates AFTER each body pass:
                    # `while w == self.f: await x()` compares a stale
                    # snapshot on iteration 2 (per-line dedup absorbs
                    # the pre-body visit above)
                    visit_expr(stmt.test, held)
                for s in stmt.orelse:
                    visit_stmt(s, held)
                return
            if isinstance(stmt, ast.If):
                visit_expr(stmt.test, held)
                for s in stmt.body:
                    visit_stmt(s, held)
                for s in stmt.orelse:
                    visit_stmt(s, held)
                return
            if isinstance(stmt, ast.Try):
                for s in stmt.body:
                    visit_stmt(s, held)
                for h in stmt.handlers:
                    for s in h.body:
                        visit_stmt(s, held)
                for s in stmt.orelse + stmt.finalbody:
                    visit_stmt(s, held)
                return
            # leaf statements (Expr, Return, Raise, Assert, Delete, ...)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    visit_expr(child, held)

        for s in fn.node.body:
            visit_stmt(s, fn.entry)
        yield from findings


RACE_RULES = (GuardedStateUnlocked(), StaleReadAcrossAwait())
