"""fhh-taint: interprocedural secret-flow analysis for the obs plane.

The protocol's entire point is that neither server (nor any scrape of
its `/metrics` plane, trace JSONL, alert log, or run report) ever sees
key material in the clear — yet every sink the obs layer grew is a
string builder, and the lexical ``secret-to-sink`` rule can only catch
a secret NAMED at the sink.  It cannot see a seed flow through an
assignment, a helper return, a dict, or an f-string first.  This pass
can: it seeds taint at *declared sources* and pushes it forward through
the module until it reaches a sink, a branch, or the wire.

Sources (the ``[tool.fhh-lint.taint]`` table in lint_torch.toml, mirrored
by :data:`fuzzyheavyhitters_torch.analysis.config._DEFAULT_TAINT` and the
runtime twin ``utils/taint_guard._DEFAULT_SOURCES`` — drift-tested):

- ``"ClassName.attr" = "description"`` — any attribute READ of that
  name taints (receiver-agnostic: ``cs._sec_seed`` matches the
  ``CollectionSession._sec_seed`` entry without type inference; the
  attr names are chosen distinctive for exactly this reason).
- ``"function_name" = "description"`` (no dot) — any call whose last
  segment matches returns tainted (``secure.derive_seed(...)`` matches
  a ``derive_seed`` entry, cross-module).
- inline ``# fhh-taint: source`` — on an assignment, taints its
  targets; on a ``def``, declares the function's return a source.

Propagation: assignments, augmented ops, f-strings / ``format`` /
concat, container literals and subscripts, comprehensions, method calls
on tainted receivers, a fixed set of propagating builtins
(``str``/``bytes``/``np.asarray``/...), and function calls/returns —
per-function summaries (return taint, params-that-reach-a-sink,
params-that-reach-the-wire, params-branched-on) computed to a fixpoint
over the per-module call graph, so a seed that travels through two
helper returns into an f-string into ``emit`` is still one finding.

The three rule families:

- ``secret-to-sink-flow`` — taint reaching a sink call
  (``taint_sinks``: emit / trace / alert / metric label+value) or an
  exception message (``raise`` crosses trust boundaries: RPC error
  frames, logs).  Supersedes lexical ``secret-to-sink`` in
  ``taint_modules`` (which stays on everywhere as a fast pre-filter;
  a subset test pins the supersession).
- ``secret-branch`` — ``if``/``while``/``assert``/ternary conditioned
  on a secret-derived host value: the timing-channel shape MPC code
  must never have.  ``x is None`` / ``is not None`` tests are carved
  out (presence is not content); value comparisons are not.
- ``unmasked-wire`` — taint reaching a ``taint_wire_calls`` frame send
  (``_send`` / ``_dp_send``) without passing a declared declassifier.

Declassifiers (``taint_declassifiers``): the masking/opening operations
whose OUTPUT is public by protocol argument — pad-XOR encryptions,
share openings, one-way window-root commitments.  A call to one clears
taint.  Hashing clears taint structurally (``hashlib.sha256(secret)``
is an unresolved non-propagating call), which is the right semantics:
a digest is a commitment, and the digests that ARE secrets (the
transcript ratchet) are re-declared as sources at their constructors.

Sanctioned flows carry ``# fhh-taint: declassified(reason)`` — a
CHECKED contract, not a suppression: the reason must name a declared
declassifier, and the analyzer verifies that operation is actually
called in the enclosing function, so the justification cannot rot when
the masking step is refactored away (the ``atomic`` contract's precedent).

Approximations, by design (a linter, not an information-flow prover):
call resolution is name-based within one module (``self.m()`` / bare
``f()``; anything else is unresolved), unresolved calls return
UNtainted unless a propagating builtin or a declared source — the
conservative-for-noise direction, chosen so the repo can be held at
baseline ZERO — and metadata reads (``.shape``/``.dtype``/``len()``)
are public.  The runtime twin (:mod:`fuzzyheavyhitters_torch.utils.
taint_guard`, ``FHH_DEBUG_TAINT=1``) closes the gap dynamically:
registered source buffers are byte-compared at every obs sink under
the e2e + chaos suites.
"""

from __future__ import annotations

import ast
import re

from .concurrency import _annotation_lines
from .engine import Rule, SourceModule, dotted_name, last_segment

# annotation grammar (fhh-lint placement rules: on the line itself, or
# standing alone on the line above the code it binds to)
_SOURCE_RE = re.compile(r"#\s*fhh-taint:\s*source\b")
_DECLASS_RE = re.compile(r"#\s*fhh-taint:\s*declassified\(([^)]*)\)")

# attribute reads that expose only public metadata of a secret array
_METADATA_ATTRS = {
    "shape", "dtype", "ndim", "size", "nbytes", "itemsize", "name",
}

# builtins / ubiquitous array constructors whose result carries its
# arguments' bytes (str(seed) in an f-string, np.asarray(seed), ...)
_PROPAGATING_CALLS = {
    "str", "repr", "bytes", "bytearray", "format", "hex", "oct", "bin",
    "int", "float", "bool", "list", "tuple", "set", "dict", "sorted",
    "reversed", "abs", "sum", "min", "max", "next", "iter", "zip",
    "copy", "deepcopy",
    "asarray", "array", "ascontiguousarray", "frombuffer", "stack",
    "concatenate", "copyto", "tobytes", "astype", "reshape",
}

_CTOR_FNS = ("__init__", "__post_init__")


def _in_scope(mod: SourceModule, cfg) -> bool:
    prefixes = getattr(cfg, "taint_modules", ())
    return any(
        mod.relpath == p or mod.relpath.startswith(p.rstrip("/") + "/")
        for p in prefixes
    )


def _span(node: ast.AST):
    return node.lineno, getattr(node, "end_lineno", node.lineno)


def _source_tables(cfg):
    """(attr sources {attr: label}, fn-return sources {name: label})
    from the config taint table.  Dotted keys bind attribute reads by
    the attr segment; dotless keys bind call returns by last segment."""
    attrs: dict[str, str] = {}
    fns: dict[str, str] = {}
    for key, desc in getattr(cfg, "taint", {}).items():
        if not isinstance(key, str):
            continue
        if "." in key:
            attrs[key.rsplit(".", 1)[1]] = key
        else:
            fns[key] = key + "()"
    return attrs, fns


class _TFn:
    """One function/method in the module + its flow summary."""

    __slots__ = (
        "node", "qual", "cls", "params", "declared_source",
        "ret", "sink_params", "wire_params", "branch_params",
    )

    def __init__(self, node, qual, cls, declared_source):
        self.node = node
        self.qual = qual
        self.cls = cls
        self.params = [a.arg for a in (
            node.args.posonlyargs + node.args.args + node.args.kwonlyargs
        )]
        self.declared_source = declared_source
        # summary: return-value origins (source labels + param indices),
        # and the param positions that reach a sink / the wire / a
        # branch inside this function (transitively).  The reason dicts
        # keep the FIRST discovered path per param (monotone: fixpoint
        # converges even through call-graph cycles).
        self.ret: frozenset = frozenset()
        self.sink_params: dict[int, str] = {}
        self.wire_params: dict[int, str] = {}
        self.branch_params: dict[int, int] = {}

    def summary(self):
        return (
            self.ret,
            tuple(sorted(self.sink_params)),
            tuple(sorted(self.wire_params)),
            tuple(sorted(self.branch_params)),
        )


class _TaintInfo:
    __slots__ = (
        "fns", "fn_of_node", "attr_sources", "fn_sources",
        "source_lines", "declass_lines", "findings",
    )


def _is_secret(origins) -> bool:
    """True when the origin set contains a declared source (vs only
    param positions, which matter to summaries, not findings)."""
    return any(isinstance(o, str) for o in origins)


def _secret_label(origins) -> str:
    labels = sorted(o for o in origins if isinstance(o, str))
    return labels[0] if labels else "?"


def _param_origins(origins):
    return [o for o in origins if isinstance(o, int)]


class _FnWalker:
    """Execution-ordered walk of one function (or the module body):
    evaluates expression taint, applies callee summaries, and records
    sink/wire/branch hits.  ``collect`` toggles finding emission (off
    during fixpoint passes, on for the final reporting pass)."""

    def __init__(self, info: _TaintInfo, cfg, fn: _TFn | None, collect: bool):
        self.info = info
        self.cfg = cfg
        self.fn = fn
        self.collect = collect
        self.env: dict[str, frozenset] = {}
        self.ret: set = set()
        self.sink_params: dict[int, str] = {}
        self.wire_params: dict[int, str] = {}
        self.branch_params: dict[int, int] = {}
        self.findings: list = []
        self.sinks = set(getattr(cfg, "taint_sinks", ()))
        self.wires = set(getattr(cfg, "taint_wire_calls", ()))
        self.declass = set(getattr(cfg, "taint_declassifiers", ()))
        if fn is not None:
            for i, name in enumerate(fn.params):
                if name in ("self", "cls"):
                    continue
                self.env[name] = frozenset((i,))

    # -- findings ---------------------------------------------------------

    def _report(self, kind: str, node: ast.AST, message: str):
        if self.collect:
            self.findings.append((kind, *_span(node), message))

    def _sink_hit(self, node, origins, sink_desc: str, kind: str):
        """Taint arrived at a sink/wire boundary: a declared-source
        origin is a finding here; a param origin becomes part of this
        function's summary (the finding then surfaces at the call
        site that feeds it a secret)."""
        if _is_secret(origins):
            if kind == "unmasked-wire":
                self._report(
                    kind, node,
                    f"value derived from declared source "
                    f"'{_secret_label(origins)}' reaches the wire via "
                    f"{sink_desc} without passing a declared "
                    "declassifier (pad-XOR / share-opening / "
                    "window-root commitment) — mask or open it first, "
                    "or annotate the sanctioned path with "
                    "`# fhh-taint: declassified(<op>)`",
                )
            else:
                self._report(
                    kind, node,
                    f"value derived from declared source "
                    f"'{_secret_label(origins)}' flows into "
                    f"{sink_desc} — key material must never reach "
                    "logs, metrics, traces, alerts, or exception "
                    "messages",
                )
        store = self.sink_params if kind == "secret-to-sink-flow" else (
            self.wire_params
        )
        for p in _param_origins(origins):
            store.setdefault(p, sink_desc)

    def _branch_hit(self, node, origins, what: str):
        if _is_secret(origins):
            self._report(
                "secret-branch", node,
                f"{what} conditioned on a value derived from declared "
                f"source '{_secret_label(origins)}' — a host branch on "
                "secret data is a timing channel (and forces a device "
                "sync); compute both paths data-parallel, or annotate "
                "a protocol-sanctioned opening with "
                "`# fhh-taint: declassified(<op>)`",
            )
        for p in _param_origins(origins):
            self.branch_params.setdefault(p, node.lineno)

    # -- expression evaluation -------------------------------------------

    def ev(self, node) -> frozenset:
        if node is None or isinstance(node, ast.Constant):
            return frozenset()
        if isinstance(node, ast.Name):
            return self.env.get(node.id, frozenset())
        if isinstance(node, ast.Attribute):
            label = None
            if isinstance(node.ctx, ast.Load):
                label = self.info.attr_sources.get(node.attr)
            if label is not None:
                return frozenset((label,))
            base = self.ev(node.value)
            if node.attr in _METADATA_ATTRS:
                return frozenset()
            return base
        if isinstance(node, ast.Call):
            return self._ev_call(node)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` expose presence, not
            # content — the standard guard shape all over the verb
            # plane must not read as a timing channel
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                for c in [node.left, *node.comparators]:
                    self.ev(c)
                return frozenset()
            out = self.ev(node.left)
            for c in node.comparators:
                out |= self.ev(c)
            return out
        if isinstance(node, (ast.BinOp,)):
            return self.ev(node.left) | self.ev(node.right)
        if isinstance(node, ast.BoolOp):
            out = frozenset()
            for v in node.values:
                out |= self.ev(v)
            return out
        if isinstance(node, ast.UnaryOp):
            return self.ev(node.operand)
        if isinstance(node, ast.IfExp):
            self._branch_hit(node, self.ev(node.test), "a ternary")
            return self.ev(node.body) | self.ev(node.orelse)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            out = frozenset()
            for e in node.elts:
                out |= self.ev(e)
            return out
        if isinstance(node, ast.Dict):
            out = frozenset()
            for k in node.keys:
                if k is not None:
                    out |= self.ev(k)
            for v in node.values:
                out |= self.ev(v)
            return out
        if isinstance(node, ast.Subscript):
            return self.ev(node.value) | self.ev(node.slice)
        if isinstance(node, ast.Slice):
            return (
                self.ev(node.lower) | self.ev(node.upper) | self.ev(node.step)
            )
        if isinstance(node, ast.JoinedStr):
            out = frozenset()
            for v in node.values:
                out |= self.ev(v)
            return out
        if isinstance(node, ast.FormattedValue):
            out = self.ev(node.value)
            if node.format_spec is not None:
                out |= self.ev(node.format_spec)
            return out
        if isinstance(node, ast.Starred):
            return self.ev(node.value)
        if isinstance(node, ast.Await):
            return self.ev(node.value)
        if isinstance(node, ast.NamedExpr):
            origins = self.ev(node.value)
            if isinstance(node.target, ast.Name):
                self.env[node.target.id] = origins
            return origins
        if isinstance(
            node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)
        ):
            return self._ev_comp(node)
        if isinstance(node, ast.Lambda):
            return frozenset()  # deferred body: out of linear order
        # conservative default: union over child expressions
        out = frozenset()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out |= self.ev(child)
        return out

    def _ev_comp(self, node) -> frozenset:
        saved = dict(self.env)
        for gen in node.generators:
            src = self.ev(gen.iter)
            for t in ast.walk(gen.target):
                if isinstance(t, ast.Name):
                    self.env[t.id] = src
            for cond in gen.ifs:
                self._branch_hit(
                    node, self.ev(cond), "a comprehension filter"
                )
        if isinstance(node, ast.DictComp):
            out = self.ev(node.key) | self.ev(node.value)
        else:
            out = self.ev(node.elt)
        self.env = saved
        return out

    def _resolve(self, call: ast.Call) -> _TFn | None:
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")
            and self.fn is not None
            and self.fn.cls is not None
        ):
            return self.info.fns.get(f"{self.fn.cls}.{f.attr}")
        if isinstance(f, ast.Name):
            return self.info.fns.get(f.id)
        return None

    def _ev_call(self, call: ast.Call) -> frozenset:
        seg = last_segment(dotted_name(call.func)) or ""
        arg_origins = [self.ev(a) for a in call.args]
        kw_origins = {kw.arg: self.ev(kw.value) for kw in call.keywords}
        all_args = frozenset().union(*arg_origins, *kw_origins.values()) \
            if (arg_origins or kw_origins) else frozenset()
        recv = frozenset()
        if isinstance(call.func, ast.Attribute):
            recv = self.ev(call.func.value)

        # sink / wire boundaries check every argument (and, for a method
        # sink like `log.emit(...)`, a tainted receiver is immaterial)
        if seg in self.sinks:
            for a, o in zip(call.args, arg_origins):
                self._sink_hit(a, o, f"sink '{seg}'", "secret-to-sink-flow")
            for kw in call.keywords:
                self._sink_hit(
                    kw.value, kw_origins[kw.arg], f"sink '{seg}'",
                    "secret-to-sink-flow",
                )
        if seg in self.wires:
            for a, o in zip(call.args, arg_origins):
                self._sink_hit(a, o, f"'{seg}'", "unmasked-wire")
            for kw in call.keywords:
                self._sink_hit(
                    kw.value, kw_origins[kw.arg], f"'{seg}'", "unmasked-wire",
                )

        # declassifiers clear taint: their output is public by protocol
        # argument (pad-XOR ciphertext, opened share, commitment)
        if seg in self.declass:
            return frozenset()

        callee = self._resolve(call)
        if callee is not None:
            self._apply_callee_boundaries(call, callee, arg_origins, kw_origins)

        # declared function-return sources taint unconditionally
        label = self.info.fn_sources.get(seg)
        if label is None and callee is not None and callee.declared_source:
            label = f"{callee.qual}()"
        if label is not None:
            return frozenset((label,))

        if callee is not None:
            out = set(o for o in callee.ret if isinstance(o, str))
            offset = 1 if (
                callee.cls is not None
                and isinstance(call.func, ast.Attribute)
            ) else 0
            for o in callee.ret:
                if not isinstance(o, int):
                    continue
                pos = o - offset
                if 0 <= pos < len(arg_origins):
                    out |= arg_origins[pos]
                elif o < len(callee.params):
                    name = callee.params[o]
                    if name in kw_origins:
                        out |= kw_origins[name]
            return frozenset(out)

        if seg in _PROPAGATING_CALLS:
            return all_args | recv
        if isinstance(call.func, ast.Attribute):
            # unresolved method on a tainted receiver: `seed.copy()`,
            # `digest.hex()` — the result carries the receiver's bytes.
            # (`h.digest()` on an UNtainted hasher stays clean: hashing
            # is structural declassification, see module docstring.)
            return recv
        return frozenset()  # unresolved bare call: untainted by design

    def _apply_callee_boundaries(self, call, callee, arg_origins, kw_origins):
        """Surface the callee's sink/wire/branch summary at this call
        site: an argument that the callee leaks is a leak HERE."""
        offset = 1 if (
            callee.cls is not None and isinstance(call.func, ast.Attribute)
        ) else 0

        def each_bound_arg():
            for pos, (a, o) in enumerate(zip(call.args, arg_origins)):
                yield pos + offset, a, o
            for kw in call.keywords:
                if kw.arg in callee.params:
                    yield callee.params.index(kw.arg), kw.value, \
                        kw_origins[kw.arg]

        for idx, node, origins in each_bound_arg():
            if idx in callee.sink_params:
                self._sink_hit(
                    node, origins,
                    f"{callee.sink_params[idx]} via '{callee.qual}'",
                    "secret-to-sink-flow",
                )
            if idx in callee.wire_params:
                self._sink_hit(
                    node, origins,
                    f"{callee.wire_params[idx]} via '{callee.qual}'",
                    "unmasked-wire",
                )
            if idx in callee.branch_params and _is_secret(origins):
                self._report(
                    "secret-branch", node,
                    f"value derived from declared source "
                    f"'{_secret_label(origins)}' flows into "
                    f"'{callee.qual}', which branches on it "
                    f"(line {callee.branch_params[idx]}) — a host "
                    "branch on secret data is a timing channel",
                )

    # -- statement walk ---------------------------------------------------

    def _bind(self, target, origins):
        if isinstance(target, ast.Name):
            self.env[target.id] = origins
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, origins)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, origins)
        elif isinstance(target, ast.Subscript):
            # weak update: d[k] = secret taints the container
            self.ev(target.slice)
            base = target.value
            if isinstance(base, ast.Name):
                self.env[base.id] = self.env.get(
                    base.id, frozenset()
                ) | origins
        # attribute stores are declarative (the source table binds them)

    def _bind_precise(self, target, value_node, origins):
        """Element-wise binding for `a, b = x, y` tuple-literal RHS."""
        if (
            isinstance(target, (ast.Tuple, ast.List))
            and isinstance(value_node, (ast.Tuple, ast.List))
            and len(target.elts) == len(value_node.elts)
            and not any(isinstance(e, ast.Starred) for e in target.elts)
        ):
            for t, v in zip(target.elts, value_node.elts):
                self._bind(t, self.ev(v))
        else:
            self._bind(target, origins)

    def stmt(self, s):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.env[s.name] = frozenset()  # analyzed as its own _TFn
            return
        if isinstance(s, ast.ClassDef):
            return
        if isinstance(s, (ast.Assign, ast.AnnAssign)):
            origins = self.ev(s.value)
            if s.lineno in self.info.source_lines:
                origins = origins | frozenset(
                    (f"inline fhh-taint source (line {s.lineno})",)
                )
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            for t in targets:
                self._bind_precise(t, s.value, origins)
            return
        if isinstance(s, ast.AugAssign):
            origins = self.ev(s.value)
            if isinstance(s.target, ast.Name):
                self.env[s.target.id] = self.env.get(
                    s.target.id, frozenset()
                ) | origins
            else:
                self._bind(s.target, origins)
            return
        if isinstance(s, ast.Return):
            self.ret |= self.ev(s.value)
            return
        if isinstance(s, ast.Expr):
            v = s.value
            if isinstance(v, (ast.Yield, ast.YieldFrom)):
                self.ret |= self.ev(v.value)
            else:
                self.ev(v)
            return
        if isinstance(s, ast.Raise):
            if s.exc is not None:
                if isinstance(s.exc, ast.Call):
                    # `raise Err(f"... {x}")`: the constructor is an
                    # unresolved call (drops taint by design), but its
                    # arguments ARE the exception message
                    origins = frozenset()
                    for a in s.exc.args:
                        node = a.value if isinstance(a, ast.Starred) else a
                        origins |= self.ev(node)
                    for kw in s.exc.keywords:
                        origins |= self.ev(kw.value)
                else:
                    origins = self.ev(s.exc)
                self._sink_hit(
                    s, origins, "an exception message", "secret-to-sink-flow"
                )
            return
        if isinstance(s, ast.Assert):
            self._branch_hit(s, self.ev(s.test), "an assert")
            if s.msg is not None:
                self._sink_hit(
                    s, self.ev(s.msg), "an assert message",
                    "secret-to-sink-flow",
                )
            return
        if isinstance(s, ast.If):
            self._branch_hit(s, self.ev(s.test), "a branch")
            env0 = dict(self.env)
            for b in s.body:
                self.stmt(b)
            env_body = self.env
            self.env = env0
            for b in s.orelse:
                self.stmt(b)
            for k, v in env_body.items():  # may-taint join of both arms
                self.env[k] = self.env.get(k, frozenset()) | v
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._bind(s.target, self.ev(s.iter))
            # two passes: taint bound late in the body reaches a use
            # early in the body on the next iteration
            for _ in range(2):
                for b in s.body:
                    self.stmt(b)
            for b in s.orelse:
                self.stmt(b)
            return
        if isinstance(s, ast.While):
            self._branch_hit(s, self.ev(s.test), "a loop condition")
            for _ in range(2):
                for b in s.body:
                    self.stmt(b)
                self._branch_hit(s, self.ev(s.test), "a loop condition")
            for b in s.orelse:
                self.stmt(b)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                origins = self.ev(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, origins)
            for b in s.body:
                self.stmt(b)
            return
        if isinstance(s, ast.Try):
            for b in s.body:
                self.stmt(b)
            for h in s.handlers:
                if h.name:
                    self.env[h.name] = frozenset()
                for b in h.body:
                    self.stmt(b)
            for b in s.orelse + s.finalbody:
                self.stmt(b)
            return
        if isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
            return
        # generic fallback (Match, Global, Import, ...): evaluate child
        # expressions, walk child statements
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self.ev(child)
            elif isinstance(child, ast.stmt):
                self.stmt(child)
            elif hasattr(child, "body"):  # match_case and friends
                for b in getattr(child, "body", ()):
                    if isinstance(b, ast.stmt):
                        self.stmt(b)


def _walk_fn(info, cfg, fn: _TFn, collect: bool):
    w = _FnWalker(info, cfg, fn, collect)
    for s in fn.node.body:
        w.stmt(s)
    return w


def analyze(mod: SourceModule, cfg) -> _TaintInfo:
    """Build (and cache on ``mod``) the module's taint state: function
    table, summary fixpoint over the call graph, and the final findings
    list (pre-contract filtering — the rules apply ``declassified``)."""
    cached = getattr(mod, "_fhh_taint_info", None)
    if cached is not None and cached[0] is cfg:
        return cached[1]
    info = _TaintInfo()
    info.attr_sources, info.fn_sources = _source_tables(cfg)
    info.source_lines = set(_annotation_lines(mod.text, _SOURCE_RE))
    info.declass_lines = {
        line: [g[0].strip() for g in groups]
        for line, groups in _annotation_lines(mod.text, _DECLASS_RE).items()
    }

    class_of_fn: dict[int, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_of_fn[id(child)] = node.name

    fns: dict[str, _TFn] = {}
    fn_of_node: dict[int, _TFn] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls = class_of_fn.get(id(node))
        qual = f"{cls}.{node.name}" if cls else node.name
        fn = _TFn(node, qual, cls, node.lineno in info.source_lines)
        fns.setdefault(qual, fn)  # first definition wins (documented)
        fn_of_node[id(node)] = fns[qual]
    info.fns = fns
    info.fn_of_node = fn_of_node

    # summary fixpoint: iterate until no function's summary moves (the
    # reason dicts are first-wins, the origin sets grow monotonically,
    # so this converges; the bound is a safety valve, not a truncation)
    for _ in range(max(4, len(fns))):
        changed = False
        for fn in fns.values():
            w = _walk_fn(info, cfg, fn, collect=False)
            before = fn.summary()
            fn.ret = frozenset(w.ret)
            for store, new in (
                (fn.sink_params, w.sink_params),
                (fn.wire_params, w.wire_params),
                (fn.branch_params, w.branch_params),
            ):
                for k, v in new.items():
                    store.setdefault(k, v)
            if fn.summary() != before:
                changed = True
        if not changed:
            break

    # final reporting pass (functions + module top level)
    findings: list = []
    for fn in fns.values():
        findings.extend(_walk_fn(info, cfg, fn, collect=True).findings)
    top = _FnWalker(info, cfg, None, collect=True)
    for s in mod.tree.body:
        top.stmt(s)
    findings.extend(top.findings)
    info.findings = findings

    mod._fhh_taint_info = (cfg, info)
    return info


def _enclosing_fn_node(mod: SourceModule, line: int):
    """Deepest function whose span contains ``line`` (None: module)."""
    best = None
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lo, hi = node.lineno, getattr(node, "end_lineno", node.lineno)
            if lo <= line <= hi and (
                best is None or lo > best.lineno
            ):
                best = node
    return best


def _contract_verified(mod: SourceModule, cfg, line: int, reason: str):
    """A ``declassified(reason)`` contract is verified when the reason
    names a declared declassifier AND that operation is actually called
    in the enclosing function (else module) — the written justification
    must point at a masking/opening step that is really on the path."""
    named = [
        d for d in getattr(cfg, "taint_declassifiers", ())
        if re.search(rf"\b{re.escape(d)}\b", reason)
    ]
    if not named:
        return False, (
            "names no declared declassifier (taint_declassifiers)"
        )
    scope = _enclosing_fn_node(mod, line) or mod.tree
    called = {
        last_segment(dotted_name(n.func))
        for n in ast.walk(scope)
        if isinstance(n, ast.Call)
    }
    missing = [d for d in named if d not in called]
    if missing:
        return False, (
            f"names '{missing[0]}' but that operation is never called "
            "in the enclosing function"
        )
    return True, ""


def _declassified_at(mod, cfg, info, lineno, end_lineno):
    """True when a VERIFIED declassified contract covers the span."""
    for line in range(lineno, (end_lineno or lineno) + 1):
        for reason in info.declass_lines.get(line, ()):
            ok, _ = _contract_verified(mod, cfg, line, reason)
            if ok:
                return True
    return False


class _TaintRule(Rule):
    kind: str = ""

    def check(self, mod: SourceModule, cfg):
        if not _in_scope(mod, cfg):
            return
        info = analyze(mod, cfg)
        for kind, lineno, end_lineno, message in info.findings:
            if kind != self.kind:
                continue
            if _declassified_at(mod, cfg, info, lineno, end_lineno):
                continue
            yield lineno, end_lineno, message


class SecretToSinkFlow(_TaintRule):
    """Interprocedural taint reaching an obs sink or exception message.
    Also the contract checker: every ``declassified(reason)`` in scope
    must name a declared declassifier that is really called — an
    unverifiable justification is itself a finding (the atomic-
    contract precedent: annotations are checked, never trusted)."""

    name = "secret-to-sink-flow"
    default_severity = "error"
    kind = "secret-to-sink-flow"

    def check(self, mod: SourceModule, cfg):
        if not _in_scope(mod, cfg):
            return
        info = analyze(mod, cfg)
        for line, reasons in sorted(info.declass_lines.items()):
            for reason in reasons:
                ok, why = _contract_verified(mod, cfg, line, reason)
                if not ok:
                    yield (
                        line, line,
                        f"`# fhh-taint: declassified({reason})` {why} — "
                        "the justification must name the masking/opening "
                        "operation on the taint path (one of "
                        "taint_declassifiers), and that operation must "
                        "appear in the enclosing function",
                    )
        yield from super().check(mod, cfg)


class SecretBranch(_TaintRule):
    """Host control flow conditioned on secret-derived data — the
    timing-channel shape MPC code must never have."""

    name = "secret-branch"
    default_severity = "error"
    kind = "secret-branch"


class UnmaskedWire(_TaintRule):
    """Taint reaching a frame send without a declared declassifier."""

    name = "unmasked-wire"
    default_severity = "error"
    kind = "unmasked-wire"


TAINT_RULES = (SecretToSinkFlow(), SecretBranch(), UnmaskedWire())
