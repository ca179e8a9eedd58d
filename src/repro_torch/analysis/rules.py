"""The port's lint rules (the counterpart of ``repro.analysis.rules``).

Each rule encodes an architectural invariant of the serving stack. The rules
are codebase-aware: the registries below name the port's own hot paths,
sanctioned writers and span sites, so a new call site has to follow the
discipline or earn an allowlist entry with a written reason.

Carried over, in their PyTorch forms: ``sync-point``, ``emit-discipline``,
``residency-discipline`` and ``obs-discipline``. The reference's
``jit-hygiene`` and ``recompile-hazard`` are rules about ``jax.jit`` (a
jitted callable built in a loop, a closure over mutable engine state, a
data-dependent shape crossing a jit boundary); the port compiles nothing at
run time (its kernels are built once, ahead of the first launch), so they do
not carry over. What they guarded, a bounded set of launch shapes of the
grouped expert FFN, ``device_audit.py``'s ``compile-keys`` check measures.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .lint import Finding, ModuleInfo, Rule, dotted_name, first_arg_src


# ==========================================================================
# registries (the codebase-aware part)
# ==========================================================================

# --- sync-point -----------------------------------------------------------
# Per-token / per-chunk hot scopes: a host<->device synchronization here must
# be a declared dispatch point (allowlisted) or it stalls the decode tail
# that DuoServe's prefetch overlap is there to protect.
SYNC_HOT_SCOPES: Dict[str, Tuple[str, ...]] = {
    "serving/engine.py": (
        "EngineCore._embed",
        "EngineCore._grouped_ffn_raw",
        "EngineCore._run_experts_prefill",
        "EngineCore._run_experts_prefill_fused",
        "EngineCore._prefill_moe",
        "EngineCore.prefill_chunk",
        "EngineCore._prefill_layers_chunked",
        "MoEServingEngine.prefill",
        "MoEServingEngine.decode",
        "_logits_row",
    ),
    "serving/batching.py": (
        "BatchedServingEngine.step",
        "BatchedServingEngine._decode_step",
        "BatchedServingEngine._kv_rows",
        "BatchedServingEngine._pool_row",
        "BatchedServingEngine._prefill_work",
        "BatchedServingEngine._run_prefill_chunk",
        "BatchedServingEngine._admit_and_prefill",
        "BatchedServingEngine._sample_req",
        "BatchedServingEngine._emit_token",
    ),
    "core/cache.py": (
        "CacheState.*",
        "ExpertResidency.*",
    ),
    "core/predictor.py": (
        "TrainedPredictor.predict_logits",
    ),
    "kernels/*.py": ("*",),
}

# Callables that block the host on the device when handed a device tensor
# (a readback, or a wait): ``np.asarray`` / ``np.array`` of a tensor, the
# builtins ``float`` and ``int`` of a tensor, and the explicit waits.
SYNC_CALLS: Set[str] = {
    "np.asarray", "np.array", "np.fromiter",
    "numpy.asarray", "numpy.array", "numpy.fromiter",
    "asarray", "fromiter",
    "float", "int",
    "torch.cuda.synchronize", "cuda.synchronize",
}
# Methods that do: a readback (``.item()``, ``.cpu()``, ``.tolist()``,
# ``.numpy()``) or a wait on an event or a stream (``.synchronize()``).
SYNC_METHODS: Set[str] = {"item", "cpu", "tolist", "numpy", "synchronize"}
# A readback whose receiver is already a ``.cpu()`` call reads host memory:
# the ``.cpu()`` is the sync and is reported itself.
HOST_AFTER_CPU: Set[str] = {"numpy", "tolist", "item"}
# parameter annotations that make an argument a host value
HOST_ANNOTATIONS: Set[str] = {"int", "float", "bool", "str", "np.ndarray"}
# Uploads from pageable host memory: the copy waits for the stream, so the
# host stalls on whatever the stream has queued. ``torch.as_tensor`` /
# ``torch.tensor`` with a ``device=``, and ``.to(<device>)`` / ``.cuda()``
# without ``non_blocking=True``; ``models.layers.upload`` (pinned,
# ``non_blocking``) is the sanctioned way to the card.
UPLOAD_CALLS: Set[str] = {"torch.as_tensor", "torch.tensor", "as_tensor"}
UPLOAD_METHODS: Set[str] = {"to", "cuda"}

# --- emit-discipline ------------------------------------------------------
# The one sink every streamed token funnels through; the event buffer itself
# is touched only by EngineCore._emit.
EMIT_BUFFER_OWNER = "EngineCore._emit"
TOKEN_EVENT_SINKS: Tuple[str, ...] = (
    "BatchedServingEngine._emit_token",
    "MoEServingEngine._emit_token",
)

# --- residency-discipline -------------------------------------------------
# Device-resident state with one owner: the expert slot pools belong to
# ExpertResidency; the KV slot pools and the slot-position table belong to
# the declared engine writers below.
PROTECTED_STATE: Set[str] = {"_pools", "_K", "_V", "_slot_pos"}
RESIDENCY_WRITERS: Tuple[str, ...] = (
    "ExpertResidency.*",                     # the pools' owner (core/cache.py)
    "BatchedServingEngine.__init__",         # allocation
    "BatchedServingEngine._decode_step",     # per-step KV append
    "BatchedServingEngine._run_prefill_chunk",
    "BatchedServingEngine._admit_and_prefill",
    "BatchedServingEngine._seed_rows",       # prefix-cache rows copied in
    "BatchedServingEngine.restore",          # snapshot handoff scatter
    "BatchedServingEngine._release_slot",    # slot_pos invalidation
)

# --- obs-discipline -------------------------------------------------------
# (a) Aggregates kept on the obs metrics registry. The old attribute names
# survive as read-only registry views; a direct write bypasses the registry
# and forks the bookkeeping.
MIGRATED_METRICS: Set[str] = {
    # BatchedServingEngine
    "prefilled_tokens",
    # ReplicaPool
    "n_handoffs", "n_migrated", "handoff_bytes", "handoff_bytes_saved",
    "n_tail_handoffs",
    # QosAutopilot
    "n_shed", "by_reason", "n_preempted", "n_resumed",
}
# (b) SpanRecorder mutators only at the declared request-lifecycle /
# engine-phase points below, so the span taxonomy stays readable as a
# timeline. Read-only recorder views are fine anywhere.
SPAN_METHODS: Set[str] = {"begin", "end", "instant", "terminal"}
SPAN_SCOPES: Dict[str, Tuple[str, ...]] = {
    "serving/engine.py": (
        "MoEServingEngine.decode",
    ),
    "serving/batching.py": (
        "BatchedServingEngine.submit_request",
        "BatchedServingEngine._admit_and_prefill",
        "BatchedServingEngine._run_prefill_chunk",
        "BatchedServingEngine._decode_step",
        "BatchedServingEngine.cancel",
        "BatchedServingEngine._retire",
        "BatchedServingEngine.snapshot",
        "BatchedServingEngine.restore",
    ),
    "serving/cluster.py": (
        "ReplicaPool.migrate",
        "QosAutopilot.scan",
        "QosAutopilot._scan_preempt",
    ),
    "serving/frontend.py": (
        "CooperativeDriver._cancel_paused",
    ),
}


# ==========================================================================
# helpers
# ==========================================================================


def _scope_matches(scope: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(scope, p) for p in patterns)


def _is_host_literal(node: ast.AST) -> bool:
    """Args that are plainly host-side: literals, comprehensions over host
    lists, comparisons (a bool) and ``len(...)``. ``np.asarray`` over these
    packs a list, and ``int`` of them converts a host value."""
    if isinstance(node, (ast.List, ast.Tuple, ast.Set, ast.Dict, ast.ListComp,
                         ast.SetComp, ast.DictComp, ast.GeneratorExp, ast.Constant,
                         ast.Compare, ast.BoolOp)):
        return True
    return isinstance(node, ast.Call) and dotted_name(node.func) == "len"


def _host_names(fn: Optional[ast.AST]) -> Set[str]:
    """Names that hold host numbers in ``fn``: its parameters annotated with
    a host type (``int``, ...) and the targets of its ``for ... in
    range(...)`` loops."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    names = {a.arg for a in args
             if a.annotation is not None and dotted_name(a.annotation) in HOST_ANNOTATIONS}
    for node in ast.walk(fn):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Call) and dotted_name(node.iter.func) == "range"):
            names.add(node.target.id)
    return names


def _is_host(node: ast.AST, host: Set[str]) -> bool:
    """A host literal, a name in ``host``, an element of one, or
    arithmetic of such."""
    if _is_host_literal(node):
        return True
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, ast.Subscript):
        return _is_host(node.value, host)
    if isinstance(node, ast.BinOp):
        return _is_host(node.left, host) and _is_host(node.right, host)
    if isinstance(node, ast.UnaryOp):
        return _is_host(node.operand, host)
    return False


def _is_device(node: ast.AST) -> bool:
    """A device argument: ``device`` / ``dev`` / ``*_device`` names,
    ``<x>.device``, a ``"cuda..."`` string or ``torch.device(...)``."""
    if isinstance(node, ast.Name):
        return node.id in ("device", "dev") or node.id.endswith("_device")
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    return isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device"


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    return next((k.value for k in node.keywords if k.arg == name), None)


def _pageable_upload(node: ast.Call) -> Optional[str]:
    """The callee of a host-to-device upload from pageable memory, or None."""
    name = dotted_name(node.func)
    if name in UPLOAD_CALLS:
        dev = _kwarg(node, "device")
        if dev is not None and not (isinstance(dev, ast.Constant) and dev.value is None):
            return name
        return None
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in UPLOAD_METHODS):
        return None
    nb = _kwarg(node, "non_blocking")
    if isinstance(nb, ast.Constant) and nb.value is True:
        return None
    if fn.attr == "to" and not any(_is_device(a) for a in
                                   node.args[:1] + [_kwarg(node, "device")] if a):
        return None
    return name or fn.attr


def _attr_root(node: ast.AST) -> Optional[str]:
    """For a target like ``self._K[l]`` or ``self._pools["w1"]`` the
    protected attribute name (``_K``); None if not an attribute chain."""
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _iter_target_roots(target: ast.AST) -> Iterable[ast.AST]:
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _iter_target_roots(elt)
    else:
        yield target


def _assign_targets(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


# ==========================================================================
# rules
# ==========================================================================


class SyncPointRule(Rule):
    id = "sync-point"
    paths = tuple(SYNC_HOT_SCOPES)

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        patterns: Tuple[str, ...] = ()
        for glob, pats in SYNC_HOT_SCOPES.items():
            if fnmatch.fnmatch(mod.relpath, glob):
                patterns = patterns + pats
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            scope = mod.scope(node)
            if not _scope_matches(scope, patterns):
                continue
            finding = self._sync(node, _host_names(mod.functions.get(scope)))
            if finding is None:
                continue
            yield Finding(
                rule=self.id,
                path=mod.relpath,
                line=node.lineno,
                scope=scope,
                message=(
                    f"host sync `{finding}` on a per-token/per-chunk path; "
                    "syncs belong at declared dispatch points "
                    "(allowlist with a reason if this is one)"
                    + (": an upload from pageable memory waits for the stream, "
                       "upload through models.layers.upload (pinned, non_blocking)"
                       if _pageable_upload(node) else "")
                ),
                call=finding,
                arg=first_arg_src(node),
            )

    @staticmethod
    def _sync(node: ast.Call, host: Set[str]) -> Optional[str]:
        upload = _pageable_upload(node)
        if upload is not None:
            return upload
        name = dotted_name(node.func)
        if name in SYNC_CALLS:
            if node.args and _is_host(node.args[0], host):
                return None
            return name
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in SYNC_METHODS):
            return None
        recv = fn.value
        if (fn.attr in HOST_AFTER_CPU and isinstance(recv, ast.Call)
                and isinstance(recv.func, ast.Attribute) and recv.func.attr == "cpu"):
            return None
        return name or fn.attr


class EmitDisciplineRule(Rule):
    id = "emit-discipline"
    paths = ("serving/*.py",)

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            scope = mod.scope(node)
            name = dotted_name(node.func)
            # (a) direct event-buffer append
            if name.endswith("._events.append") and scope != EMIT_BUFFER_OWNER:
                yield Finding(
                    rule=self.id, path=mod.relpath, line=node.lineno,
                    scope=scope, call=name, arg=first_arg_src(node),
                    message=(
                        "event buffer appended outside EngineCore._emit; "
                        "route events through self._emit(...)"
                    ),
                )
            # (b) TokenEvent construction outside the one token sink
            if name.split(".")[-1] == "TokenEvent" and not _scope_matches(
                scope, TOKEN_EVENT_SINKS
            ):
                yield Finding(
                    rule=self.id, path=mod.relpath, line=node.lineno,
                    scope=scope, call="TokenEvent", arg=first_arg_src(node),
                    message=(
                        "TokenEvent constructed outside the _emit_token sink; "
                        "every streamed token must funnel through one sink "
                        "so cancellation/TBT accounting stay exact"
                    ),
                )


class ResidencyDisciplineRule(Rule):
    id = "residency-discipline"
    paths = ("serving/*.py", "core/*.py")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            targets = _assign_targets(node)
            if not targets:
                continue
            scope = mod.scope(node)
            for t in targets:
                for root in _iter_target_roots(t):
                    attr = _attr_root(root)
                    if attr not in PROTECTED_STATE:
                        continue
                    if _scope_matches(scope, RESIDENCY_WRITERS):
                        continue
                    yield Finding(
                        rule=self.id, path=mod.relpath, line=node.lineno,
                        scope=scope, call=attr, arg=ast.unparse(t),
                        message=(
                            f"mutation of protected device state `{attr}` "
                            "outside its declared owner scopes "
                            "(ExpertResidency / registered engine KV writers)"
                        ),
                    )


class ObsDisciplineRule(Rule):
    """Two disciplines of the observability layer:

    (a) metrics kept on the registry are mutated ONLY through their registry
        instruments: writes to the legacy attribute names (read-only views)
        or to ``*.perf.<field>`` fork the bookkeeping;
    (b) ``SpanRecorder`` mutators (``*.obs.begin/end/instant/terminal``)
        are called only at the lifecycle points declared in SPAN_SCOPES.
    """

    id = "obs-discipline"
    paths = ("serving/*.py", "core/*.py")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        yield from self._check_metric_writes(mod)
        yield from self._check_span_sites(mod)

    def _check_metric_writes(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            targets = _assign_targets(node)
            scope = mod.scope(node)
            for t in targets:
                for root in _iter_target_roots(t):
                    while isinstance(root, (ast.Subscript, ast.Starred)):
                        root = root.value
                    if not isinstance(root, ast.Attribute):
                        continue
                    owner = root.value
                    owner_attr = owner.attr if isinstance(owner, ast.Attribute) else None
                    if root.attr in MIGRATED_METRICS:
                        yield Finding(
                            rule=self.id, path=mod.relpath, line=node.lineno,
                            scope=scope, call=root.attr, arg=ast.unparse(t),
                            message=(
                                f"write to `{root.attr}`, a metric kept on the "
                                "obs registry (the attribute is a read-only "
                                "view); mutate the registry instrument instead"
                            ),
                        )
                    elif owner_attr == "perf":
                        yield Finding(
                            rule=self.id, path=mod.relpath, line=node.lineno,
                            scope=scope, call=f"perf.{root.attr}", arg=ast.unparse(t),
                            message=(
                                f"direct write to PerfCounters field "
                                f"`{root.attr}`; mutate via "
                                "perf.inc()/perf.max_update() so the registry "
                                "stays the single source of truth"
                            ),
                        )

    def _check_span_sites(self, mod: ModuleInfo) -> Iterable[Finding]:
        patterns: Tuple[str, ...] = ()
        for glob, pats in SPAN_SCOPES.items():
            if fnmatch.fnmatch(mod.relpath, glob):
                patterns = patterns + pats
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr in SPAN_METHODS):
                continue
            recv = fn.value
            if not (isinstance(recv, ast.Attribute) and recv.attr == "obs"):
                continue
            scope = mod.scope(node)
            if _scope_matches(scope, patterns):
                continue
            yield Finding(
                rule=self.id, path=mod.relpath, line=node.lineno,
                scope=scope, call=f"obs.{fn.attr}", arg=first_arg_src(node),
                message=(
                    f"span recorder `{fn.attr}()` outside the declared "
                    "lifecycle scopes (rules.SPAN_SCOPES); spans open/close "
                    "only at declared request-lifecycle / engine-phase points"
                ),
            )


ALL_RULES: Tuple[Rule, ...] = (
    SyncPointRule(),
    EmitDisciplineRule(),
    ResidencyDisciplineRule(),
    ObsDisciplineRule(),
)
