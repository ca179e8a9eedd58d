"""AST lint engine for the port's architectural invariants (the counterpart
of ``repro.analysis.lint``, its own copy: the port imports nothing of the
JAX package).

The serving stack's QoS claims rest on disciplines that a generic linter
cannot see: host<->device synchronization only at the engine's dispatch
points, one token-emission sink, one owner for the expert slot pools and the
KV slot pools, and span / metric writes only where the observability layer
declares them. This module is the engine: it parses every scanned source
file once, annotates each AST node with its enclosing scope (dotted
qualname) and loop depth, and hands the annotated module to each rule in
:mod:`repro_torch.analysis.rules`.

Findings are suppressed only through ``analysis/allowlist.toml``: each entry
names the rule, file, scope and (optionally) the exact call / argument
source text it allows, with a reason. An entry that matches nothing is
reported, so the allowlist cannot go stale.
"""
from __future__ import annotations

import ast
import fnmatch
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# --------------------------------------------------------------------------
# findings
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One rule violation at a specific source location."""

    rule: str          # rule id, e.g. "sync-point"
    path: str          # posix path relative to the scanned root, e.g. "serving/engine.py"
    line: int
    scope: str         # dotted qualname of the enclosing function ("" = module level)
    message: str
    call: str = ""     # dotted callee, e.g. "np.asarray" (rules may leave blank)
    arg: str = ""      # source text of the first argument, for allowlist matching

    def format(self) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{self.rule:<22} {where}{scope}  {self.message}"


# --------------------------------------------------------------------------
# allowlist
# --------------------------------------------------------------------------


@dataclass
class AllowEntry:
    rule: str
    reason: str
    path: str = "*"
    scope: str = "*"
    call: str = ""
    arg: str = ""
    hits: int = field(default=0, compare=False)

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule:
            return False
        if not fnmatch.fnmatch(f.path, self.path):
            return False
        if not fnmatch.fnmatch(f.scope or "", self.scope):
            return False
        if self.call and self.call != f.call:
            return False
        if self.arg and self.arg != f.arg:
            return False
        return True


def _parse_toml_minimal(text: str) -> dict:
    """Tiny TOML subset parser: ``[[allow]]`` array-of-tables with string
    values, for an interpreter without ``tomllib`` (before 3.11); the
    allowlist uses only this subset so the fallback stays trivial."""
    out: dict = {}
    current: Optional[dict] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            current = {}
            out.setdefault(name, []).append(current)
            continue
        if line.startswith("[") and line.endswith("]"):
            name = line[1:-1].strip()
            current = {}
            out[name] = current
            continue
        if "=" in line:
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if val.startswith('"'):
                # strip trailing comment outside the string
                end = val.find('"', 1)
                while end != -1 and val[end - 1] == "\\":
                    end = val.find('"', end + 1)
                sval = val[1:end] if end != -1 else val[1:]
                value: object = sval.replace('\\"', '"')
            elif val in ("true", "false"):
                value = val == "true"
            else:
                value = val.split("#", 1)[0].strip()
                try:
                    value = int(value)  # type: ignore[assignment]
                except ValueError:
                    pass
            if current is None:
                out[key] = value
            else:
                current[key] = value
    return out


def load_allowlist(path: Path) -> List[AllowEntry]:
    text = path.read_text()
    try:
        import tomllib  # py311+

        data = tomllib.loads(text)
    except ImportError:
        data = _parse_toml_minimal(text)
    entries: List[AllowEntry] = []
    for i, row in enumerate(data.get("allow", [])):
        if "rule" not in row or "reason" not in row:
            raise ValueError(
                f"allowlist entry #{i + 1} must set 'rule' and 'reason': {row!r}"
            )
        known = {"rule", "reason", "path", "scope", "call", "arg"}
        extra = set(row) - known
        if extra:
            raise ValueError(
                f"allowlist entry #{i + 1} has unknown keys {sorted(extra)}"
            )
        entries.append(AllowEntry(**{k: row[k] for k in known & set(row)}))
    return entries


# --------------------------------------------------------------------------
# module indexing
# --------------------------------------------------------------------------


class ModuleInfo:
    """A parsed source file with per-node scope and loop-depth annotations."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=relpath)
        # node -> dotted qualname of the *enclosing* function ("" at module level)
        self.scope_of: Dict[ast.AST, str] = {}
        # node -> number of enclosing for/while loops *within* its function
        self.loop_depth: Dict[ast.AST, int] = {}
        # qualname -> FunctionDef/AsyncFunctionDef
        self.functions: Dict[str, ast.AST] = {}
        for child in ast.iter_child_nodes(self.tree):
            self._visit(child, scope="", loops=0, qual=())

    def _visit(self, node: ast.AST, scope: str, loops: int, qual: Tuple[str, ...]):
        self.scope_of[node] = scope
        self.loop_depth[node] = loops
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # decorators and defaults evaluate in the *enclosing* scope
            for dec in node.decorator_list:
                self._visit(dec, scope, loops, qual)
            for d in node.args.defaults + [x for x in node.args.kw_defaults if x]:
                self._visit(d, scope, loops, qual)
            new_qual = qual + (node.name,)
            new_scope = ".".join(new_qual)
            self.functions[new_scope] = node
            for child in node.body:
                self._visit(child, new_scope, 0, new_qual)
            return
        if isinstance(node, ast.ClassDef):
            for dec in node.decorator_list:
                self._visit(dec, scope, loops, qual)
            for b in node.bases + node.keywords:
                self._visit(b, scope, loops, qual)
            for child in node.body:
                self._visit(child, scope, loops, qual + (node.name,))
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            for fld in ("target", "iter", "test"):
                sub = getattr(node, fld, None)
                if sub is not None:
                    self._visit(sub, scope, loops, qual)
            for child in node.body + node.orelse:
                self._visit(child, scope, loops + 1, qual)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, scope, loops, qual)

    # -- convenience -------------------------------------------------------

    def scope(self, node: ast.AST) -> str:
        return self.scope_of.get(node, "")

    def loops(self, node: ast.AST) -> int:
        return self.loop_depth.get(node, 0)


def dotted_name(node: ast.AST) -> str:
    """``np.asarray`` / ``self.cache.slot`` / ``torch.cuda.synchronize`` ->
    dotted string.

    Returns "" for anything that is not a plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        # e.g. group_by_expert(...).row_idx — root is a call
        inner = dotted_name(node.func)
        parts.append(f"{inner}()" if inner else "()")
    else:
        return ""
    return ".".join(reversed(parts))


def first_arg_src(call: ast.Call) -> str:
    if call.args:
        try:
            return ast.unparse(call.args[0])
        except Exception:
            return ""
    return ""


# --------------------------------------------------------------------------
# rule base + runner
# --------------------------------------------------------------------------


class Rule:
    """Base class: subclasses set ``id``, ``paths`` (fnmatch globs relative
    to the scanned root) and implement ``check``."""

    id: str = ""
    paths: Sequence[str] = ("*",)

    def applies(self, relpath: str) -> bool:
        return any(fnmatch.fnmatch(relpath, g) for g in self.paths)

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclass
class LintReport:
    findings: List[Finding]
    suppressed: List[Tuple[Finding, AllowEntry]]
    unused_allows: List[AllowEntry]
    scanned: List[str]

    @property
    def ok(self) -> bool:
        return not self.findings


def iter_sources(root: Path) -> Iterable[Tuple[str, Path]]:
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        yield rel, p


def run_lint(
    root: Path,
    rules: Sequence[Rule],
    allowlist: Sequence[AllowEntry] = (),
) -> LintReport:
    """Lint every ``*.py`` under ``root`` with ``rules``.

    ``root`` is the package root (the directory holding ``serving/``,
    ``core/``, ``kernels/``); rule path globs are matched against paths
    relative to it."""
    allow = list(allowlist)
    findings: List[Finding] = []
    suppressed: List[Tuple[Finding, AllowEntry]] = []
    scanned: List[str] = []
    for rel, path in iter_sources(root):
        active = [r for r in rules if r.applies(rel)]
        if not active:
            continue
        scanned.append(rel)
        mod = ModuleInfo(rel, path.read_text())
        for rule in active:
            for f in rule.check(mod):
                hit = next((a for a in allow if a.matches(f)), None)
                if hit is not None:
                    hit.hits += 1
                    suppressed.append((f, hit))
                else:
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    unused = [a for a in allow if a.hits == 0]
    return LintReport(findings, suppressed, unused, scanned)
