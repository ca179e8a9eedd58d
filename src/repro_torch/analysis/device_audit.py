"""The device audit of a built batched engine (the counterpart of
``repro.analysis.jaxpr_audit``; the port has no traced programs to read, so
it checks the same four properties on the engine itself):

* **callback**: host syncs inside one batched decode step. On the card the
  step runs under ``torch.cuda.set_sync_debug_mode("warn")``; each sync's
  call site (the innermost frame in the port) is held against the
  dispatch points the allowlist declares: the lines of the lint's
  ``sync-point`` findings that its entries allow. A sync elsewhere (an
  upload from pageable host memory waits for the stream too) is the stall
  DuoServe's prefetch overlap exists to avoid.
* **const**: device bytes held outside the residency ledger once the engine
  is built: what building it allocated, less its pools'
  ``capacity x bytes_per_expert``, its KV slot pools and any non-expert
  weight it moved onto the card itself, must stay within
  ``CONST_BYTES_LIMIT``. A weight copied beside the ledger breaks the
  ``capacity x bytes_per_expert`` bound silently.
* **donation**: ``ExpertResidency.prefetch`` writes the pools in place: the
  pools' ``data_ptr`` stays the same and, on the card, nothing is allocated
  across the prefetches.
* **compile-keys**: the distinct ``(U, C)`` launch shapes of the grouped
  expert FFN over a serving sweep, through the port's own
  ``group_by_expert`` and ``_bucket``, stay within the O(log B)·O(log U)
  bound per batch size (the reference's ``compile_key_bound``). Host only.

On a CPU engine ``donation`` and ``compile-keys`` run; on a CUDA engine all
four. ``run_audit(extra=...)`` plants bad cases (section ``extra`` below) so
tests can assert that each check catches one.
"""
from __future__ import annotations

import dataclasses
import math
import traceback
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .lint import ModuleInfo, load_allowlist, run_lint
from .rules import ALL_RULES

PACKAGE = Path(__file__).resolve().parents[1]
ALLOWLIST = Path(__file__).resolve().parent / "allowlist.toml"
# device bytes a built engine may hold beyond its ledger (pools, KV slot
# pools, weights it moved itself): allocator rounding and small buffers
CONST_BYTES_LIMIT = 16 << 20


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    rule: str      # callback | const | donation | compile-keys
    where: str     # a call site (path:line [scope]) or an object
    message: str

    def format(self) -> str:
        return f"{self.rule:<22} {self.where}  {self.message}"


@dataclasses.dataclass
class AuditReport:
    findings: List[AuditFinding]
    checks: List[str]                 # the checks that ran
    readings: Dict[str, object]       # what each check measured
    compile_keys: int
    compile_key_bound: int

    @property
    def ok(self) -> bool:
        return not self.findings


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def build_audit_engine(device: str = "cuda", **kw):
    """A batched engine of reduced Mixtral at the CUDA kernels' widths
    (head_dim 64 on one KV head), ``duo``, 8 rows of 512 slots, on random
    weights from seed 0."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.model import build
    from repro_torch.serving.batching import BatchedServingEngine
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")), head_dim=64,
                              n_kv_heads=1)
    params = build(cfg).init(0, device=device)
    opts = dict(policy="duo", max_batch=8, max_seq=512, temperature=0.0) | kw
    return BatchedServingEngine(cfg, params, **opts)


def _is_cuda(eng) -> bool:
    return eng.device.type == "cuda"


# --------------------------------------------------------------------------
# callback: host syncs inside one batched decode step
# --------------------------------------------------------------------------


TORCH = Path(torch.__file__).resolve().parent
# what the sync debug mode warns at each sync (c10's warn_or_error_on_sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _site(stack) -> Tuple[str, int]:
    """(path, line) of the innermost frame outside torch and ``warnings``
    (the code that asked for the sync): relative to the package in the
    port, else its full path."""
    for frame in reversed(stack):
        p = Path(frame.filename).resolve()
        if TORCH in p.parents or p.name == "warnings.py":
            continue
        if PACKAGE in p.parents:
            return p.relative_to(PACKAGE).as_posix(), frame.lineno
        return p.as_posix(), frame.lineno
    return "?", 0


_MODULES: Dict[str, ModuleInfo] = {}


def _scope_at(relpath: str, line: int) -> str:
    """The dotted qualname of the function enclosing ``line``."""
    if relpath not in _MODULES:
        _MODULES[relpath] = ModuleInfo(relpath, (PACKAGE / relpath).read_text())
    mod = _MODULES[relpath]
    best, span = "", math.inf
    for qual, fn in mod.functions.items():
        lo, hi = fn.lineno, getattr(fn, "end_lineno", fn.lineno)
        if lo <= line <= hi and hi - lo < span:
            best, span = qual, hi - lo
    return best


def dispatch_points(allowlist: Path = ALLOWLIST) -> Set[Tuple[str, int]]:
    """(path, line) of every ``sync-point`` finding of the port's lint that
    the allowlist allows: the declared dispatch points."""
    rep = run_lint(PACKAGE, ALL_RULES, load_allowlist(allowlist))
    return {(f.path, f.line) for f, _ in rep.suppressed if f.rule == "sync-point"}


def decoding_engine(eng, prompts: Optional[Sequence[np.ndarray]] = None,
                    max_new: int = 64):
    """Submit ``prompts`` (default: one of 6-13 tokens per row of the
    batch) and step until every request decodes."""
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, eng.cfg.vocab, 6 + i).astype(np.int32)
                   for i in range(eng.max_batch)]
    for p in prompts:
        eng.submit(p, max_new=max_new)
    for _ in range(10_000):
        if len(eng.running) == len(prompts):
            return eng
        eng.step()
    raise RuntimeError("the audit's requests never all reached decode")


def audit_callbacks(eng, allowed: Set[Tuple[str, int]], planted: Sequence[Callable] = ()):
    """Run one batched decode step of ``eng`` (every request decoding)
    under the sync debug mode and return (findings, readings): every sync's
    call site, with its count, and a finding for each site that is not one
    of the ``allowed`` dispatch points. ``planted`` callables run inside
    the audited window (tests plant syncs there)."""
    sites: Dict[Tuple[str, int], int] = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        # the sync's own warning, not the mode's one-time "prototype
        # feature" notice (which names synchronizing operations too)
        if SYNC_WARNING in str(message):
            site = _site(traceback.extract_stack()[:-1])   # not this hook
            sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize(eng.device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
            for fn in planted:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    findings, listed = [], []
    for (path, line), n in sorted(sites.items()):
        scope = _scope_at(path, line) if (PACKAGE / path).is_file() else ""
        ok = (path, line) in allowed
        listed.append(dict(site=f"{path}:{line}", scope=scope, syncs=n, allowed=ok))
        if not ok:
            findings.append(AuditFinding(
                "callback", f"{path}:{line} [{scope}]",
                f"{n} host sync(s) inside one batched decode step outside the "
                "declared dispatch points"))
    readings = dict(syncs=sum(sites.values()), sites=listed, batch=len(eng.running),
                    outside_dispatch_points=sum(not r["allowed"] for r in listed))
    return findings, readings


# --------------------------------------------------------------------------
# const: device bytes outside the residency ledger
# --------------------------------------------------------------------------


def _storages(node) -> Dict[int, int]:
    """{storage pointer: bytes} of the CUDA tensors in a nested container."""
    out: Dict[int, int] = {}
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        for v in node:
            out.update(_storages(v))
    elif isinstance(node, torch.Tensor) and node.is_cuda:
        st = node.untyped_storage()
        out[st.data_ptr()] = st.nbytes()
    return out


def audit_const(build: Callable, given=None, planted: Sequence[Callable] = ()):
    """Build an engine with ``build()`` and return (findings, readings, the
    engine): the device bytes building it allocated, less its expert pools,
    its KV slot pools and the non-expert weights it holds that were not
    already on the card in ``given`` (the params it is built from, when
    they were made before), against ``CONST_BYTES_LIMIT``. ``planted``
    callables take the engine and run before the measurement."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    had = set(_storages(given)) if given is not None else set()
    eng = build()
    for fn in planted:
        fn(eng)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    pools = eng.cache.device_bytes
    kv = sum(t.untyped_storage().nbytes() for t in eng._K + eng._V)
    own = sum(n for ptr, n in _storages([eng.dev, eng._layers, eng._moe]).items()
              if ptr not in had)
    outside = held - pools - kv - own
    readings = dict(held_bytes=held, pool_bytes=pools, kv_bytes=kv, own_weight_bytes=own,
                    outside_bytes=outside, limit_bytes=CONST_BYTES_LIMIT)
    findings = []
    if outside > CONST_BYTES_LIMIT:
        findings.append(AuditFinding(
            "const", type(eng).__name__,
            f"{outside} device bytes held outside the residency ledger (limit "
            f"{CONST_BYTES_LIMIT}): a weight or buffer beside the pools breaks "
            "the capacity x bytes_per_expert bound"))
    if pools != eng.cache.pool_capacity * eng.cache.bytes_per_expert:
        findings.append(AuditFinding(
            "const", "ExpertResidency",
            f"the pools hold {pools} bytes, not capacity x bytes_per_expert"))
    return findings, readings, eng


# --------------------------------------------------------------------------
# donation: the pools written in place
# --------------------------------------------------------------------------


def audit_donation(eng, prefetch: Optional[Callable] = None, n: int = 6):
    """Write ``n`` experts of layer 0 into the pools through ``prefetch``
    (default ``eng.cache.prefetch``; tests plant an out-of-place writer):
    each is dropped from the ledger first if resident, then admitted, so
    every prefetch copies. Every pool keeps its ``data_ptr``, the slots
    written hold their slabs, and on the card nothing is allocated across
    the prefetches. Returns (findings, readings)."""
    cache = eng.cache
    prefetch = prefetch or cache.prefetch
    keys = [(0, e) for e in range(min(n, eng.E))]
    for k in keys:
        if cache.contains(k):
            cache.drop(k, 0.0)
        cache.admit(k, 0.0, pinned=False)
    # the pools as they were, held: a copy can then never land at their
    # address, so any write that replaces a pool shows at once
    held = cache.pools
    cuda = _is_cuda(eng)
    if cuda:
        torch.cuda.synchronize(eng.device)
        before = torch.cuda.memory_allocated(eng.device)
    moved = set()
    for k in keys:
        prefetch(k)
        moved |= {n for n, p, q in zip(("w1", "w3", "w2"), held, cache.pools)
                  if p.data_ptr() != q.data_ptr()}
    if cuda:
        torch.cuda.synchronize(eng.device)
        grown = torch.cuda.memory_allocated(eng.device) - before
    else:
        grown = 0
    findings = []
    moved = sorted(moved)
    if moved:
        findings.append(AuditFinding(
            "donation", "ExpertResidency.prefetch",
            f"pools {moved} moved to new storage across prefetches: the write "
            "copies the pool instead of updating it in place"))
    if grown > 0:
        findings.append(AuditFinding(
            "donation", "ExpertResidency.prefetch",
            f"{grown} device bytes allocated across {len(keys)} prefetches"))
    wrong = [k for k in keys if cache.slot_of.get(k) is not None and not all(
        torch.equal(pool[cache.slot_of[k]].cpu(), src.cpu())
        for pool, src in zip(cache.pools, cache.store.get(k)))]
    if wrong:
        findings.append(AuditFinding(
            "donation", "ExpertResidency.prefetch",
            f"slots of {wrong} do not hold their slabs after the prefetch"))
    return findings, dict(prefetched=len(keys), pool_ptrs_same=not moved,
                          allocated_bytes=grown)


# --------------------------------------------------------------------------
# compile-keys: the grouped FFN's launch shapes
# --------------------------------------------------------------------------


def _pow2_values(cap: int) -> Set[int]:
    """Every padded size ``_bucket`` gives for 1..cap."""
    from repro_torch.serving.engine import _bucket
    return {_bucket(n, cap) for n in range(1, cap + 1)}


def enumerate_grouped_keys(max_batch: int, E: int, k: int) -> Set[Tuple[int, int, int]]:
    """Every (B, U_pad, C) launch shape the decode sweep can give, from the
    engine's own bucketing."""
    keys: Set[Tuple[int, int, int]] = set()
    for B in range(1, max_batch + 1):
        for u_pad in _pow2_values(min(E, B * k)):
            for c in _pow2_values(B):
                keys.add((B, u_pad, c))
    return keys


def compile_key_bound(max_batch: int, E: int, k: int) -> int:
    """The O(log B)·O(log U) bound: per batch size at most (log2 B + 2)
    group capacities x (log2 Ucap + 2) group counts."""
    return sum((int(math.log2(B)) + 2) * (int(math.log2(min(E, B * k))) + 2)
               for B in range(1, max_batch + 1))


def selection_patterns(B: int, E: int, k: int) -> List[np.ndarray]:
    """[B, k] expert selections across the shape-relevant extremes: all
    rows on the same k experts, every row on distinct ones, and cyclic
    strides between."""
    pats = [np.tile(np.arange(k, dtype=np.int32), (B, 1)),
            np.arange(B * k, dtype=np.int32).reshape(B, k) % E]
    for stride in (1, 2, 3):
        pats.append(np.array([[(t * stride % E + j) % E for j in range(k)]
                              for t in range(B)], np.int32))
    return pats


def measure_grouped_keys(max_batch: int, E: int, k: int,
                         group: Optional[Callable] = None) -> Set[Tuple[int, int, int]]:
    """The (B, U, C) shapes ``group`` (default the port's
    ``group_by_expert``, with the decode call site's caps) gives over
    ``selection_patterns``."""
    if group is None:
        from repro_torch.serving.engine import group_by_expert as group
    seen: Set[Tuple[int, int, int]] = set()
    for B in range(1, max_batch + 1):
        for ids in selection_patterns(B, E, k):
            union = list(dict.fromkeys(int(e) for e in ids.ravel()))
            disp = group(ids, union, bucket_cap=B, u_bucket_cap=min(E, B * k))
            seen.add((B,) + tuple(disp.row_idx.shape))
    return seen


def audit_compile_keys(max_batch: int, E: int, k: int, group: Optional[Callable] = None):
    """Returns (findings, number of measured shapes, bound)."""
    keys = enumerate_grouped_keys(max_batch, E, k)
    bound = compile_key_bound(max_batch, E, k)
    measured = measure_grouped_keys(max_batch, E, k, group)
    findings = []
    if len(keys) > bound:
        findings.append(AuditFinding(
            "compile-keys", "group_by_expert",
            f"{len(keys)} grouped-FFN launch shapes across B=1..{max_batch}, past "
            f"the O(log B)·O(log U) bound {bound}"))
    stray = measured - keys
    if stray:
        findings.append(AuditFinding(
            "compile-keys", "group_by_expert",
            f"selections gave launch shapes {sorted(stray)[:8]} outside the "
            "bucketed set: the dispatch's padding no longer matches the "
            "declared bucketing"))
    return findings, len(measured), bound


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def run_audit(build: Optional[Callable] = None, given=None,
              prompts: Optional[Sequence[np.ndarray]] = None,
              extra: Optional[Dict[str, Sequence]] = None,
              allowlist: Path = ALLOWLIST) -> AuditReport:
    """Build an engine with ``build`` (default ``build_audit_engine()`` on
    the card) and run the checks its device allows. ``extra`` plants bad
    cases, per check: ``callback``: callables run inside the audited decode
    step; ``const``: callables given the built engine; ``donation``: a
    prefetch ``(cache, key)`` used in place of ``ExpertResidency.prefetch``;
    ``compile-keys``: a dispatch function used in place of
    ``group_by_expert``."""
    extra = extra or {}
    build = build or build_audit_engine
    findings: List[AuditFinding] = []
    readings: Dict[str, object] = {}
    checks: List[str] = []
    cuda = torch.cuda.is_available()
    if cuda:
        f, readings["const"], eng = audit_const(build, given, extra.get("const", ()))
        if _is_cuda(eng):
            findings += f
            checks.append("const")
    else:
        eng = build()
    if _is_cuda(eng):
        f, readings["callback"] = audit_callbacks(decoding_engine(eng, prompts),
                                                  dispatch_points(allowlist),
                                                  extra.get("callback", ()))
        findings += f
        checks.append("callback")
    bad = extra.get("donation")
    f, readings["donation"] = audit_donation(
        eng, (lambda key: bad(eng.cache, key)) if bad else None)
    findings += f
    checks.append("donation")
    f, n_keys, bound = audit_compile_keys(eng.max_batch, eng.E, eng.k,
                                          extra.get("compile-keys"))
    findings += f
    checks.append("compile-keys")
    readings["compile-keys"] = dict(measured=n_keys, bound=bound)
    return AuditReport(findings, checks, readings, n_keys, bound)
