"""Cross-request prefix/KV reuse: a radix tree over slot-pool KV rows.

Copy of ``repro.core.prefix`` (standard library only), kept whole in the
port.

ROADMAP item 2: traffic from millions of users is dominated by shared
prefixes (system prompts, few-shot templates, multi-turn history), so the
single biggest remaining TTFT lever is to stop re-prefilling tokens whose
KV already sits in the slot pool. The ``PrefixTree`` maps token sequences
to slot-pool rows: because the KV ring never wraps (``need <= W`` is
asserted at submission, so slot row p == absolute position p), a cached
prefix of ``n`` tokens is a contiguous ``[n, hkv, hd]`` region per layer
that can be copied row-for-row into a newly acquired slot — and the copy
is bit-identical to what cold prefill would have written, because prefill
of the same token ids at the same positions through the same weights is
deterministic.

Structure (token-level radix tree):

  * Each edge (node) carries a compressed run of token ids and the
    slot-pool region backing it: ``(slot, start, start+len(tokens))`` with
    ``start`` the absolute position of the edge's first token. Different
    nodes on one root path may be backed by DIFFERENT slots (each request
    contributed the suffix it was first to prefill).
  * ``match(tokens)`` walks the longest cached prefix, splits the final
    edge at the match boundary (so a holder's span is always a whole-node
    path), increments a per-node refcount along the path, and returns the
    hit length plus the ``(slot, lo, hi)`` row blocks to copy.
    ``release(tokens, n_hit)`` walks the same span and drops the refs.
    ``peek`` is the read-only variant (admission charging, router
    scoring) — no refs, no splits, no LRU touch.
  * ``insert(tokens, slot)`` records that ``slot`` now holds rows for
    ``tokens`` at positions ``0..len-1``: only the un-cached suffix
    creates a node (one compressed edge), backed by the inserting
    request's slot.

Slot ownership: while the donor request is LIVE its rows are valid (the
ring never wraps, so decode appends never overwrite the prompt region)
and the tree simply points into its slot. When the donor releases the
slot (``retire``/``cancel``/``snapshot``), the engine asks
``slot_released(slot)``: if any node still references the slot the tree
RETAINS it (the slot becomes tree-owned cache instead of returning to the
free list); otherwise the engine frees it normally. Tree-owned slots are
reclaimed by ``evict_for(n)`` — LRU over whole reclaimable slots, evicting
refcount-0 subtrees leaf-up — when the engine needs a free slot; eviction
never frees a node on any live request's path (refs pin the path, and a
pinned descendant pins every ancestor because eviction is leaf-only).

Invariants (tests/test_prefix.py, property-based + deterministic mirror):
refcounts never negative; per-slot row ranges disjoint and within the
ring; total referenced rows bounded by the pool; longest-match agrees
with a brute-force reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

TokenSeq = Tuple[int, ...]
Block = Tuple[int, int, int]          # (slot, row_lo, row_hi)


def _common_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


@dataclasses.dataclass(eq=False)
class PrefixNode:
    """One radix edge: a compressed token run backed by slot-pool rows
    ``[start, start + len(tokens))`` of ``slot`` (row == absolute
    position: the ring never wraps)."""
    tokens: TokenSeq
    slot: int
    start: int                        # absolute position of tokens[0]
    parent: Optional["PrefixNode"] = None
    refs: int = 0
    last_use: int = 0
    children: Dict[int, "PrefixNode"] = dataclasses.field(
        default_factory=dict)

    @property
    def end(self) -> int:
        return self.start + len(self.tokens)

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return (f"PrefixNode({list(self.tokens)!r}, slot={self.slot}, "
                f"rows=[{self.start},{self.end}), refs={self.refs})")


class PrefixTree:
    """Token-level radix tree over slot-pool KV rows (module docstring)."""

    def __init__(self):
        self.root = PrefixNode(tokens=(), slot=-1, start=0)
        self._clock = 0
        # every node backed by a given slot (edges + their split halves)
        self.nodes_by_slot: Dict[int, Set[PrefixNode]] = {}
        # slots whose donor request released them while nodes still
        # reference their rows — tree-owned cache, reclaimable by eviction
        self.owned: Set[int] = set()
        # stats ------------------------------------------------------------
        self.lookups = 0
        self.hits = 0                 # match() calls with n_hit > 0
        self.hit_tokens = 0           # total tokens served from cache
        self.inserted_rows = 0        # total rows ever cached by insert()
        self.evicted_nodes = 0
        self.reclaimed_slots = 0

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(s) for s in self.nodes_by_slot.values())

    def nodes(self) -> List[PrefixNode]:
        out: List[PrefixNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def cached_rows(self) -> int:
        """Total slot-pool rows currently referenced by the tree."""
        return sum(len(n.tokens) for n in self.nodes())

    # -- walk ----------------------------------------------------------------
    def _walk(self, tokens: TokenSeq, limit: Optional[int] = None
              ) -> Tuple[List[Tuple[PrefixNode, int]], int]:
        """Longest-prefix walk: returns ``([(node, n_matched_in_node)...],
        total_matched)``. The last entry may be a partial edge match; every
        earlier entry matches its node fully."""
        n_max = len(tokens) if limit is None else min(limit, len(tokens))
        node, i = self.root, 0
        path: List[Tuple[PrefixNode, int]] = []
        while i < n_max:
            child = node.children.get(tokens[i])
            if child is None:
                break
            m = _common_len(child.tokens, tokens[i:n_max])
            path.append((child, m))
            i += m
            if m < len(child.tokens):
                break
            node = child
        return path, i

    def peek(self, tokens: Sequence[int], limit: Optional[int] = None
             ) -> int:
        """Read-only longest cached prefix length (router scoring,
        admission charging): no refs, no splits, no LRU touch."""
        _, n = self._walk(tuple(int(t) for t in tokens), limit)
        return n

    # -- match / release (the live-request contract) -------------------------
    def match(self, tokens: Sequence[int], limit: Optional[int] = None
              ) -> Tuple[int, List[Block]]:
        """Longest cached prefix of ``tokens`` (capped at ``limit``):
        splits the final edge at the match boundary, pins the path
        (refs += 1 on every node whose rows the caller will copy), bumps
        LRU recency, and returns ``(n_hit, blocks)`` where the blocks'
        ``(slot, lo, hi)`` row ranges tile positions ``[0, n_hit)`` in
        order. The caller MUST pair every match having n_hit > 0 with one
        ``release(tokens, n_hit)``."""
        toks = tuple(int(t) for t in tokens)
        self.lookups += 1
        path, n = self._walk(toks, limit)
        if path:
            last, m = path[-1]
            if m < len(last.tokens):
                # split so the held span ends exactly at a node boundary;
                # existing holders of `last` all cover it fully (match
                # always leaves whole-node spans), so the new tail
                # inherits the refcount and release walks stay balanced
                self._split(last, m)
        self._clock += 1
        blocks: List[Block] = []
        for node, _ in path:
            node.refs += 1
            node.last_use = self._clock
            blocks.append((node.slot, node.start, node.end))
        if n:
            self.hits += 1
            self.hit_tokens += n
        return n, blocks

    def release(self, tokens: Sequence[int], n_hit: int) -> None:
        """Drop the refs a ``match(tokens) -> n_hit`` acquired. Walks the
        same token span; later splits only subdivide it into smaller
        whole nodes, so the walk visits exactly the held path."""
        if n_hit <= 0:
            return
        toks = tuple(int(t) for t in tokens)
        path, n = self._walk(toks, n_hit)
        assert n == n_hit, \
            f"release of unheld span: matched {n} of {n_hit} tokens"
        for node, m in path:
            assert m == len(node.tokens), "held span not node-aligned"
            node.refs -= 1
            assert node.refs >= 0, "refcount underflow"

    def _split(self, node: PrefixNode, at: int) -> PrefixNode:
        """Split ``node``'s edge after ``at`` tokens. The original object
        keeps the head (so existing path references stay valid); the new
        tail child inherits children, refcount, and recency."""
        assert 0 < at < len(node.tokens)
        tail = PrefixNode(tokens=node.tokens[at:], slot=node.slot,
                          start=node.start + at, parent=node,
                          refs=node.refs, last_use=node.last_use,
                          children=node.children)
        for gc in tail.children.values():
            gc.parent = tail
        node.tokens = node.tokens[:at]
        node.children = {tail.tokens[0]: tail}
        self.nodes_by_slot.setdefault(node.slot, set()).add(tail)
        return tail

    # -- insert --------------------------------------------------------------
    def insert(self, tokens: Sequence[int], slot: int) -> int:
        """Record that ``slot`` holds KV rows for ``tokens`` at positions
        ``0..len-1``. Creates at most ONE new edge (the un-cached suffix,
        backed by ``slot``); returns the number of newly cached rows (0 if
        the whole sequence was already present)."""
        toks = tuple(int(t) for t in tokens)
        assert slot >= 0
        path, n = self._walk(toks)
        self._clock += 1
        for node, _ in path:
            node.last_use = self._clock
        if n >= len(toks):
            return 0
        if path:
            last, m = path[-1]
            if m < len(last.tokens):
                self._split(last, m)         # diverge mid-edge
                parent = last
            else:
                parent = last
        else:
            parent = self.root
        child = PrefixNode(tokens=toks[n:], slot=slot, start=n,
                           parent=parent, last_use=self._clock)
        parent.children[toks[n]] = child
        self.nodes_by_slot.setdefault(slot, set()).add(child)
        self.inserted_rows += len(toks) - n
        return len(toks) - n

    # -- slot lifecycle ------------------------------------------------------
    def slot_released(self, slot: int) -> bool:
        """The donor request released ``slot``. True -> the tree still
        references its rows and RETAINS the slot (now tree-owned cache —
        the engine must NOT free it); False -> no references, the engine
        frees it normally."""
        if self.nodes_by_slot.get(slot):
            self.owned.add(slot)
            return True
        self.nodes_by_slot.pop(slot, None)
        return False

    def forget_slot(self, slot: int) -> None:
        """Drop every node backed by ``slot`` without freeing anything
        (the donor's rows became invalid while it still owns the slot —
        not used by the engine today, but the safe escape hatch). Refuses
        if any node on the subtree is pinned."""
        for node in list(self.nodes_by_slot.get(slot, ())):
            self._remove_subtree(node)
        self.nodes_by_slot.pop(slot, None)
        self.owned.discard(slot)

    # -- eviction ------------------------------------------------------------
    def _subtree_unpinned(self, node: PrefixNode) -> bool:
        """True iff the whole subtree at ``node`` could be evicted: no
        refs anywhere, and every backing slot is tree-owned (a node backed
        by a LIVE request's slot frees no memory and marks state the
        donor will re-offer at release)."""
        if node.refs > 0 or node.slot not in self.owned:
            return False
        return all(self._subtree_unpinned(c)
                   for c in node.children.values())

    def _slot_reclaimable(self, slot: int) -> bool:
        nodes = self.nodes_by_slot.get(slot)
        if not nodes or slot not in self.owned:
            return False
        return all(self._subtree_unpinned(n) for n in nodes)

    def n_reclaimable(self) -> int:
        """Tree-owned slots an ``evict_for`` call could free RIGHT NOW —
        the admission limit's slack on top of the engine's free list."""
        return sum(1 for s in self.owned if self._slot_reclaimable(s))

    def _remove_subtree(self, node: PrefixNode) -> None:
        assert node.refs == 0, "evicting a pinned node"
        for child in list(node.children.values()):
            self._remove_subtree(child)
        parent = node.parent
        assert parent is not None
        del parent.children[node.tokens[0]]
        node.parent = None
        s = self.nodes_by_slot.get(node.slot)
        if s is not None:
            s.discard(node)
        self.evicted_nodes += 1

    def evict_for(self, want: int) -> List[int]:
        """Reclaim up to ``want`` tree-owned slots, least-recently-used
        first (slot recency = the newest touch among its nodes). Evicting
        one slot's subtrees can cascade-free other owned slots whose only
        nodes hung beneath them; every freed slot is returned. Never
        touches a pinned path or a live request's slot."""
        freed: List[int] = []
        while len(freed) < want:
            cands = [s for s in self.owned if self._slot_reclaimable(s)]
            if not cands:
                break
            victim = min(cands, key=lambda s: (
                max(n.last_use for n in self.nodes_by_slot[s]), s))
            # leaf-up removal of every subtree rooted at the victim's
            # nodes; skip nodes a sibling subtree already removed
            for node in sorted(self.nodes_by_slot[victim],
                               key=lambda n: -n.start):
                if node.parent is not None:
                    self._remove_subtree(node)
            for s in list(self.owned):
                if not self.nodes_by_slot.get(s):
                    self.nodes_by_slot.pop(s, None)
                    self.owned.discard(s)
                    self.reclaimed_slots += 1
                    freed.append(s)
        return freed

    # -- invariants (exercised by tests/test_prefix.py) ----------------------
    def check_invariants(self, n_rows: Optional[int] = None) -> None:
        """Structural health: child keys match edge heads, parent links
        are consistent, refs are non-negative, per-slot row ranges are
        disjoint and within the ring, and the by-slot index matches the
        tree exactly."""
        seen_by_slot: Dict[int, List[Tuple[int, int]]] = {}
        stack = [self.root]
        while stack:
            n = stack.pop()
            assert n.refs >= 0
            for head, c in n.children.items():
                assert c.tokens and c.tokens[0] == head
                assert c.parent is n
                assert c.start == n.end   # positions are absolute
                stack.append(c)
            if n is self.root:
                continue
            assert n in self.nodes_by_slot.get(n.slot, set())
            seen_by_slot.setdefault(n.slot, []).append((n.start, n.end))
        for slot, ranges in seen_by_slot.items():
            ranges.sort()
            for (a0, b0), (a1, b1) in zip(ranges, ranges[1:]):
                assert b0 <= a1, f"overlapping rows on slot {slot}"
            if n_rows is not None:
                assert ranges[-1][1] <= n_rows, "rows beyond the ring"
        tree_nodes = set(self.nodes())
        index_nodes = {n for s in self.nodes_by_slot.values() for n in s}
        assert tree_nodes == index_nodes, "by-slot index out of sync"
        for s in self.owned:
            assert self.nodes_by_slot.get(s), "owned slot without nodes"
