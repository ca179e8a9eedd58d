"""Expert residency: one ledger, fixed slot-pool buffers on the card.

Port of ``repro.core.cache``. ``CacheState`` is the reference's ledger,
rule for rule (LRU among unpinned entries, pins, declined speculative
admissions, shrink on unpin, events, ``peak_resident``). ``HostExpertStore``
holds every routed-expert slab in host memory — pinned when the engine runs
on the card, so the copies can be asynchronous. ``ExpertResidency`` mirrors
every ledger decision into ``[capacity, d, de]`` / ``[capacity, de, d]``
pools allocated once on the engine's device.

On the card this is the paper's two-stream mechanism itself:

  * ``prefetch`` copies a slab into its slot on a dedicated copy stream
    (``copy_(pinned, non_blocking=True)``) and records a per-slot "ready"
    event;
  * ``slot`` makes the compute stream wait on that event (use-time sync
    point) and ``wait`` blocks the host on it (sync point #1, the decode
    correction fetch);
  * ``mark_used`` records a per-slot "last use" event on the compute stream
    after a kernel that reads the slot is queued, and a copy into a reused
    slot first waits on it — so a new slab never overwrites weights that
    queued compute is still reading. (The JAX version never needed this:
    each pool write produced a fresh array.)

On the CPU the copies are synchronous and there are no events.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch

ExpertKey = Tuple[int, int]  # (layer, expert)


class HostExpertStore:
    """Host-memory store of per-expert FFN weights (w1, w3, w2)."""

    def __init__(self, weights: Dict[ExpertKey, Tuple[torch.Tensor, ...]]):
        self.weights = weights
        any_w = next(iter(weights.values()))
        self.bytes_per_expert = sum(a.nbytes for a in any_w)

    @staticmethod
    def from_params(layer_moe_params, n_layers: int, n_experts: int,
                    pin: bool = False) -> "HostExpertStore":
        """layer_moe_params: stacked MoE params {'w1': [L,E,d,de], ...}.
        Slabs are views of host tensors (``init_params`` and
        ``params_from_jax`` already place them in pinned memory for a CUDA
        engine); a tensor on the card, or an unpinned one when ``pin``, is
        copied to pinned host memory first."""
        stacks = {}
        for name in ("w1", "w3", "w2"):
            t = layer_moe_params[name]
            if t.is_cuda or (pin and not t.is_pinned()):
                t = t.cpu().pin_memory() if pin else t.cpu()
            stacks[name] = t
        w = {(l, e): (stacks["w1"][l, e], stacks["w3"][l, e], stacks["w2"][l, e])
             for l in range(n_layers) for e in range(n_experts)}
        return HostExpertStore(w)

    def get(self, key: ExpertKey):
        return self.weights[key]


@dataclasses.dataclass
class CacheEvent:
    kind: str            # 'fetch' | 'hit' | 'evict'
    key: ExpertKey
    t_issue: float       # host wall-clock when issued (engine) / sim time
    bytes: int = 0


class CacheState:
    """Residency bookkeeping (verbatim from the reference).

    capacity: max resident experts (global across layers). Eviction is LRU
    among non-pinned entries; `pin`/`unpin` protect experts between prefetch
    and use. Every residency mutation funnels through `_on_admit` /
    `_on_evict` hooks so ExpertResidency can mirror the ledger into device
    slots. Residency exceeds capacity ONLY while every entry is pinned.
    """

    def __init__(self, capacity: int, bytes_per_expert: int):
        self.capacity = capacity
        self.bytes_per_expert = bytes_per_expert
        self.resident: "collections.OrderedDict[ExpertKey, bool]" = \
            collections.OrderedDict()  # key -> pinned
        self.events: List[CacheEvent] = []
        self.peak_resident = 0
        self.hits = 0
        self.misses = 0

    def _on_admit(self, key: ExpertKey) -> None:
        """Called exactly once when `key` newly becomes resident."""

    def _on_evict(self, key: ExpertKey) -> None:
        """Called exactly once when `key` leaves residency (any path)."""

    def contains(self, key: ExpertKey) -> bool:
        return key in self.resident

    def touch(self, key: ExpertKey) -> None:
        self.resident.move_to_end(key)

    def residency_overlap(self, keys: Iterable[ExpertKey]) -> int:
        """How many of `keys` are resident (read-only probe: no LRU touch,
        no accounting, no events)."""
        resident = self.resident
        return sum(1 for k in keys if k in resident)

    def lookup(self, key: ExpertKey, t: float = 0.0) -> bool:
        if key in self.resident:
            self.hits += 1
            self.touch(key)
            self.events.append(CacheEvent("hit", key, t))
            return True
        self.misses += 1
        return False

    def admit(self, key: ExpertKey, t: float = 0.0, pinned: bool = True
              ) -> List[ExpertKey]:
        """Admit key, evicting LRU unpinned entries if needed. A pinned
        admission into an all-pinned full cache grows it; an unpinned one
        is declined (callers check `contains`). Returns evicted keys."""
        evicted = []
        if key in self.resident:
            self.resident[key] = pinned or self.resident[key]
            self.touch(key)
            return evicted
        while len(self.resident) >= self.capacity:
            victim = None
            for k, pin in self.resident.items():
                if not pin:
                    victim = k
                    break
            if victim is None:  # everything pinned
                if not pinned:
                    return evicted  # decline the speculative admission
                break               # grow (sized engines never reach this)
            del self.resident[victim]
            self._on_evict(victim)
            self.events.append(CacheEvent("evict", victim, t))
            evicted.append(victim)
        self.resident[key] = pinned
        self._on_admit(key)
        self.events.append(
            CacheEvent("fetch", key, t, self.bytes_per_expert))
        self.peak_resident = max(self.peak_resident, len(self.resident))
        return evicted

    def drop(self, key: ExpertKey, t: float = 0.0) -> bool:
        """Remove `key` without an evict event (ODF free-after-forward);
        the device mirror still frees the slot."""
        if key in self.resident:
            del self.resident[key]
            self._on_evict(key)
            return True
        return False

    def unpin(self, key: ExpertKey, t: float = 0.0) -> List[ExpertKey]:
        """Unpin `key`; shrink back to capacity if the cache had grown."""
        if key in self.resident:
            self.resident[key] = False
            return self._shrink(t)
        return []

    def unpin_all(self, t: float = 0.0) -> List[ExpertKey]:
        for k in self.resident:
            self.resident[k] = False
        return self._shrink(t)

    def _shrink(self, t: float = 0.0) -> List[ExpertKey]:
        evicted = []
        while len(self.resident) > self.capacity:
            victim = None
            for k, pin in self.resident.items():
                if not pin:
                    victim = k
                    break
            if victim is None:
                break
            del self.resident[victim]
            self._on_evict(victim)
            self.events.append(CacheEvent("evict", victim, t))
            evicted.append(victim)
        return evicted

    def rescale(self, new_capacity: int) -> None:
        """Raise the residency bound (grow-only)."""
        if new_capacity < self.capacity:
            raise ValueError(
                f"rescale is grow-only ({self.capacity} -> {new_capacity})")
        self.capacity = new_capacity

    @property
    def peak_bytes(self) -> int:
        return self.peak_resident * self.bytes_per_expert

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class ExpertResidency(CacheState):
    """THE ledger fused with the device expert pools (one mechanism).

    The scheduler shares this object by reference and performs all
    plan-time ledger ops on it; `_on_admit`/`_on_evict` map admissions to
    pool-slot allocations and evictions to slot frees
    (``set(slot_of) == set(resident)`` at all times). `prefetch(key)` issues
    the host->device copy of an admitted key; `slot(key)` is the use-time
    sync point. If a must-have admission grows an all-pinned ledger past
    the pool, the pool regrows (`regrow_events`) rather than corrupting a
    live slot.
    """

    def __init__(self, store: HostExpertStore, capacity: int, device="cuda"):
        super().__init__(capacity, store.bytes_per_expert)
        self.store = store
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        w1, w3, w2 = next(iter(store.weights.values()))
        self.pool_capacity = capacity
        self._pools: Dict[str, torch.Tensor] = {
            n: torch.zeros((capacity,) + tuple(w.shape), dtype=w.dtype,
                           device=self.device)
            for n, w in (("w1", w1), ("w3", w3), ("w2", w2))}
        self.slot_of: Dict[ExpertKey, int] = {}
        self._free: List[int] = list(range(capacity))[::-1]
        self._loaded: Set[ExpertKey] = set()
        self.transfer_log: List[Tuple[ExpertKey, float]] = []
        self.regrow_events = 0
        self._ready: List[Optional[torch.cuda.Event]] = [None] * capacity
        self._last_use: List[Optional[torch.cuda.Event]] = [None] * capacity
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            # the pools' zero fill runs on the compute stream
            self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))

    # -- ledger -> device mirroring -----------------------------------------
    def _on_admit(self, key: ExpertKey) -> None:
        if not self._free:
            self._regrow(self.pool_capacity + max(1, self.pool_capacity // 2))
        self.slot_of[key] = self._free.pop()

    def _on_evict(self, key: ExpertKey) -> None:
        slot = self.slot_of.pop(key, None)
        if slot is not None:
            self._free.append(slot)
            self._loaded.discard(key)

    def _regrow(self, new_pool_capacity: int) -> None:
        if self._cuda:   # no copy or kernel may touch the old pools after this
            torch.cuda.synchronize(self.device)
        grown = new_pool_capacity - self.pool_capacity
        for name, pool in self._pools.items():
            pad = torch.zeros((grown,) + tuple(pool.shape[1:]), dtype=pool.dtype,
                              device=self.device)
            self._pools[name] = torch.cat([pool, pad], dim=0)
        self._free.extend(range(self.pool_capacity, new_pool_capacity))
        self._ready.extend([None] * grown)
        self._last_use.extend([None] * grown)
        self.pool_capacity = new_pool_capacity
        self.regrow_events += 1

    def rescale(self, new_capacity: int) -> None:
        super().rescale(new_capacity)
        if new_capacity > self.pool_capacity:
            self._regrow(new_capacity)
            self.regrow_events -= 1  # provisioning, not an overflow event

    # -- device transfers ----------------------------------------------------
    def prefetch(self, key: ExpertKey) -> bool:
        """Issue the host->device copy of an already-admitted key; on the
        card it runs on the copy stream and overlaps compute queued after
        it. Returns True if the key was already loaded; no-op (False) for
        keys the ledger declined."""
        slot = self.slot_of.get(key)
        if slot is None:
            return False
        if key in self._loaded:
            return True
        slabs = self.store.get(key)
        if self._cuda:
            cs = self._copy_stream
            if self._last_use[slot] is not None:
                cs.wait_event(self._last_use[slot])
            with torch.cuda.stream(cs):
                for name, src in zip(("w1", "w3", "w2"), slabs):
                    self._pools[name][slot].copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(cs)
            self._ready[slot] = ev
        else:
            for name, src in zip(("w1", "w3", "w2"), slabs):
                self._pools[name][slot].copy_(src)
        self._loaded.add(key)
        self.transfer_log.append((key, time.perf_counter()))
        return False

    def slot(self, key: ExpertKey) -> int:
        """Use-time access: the slot of a resident key, issuing its copy if
        still pending and ordering the compute stream after it. A
        non-resident key is a scheduler/engine bug; the correction admit
        records honest ledger events so parity tests surface it."""
        if key not in self.slot_of:
            self.admit(key, time.perf_counter(), pinned=True)
        self.prefetch(key)
        s = self.slot_of[key]
        if self._cuda and self._ready[s] is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready[s])
        return s

    def mark_used(self, slots: Sequence[int]) -> None:
        """Record that compute just queued on the current stream reads
        ``slots``; a later copy into one of them waits for it."""
        if not self._cuda:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        for s in slots:
            self._last_use[int(s)] = ev

    @property
    def pools(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Current (w1, w3, w2) slot-pool tensors (re-read after a regrow)."""
        return self._pools["w1"], self._pools["w3"], self._pools["w2"]

    def wait(self, key: ExpertKey) -> None:
        """Sync point: block the host until the expert's weights are on
        the device."""
        s = self.slot(key)
        if self._cuda and self._ready[s] is not None:
            self._ready[s].synchronize()

    @property
    def device_bytes(self) -> int:
        """Actual expert device footprint — the fixed pool allocation."""
        return sum(p.nbytes for p in self._pools.values())

    @property
    def hbm_bound_ok(self) -> bool:
        """Device bytes equal the fixed ``capacity * bytes_per_expert``
        allocation and the pool never regrew past its sizing."""
        return (self.device_bytes
                == self.pool_capacity * self.bytes_per_expert
                and self.regrow_events == 0
                and self.pool_capacity == self.capacity)
