"""The port's expert residency and scheduling policies against the
reference's: the same op sequence into both ledgers gives the same
``(kind, key)`` event stream, slot map, ``peak_resident`` and
``hbm_bound_ok``, and every policy plans identically (following
tests/test_cache_parity.py). The port's pools live on the CPU here."""
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import scheduler as jsched
from repro.core.state import StateConstructor as JStateConstructor
from repro.core.tracer import ExpertsTracer as JTracer
from repro_torch.core import cache as tcache
from repro_torch.core import scheduler as tsched
from repro_torch.core.state import StateConstructor
from repro_torch.core.tracer import ExpertsTracer

L_, E_, K_ = 3, 6, 2
D_, F_ = 8, 4


def _stores(seed=0):
    rng = np.random.default_rng(seed)
    w = {(l, e): (rng.standard_normal((D_, F_)).astype(np.float32),
                  rng.standard_normal((D_, F_)).astype(np.float32),
                  rng.standard_normal((F_, D_)).astype(np.float32))
         for l in range(L_) for e in range(E_)}
    ref = jcache.HostExpertStore(w)
    port = tcache.HostExpertStore(
        {k: tuple(torch.from_numpy(a) for a in v) for k, v in w.items()})
    return ref, port


def _events(state):
    return [(ev.kind, ev.key) for ev in state.events]


def _ops(seed, n=300):
    rng = np.random.default_rng(seed)
    kinds = ["admit", "admit_spec", "lookup", "prefetch", "slot", "unpin",
             "drop", "unpin_all"]
    p = np.array([6, 3, 4, 3, 3, 3, 1, 0.3])
    for _ in range(n):
        kind = kinds[rng.choice(len(kinds), p=p / p.sum())]
        yield kind, (int(rng.integers(L_)), int(rng.integers(E_)))


def _apply(res, kind, key):
    if kind == "admit":
        return res.admit(key, pinned=True)
    if kind == "admit_spec":
        return res.admit(key, pinned=False)
    if kind == "lookup":
        return res.lookup(key)
    if kind == "prefetch":
        return res.prefetch(key)
    if kind == "slot":
        return res.slot(key)
    if kind == "unpin":
        return res.unpin(key)
    if kind == "drop":
        return res.drop(key)
    return res.unpin_all()


@pytest.mark.parametrize("capacity,seed", [(4, 0), (4, 1), (2, 2), (7, 3)])
def test_residency_same_ops_same_ledger(capacity, seed):
    ref_store, port_store = _stores(seed)
    ref = jcache.ExpertResidency(ref_store, capacity)
    port = tcache.ExpertResidency(port_store, capacity, device="cpu")
    assert port.bytes_per_expert == ref.bytes_per_expert
    for kind, key in _ops(seed):
        assert _apply(port, kind, key) == _apply(ref, kind, key), (kind, key)
        assert port.slot_of == ref.slot_of
        assert port.resident == ref.resident
    assert _events(port) == _events(ref)
    assert (port.peak_resident, port.hits, port.misses, port.regrow_events) == \
        (ref.peak_resident, ref.hits, ref.misses, ref.regrow_events)
    assert port.hbm_bound_ok == ref.hbm_bound_ok
    assert port.device_bytes == ref.device_bytes
    assert [k for k, _ in port.transfer_log] == [k for k, _ in ref.transfer_log]
    # what a loaded slot holds is the expert's slab, in both
    for key, s in port.slot_of.items():
        if key in port._loaded:
            for pool, rpool, src in zip(port.pools, ref.pools, port_store.get(key)):
                assert torch.equal(pool[s], src)
                np.testing.assert_array_equal(pool[s].numpy(), np.asarray(rpool[s]))


def test_residency_regrow_matches_reference():
    """All-pinned growth past the pool: both regrow the same way and the
    bound predicate reports it."""
    ref_store, port_store = _stores(4)
    ref = jcache.ExpertResidency(ref_store, 2)
    port = tcache.ExpertResidency(port_store, 2, device="cpu")
    for e in range(4):
        for res in (ref, port):
            res.admit((0, e), pinned=True)
            res.prefetch((0, e))
    assert port.pool_capacity == ref.pool_capacity > 2
    assert port.regrow_events == ref.regrow_events == 2
    assert not port.hbm_bound_ok and not ref.hbm_bound_ok
    assert port.slot_of == ref.slot_of
    port.unpin_all()
    ref.unpin_all()
    assert _events(port) == _events(ref)


class _StubPredictor:
    """Deterministic stand-in for the ExpertMLP: ranks experts by a fixed
    projection of the state vector (the same object drives both policies)."""

    def __init__(self, dim):
        self.w = np.random.default_rng(9).standard_normal((dim, E_))

    def predict_topk(self, x, k=None):
        return np.argsort(-(np.asarray(x) @ self.w), axis=-1)[..., :k]


def _plans(mod, sc_cls, tracer_cls, policy, paths, prefill_active, state):
    tracer = tracer_cls(L_, E_, K_)
    tracer.add_paths(paths)
    stats = tracer.stats()
    sc = sc_cls(stats)
    sched = mod.make_scheduler(policy, L_, E_, K_, 100, stats=stats,
                               predictor=_StubPredictor(sc.feature_dim),
                               state_constructor=sc,
                               capacity=max(mod.default_capacity(policy, L_, E_, K_), E_),
                               state=state)
    out = []
    for req in range(2):
        sched.begin_request()
        for l in range(L_):
            out.append(sched.prefill_plan(l, prefill_active[req][l]))
            sched.end_layer(l)
        for step in paths[req * 4:(req + 1) * 4]:
            if hasattr(sched, "begin_decode_step"):
                sched.begin_decode_step()
            for l in range(L_):
                out.append(sched.decode_plan(l, list(step[l])))
            sched.end_layer(L_ - 1)
    return out, sched


@pytest.mark.parametrize("policy", ["odf", "lfp", "mif", "duo", "duo+"])
def test_policies_plan_identically(policy):
    rng = np.random.default_rng(11)
    paths = np.stack([np.stack([rng.choice(E_, K_, replace=False)
                                for _ in range(L_)]) for _ in range(8)])
    prefill_active = [[sorted(rng.choice(E_, 4, replace=False).tolist())
                       for _ in range(L_)] for _ in range(2)]
    ref_store, port_store = _stores(5)
    cap = max(tsched.default_capacity(policy, L_, E_, K_), E_)
    assert cap == max(jsched.default_capacity(policy, L_, E_, K_), E_)
    rplans, rs = _plans(jsched, JStateConstructor, JTracer, policy, paths,
                        prefill_active, jcache.ExpertResidency(ref_store, cap))
    pplans, ps = _plans(tsched, StateConstructor, ExpertsTracer, policy, paths,
                        prefill_active,
                        tcache.ExpertResidency(port_store, cap, device="cpu"))
    assert [type(p).__name__ for p in pplans] == [type(p).__name__ for p in rplans]
    assert [p.__dict__ for p in pplans] == [p.__dict__ for p in rplans]
    assert _events(ps.cache) == _events(rs.cache)
    assert ps.cache.peak_resident == rs.cache.peak_resident
    assert (ps.decode_hits, ps.decode_misses) == (rs.decode_hits, rs.decode_misses)
    assert ps.cache.hbm_bound_ok == rs.cache.hbm_bound_ok


def test_union_selection_and_capacities_match():
    for sel in ([np.array([[3, 1], [1, 2]])], [(5,), [np.int32(5), 0]], [[], [7]]):
        assert tsched.union_selection(sel) == jsched.union_selection(sel)
    for policy in ("odf", "lfp", "mif", "duo", "duo+"):
        for batch in (1, 3):
            assert tsched.default_capacity(policy, 32, 8, 2, batch) == \
                jsched.default_capacity(policy, 32, 8, 2, batch)
