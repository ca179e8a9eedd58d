"""The port's snapshot / restore consumers against the JAX package's:
pause / resume, the disaggregated prefill -> decode handoff, autopilot
preemption and replica draining (``repro_torch.serving`` vs
``repro.serving``).

The scenarios of tests/test_snapshot.py, each driven through both packages
by the same calls (tests/torch_serving_parity.py says what is compared,
``n_handoffs``, ``n_migrated``, ``handoff_bytes`` and
``handoff_bytes_saved`` among it): pause / resume at every decode depth
and at three prefill-chunk depths, a queued pause and the restore guards,
a 1-prefill + 1-decode cluster and one whose single decode slot makes
handoffs wait, preemption and its strict-priority rule, cancel while
paused, ``drain`` mid-flight, the tail-only handoff over a warm prefix and
a prefix-seeded request paused mid-decode and mid-prefill. Every resumed,
handed-off or migrated stream must also equal the same prompt served alone.
"""
import numpy as np
import pytest

from torch_serving_parity import (MAX_NEW, assert_parity, poll_until,
                                  reference_setup)


@pytest.fixture(scope="module")
def setup():
    with reference_setup() as s:
        rng = np.random.default_rng(3)
        s["prompts"] = [rng.integers(0, s["vocab"], size=n).astype(np.int32)
                        for n in (12, 16, 9, 14)]
        s["solo"] = {}
        yield s


def solo(side, setup, prompt):
    """``prompt`` served alone, greedy, through a raw engine (cached per
    package and prompt)."""
    key = (side.name, prompt.tobytes())
    if key not in setup["solo"]:
        eng = side.batching.BatchedServingEngine(
            side.cfg, side.params, **side._kw(dict(max_batch=2,
                                                   prefill_budget=3,
                                                   spans=False)))
        req = eng.submit(prompt, max_new=MAX_NEW)
        eng.run_until_drained()
        setup["solo"][key] = list(req.tokens)
    return setup["solo"][key]


def _depth(side, setup, depth):
    prompts = setup["prompts"]
    fe = side.fe(max_batch=2, prefill_budget=3)
    eng = fe.engine
    h = fe.submit(side.spec(prompts[0]))
    poll_until(fe, lambda: len(h.tokens) >= depth)
    d = len(h.tokens)
    snap = fe.pause(h)
    assert h.status == "paused" and snap.state == "running"
    assert snap.n_tokens == d and len(snap.tbt_gaps) == d - 1
    assert len(eng._free) == eng.max_batch
    ld = eng.load()
    assert ld.running == 0 and ld.decode_backlog == 0
    other = fe.submit(side.spec(prompts[2]))
    fe.drain()
    fe.resume(snap, handle=h)
    assert len(eng._free) == eng.max_batch - 1
    fe.drain()
    assert list(h.tokens) == solo(side, setup, prompts[0])
    assert list(other.tokens) == solo(side, setup, prompts[2])
    return side.record([h, other], kv_bytes=snap.kv_bytes,
                       gaps=len(eng.tbt.by_rid.get(h.rid, ())))


@pytest.mark.parametrize("depth", range(1, MAX_NEW + 1))
def test_pause_resume_every_decode_depth_parity(setup, depth):
    assert_parity(setup, _depth, setup, depth)


def _mid_prefill(side, setup, polls):
    prompts = setup["prompts"]
    fe = side.fe(max_batch=2, prefill_budget=3)
    h = fe.submit(side.spec(prompts[1]))
    for _ in range(polls):
        fe.poll()
    snap = fe.pause(h)
    assert snap.state == "prefilling" and snap.n_tokens == 0
    assert 0 < snap.prefill_pos < len(prompts[1])
    fe.resume(snap, handle=h)
    fe.drain()
    assert list(h.tokens) == solo(side, setup, prompts[1])
    return side.record([h], kv_bytes=snap.kv_bytes,
                       prefill_pos=snap.prefill_pos)


@pytest.mark.parametrize("polls", [1, 2, 3])
def test_pause_resume_mid_prefill_parity(setup, polls):
    assert_parity(setup, _mid_prefill, setup, polls)


def _queued_and_guards(side, setup):
    prompts = setup["prompts"]
    fe = side.fe(max_batch=2, prefill_budget=3)
    eng = fe.engine
    h1, h2, h3 = [fe.submit(side.spec(prompts[i])) for i in (0, 2, 3)]
    fe.poll()
    snap = fe.pause(h3)
    assert snap.state == "queued" and snap.kv_bytes == 0
    run_snap = fe.pause(h1)
    assert run_snap.state == "prefilling"
    h_fill = fe.submit(side.spec(prompts[1]))
    fe.poll()
    assert not eng._free and not eng.can_restore(run_snap)
    with pytest.raises((AssertionError, RuntimeError)):
        eng.restore(run_snap)
    assert eng.can_restore(snap)
    fe.resume(snap, handle=h3)
    assert h3.status == "queued"
    fe.drain()
    fe.resume(run_snap, handle=h1)
    fe.drain()
    for h, i in ((h1, 0), (h2, 2), (h3, 3), (h_fill, 1)):
        assert list(h.tokens) == solo(side, setup, prompts[i])
    return side.record([h1, h2, h3, h_fill])


def test_pause_resume_queued_and_restore_guards_parity(setup):
    assert_parity(setup, _queued_and_guards, setup)


def _disagg(side, setup):
    prompts = setup["prompts"]
    pool = side.pool(max_batch=2, prefill_budget=3,
                     overrides=[{"role": "prefill"}, {"role": "decode"}])
    fe = side.cluster_fe(pool, "disagg")
    handles = [fe.submit(side.spec(p)) for p in prompts]
    assert all(h.replica == 0 for h in handles)
    fe.drain()
    for h, p in zip(handles, prompts):
        assert list(h.tokens) == solo(side, setup, p)
        assert h.replica == 1 and len(h.handoffs) == 1
        assert h.handoffs[0]["t_restore"] >= h.handoffs[0]["t_snapshot"]
    assert pool.n_handoffs == len(prompts)
    assert pool.engines[0].decode_batch_hist == []
    assert all(e.cache.regrow_events == 0 for e in pool.engines)
    return side.record(handles, pool,
                       finished=[len(e.finished) for e in pool.engines])


def test_disagg_cluster_parity(setup):
    assert_parity(setup, _disagg, setup)


def _disagg_waits(side, setup):
    prompts = setup["prompts"]
    pool = side.pool(prefill_budget=3,
                     overrides=[{"role": "prefill", "max_batch": 4},
                                {"role": "decode", "max_batch": 1}])
    fe = side.cluster_fe(pool, "disagg")
    handles = [fe.submit(side.spec(p)) for p in prompts]
    held = []
    while not fe.idle:
        fe.poll()
        held.append(len(pool.engines[0].held))
    assert max(held) >= 2
    for h, p in zip(handles, prompts):
        assert list(h.tokens) == solo(side, setup, p)
    return side.record(handles, pool, held=held)


def test_disagg_handoff_waits_for_decode_slot_parity(setup):
    assert_parity(setup, _disagg_waits, setup)


def _preempt(side, setup):
    prompts = setup["prompts"]
    fe = side.fe(max_batch=1, prefill_budget=3)
    ap = side.autopilot(fe, preempt=True)
    lo = fe.submit(side.spec(prompts[0], priority=0))
    poll_until(fe, lambda: len(lo.tokens) >= 2)
    hi = fe.submit(side.spec(prompts[2], priority=5))
    fe.poll()
    assert lo.status == "paused" and ap.n_preempted == 1
    kv = ap.paused_kv_bytes
    assert kv > 0 and not fe.idle
    fe.drain()
    assert ap.n_resumed == 1 and not ap.paused
    assert list(hi.tokens) == solo(side, setup, prompts[2])
    assert list(lo.tokens) == solo(side, setup, prompts[0])
    return side.record([lo, hi], autopilot=ap, paused_kv_bytes=kv)


def test_preempt_pauses_victim_parity(setup):
    assert_parity(setup, _preempt, setup)


def _preempt_equal(side, setup):
    prompts = setup["prompts"]
    fe = side.fe(max_batch=1, prefill_budget=3)
    ap = side.autopilot(fe, preempt=True)
    first = fe.submit(side.spec(prompts[0], priority=3))
    poll_until(fe, lambda: len(first.tokens) >= 1)
    second = fe.submit(side.spec(prompts[2], priority=3))
    fe.poll()
    assert second.status == "queued"
    fe.drain()
    assert ap.n_preempted == 0
    return side.record([first, second], autopilot=ap)


def test_preempt_requires_strictly_higher_priority_parity(setup):
    assert_parity(setup, _preempt_equal, setup)


def _cancel_paused(side, setup):
    prompts = setup["prompts"]
    fe = side.fe(max_batch=1, prefill_budget=3)
    ap = side.autopilot(fe, preempt=True)
    lo = fe.submit(side.spec(prompts[0], priority=0))
    poll_until(fe, lambda: len(lo.tokens) >= 1)
    hi = fe.submit(side.spec(prompts[2], priority=5))
    fe.poll()
    assert lo.status == "paused"
    assert lo.cancel() and lo.finish_reason == "cancelled"
    assert not ap.paused and ap.paused_kv_bytes == 0
    fe.drain()
    return side.record([lo, hi], autopilot=ap)


def test_cancel_while_paused_parity(setup):
    assert_parity(setup, _cancel_paused, setup)


def _drain(side, setup):
    prompts = setup["prompts"]
    pool = side.pool(2, max_batch=4, prefill_budget=3)
    fe = side.cluster_fe(pool, "round_robin")
    handles = [fe.submit(side.spec(p)) for p in prompts]
    for _ in range(3):
        fe.poll()
    moved = pool.drain(0)
    assert 0 not in pool.routable()
    rerouted = fe.submit(side.spec(prompts[2], max_new=2))
    assert rerouted.replica == 1
    fe.drain()
    assert pool.engines[0].idle and pool.n_migrated >= 1
    for h, p in zip(handles, prompts):
        assert list(h.tokens) == solo(side, setup, p) and h.replica == 1
    pool.undrain(0)
    back = fe.submit(side.spec(prompts[0], max_new=1))
    fe.drain()
    return side.record(handles + [rerouted, back], pool, moved=moved)


def test_drain_migrates_in_flight_parity(setup):
    assert_parity(setup, _drain, setup)


def _tail_handoff(side, setup):
    rng = np.random.default_rng(11)
    vocab = setup["vocab"]
    head = rng.integers(0, vocab, size=8).astype(np.int32)
    shared = [np.concatenate([head, rng.integers(0, vocab, size=n)
                              .astype(np.int32)]) for n in (5, 6)]
    shared[1][8] = (shared[0][8] + 1) % vocab

    def run(prefix_cache):
        pool = side.pool(max_batch=2, prefill_budget=3,
                         prefix_cache=prefix_cache,
                         overrides=[{"role": "prefill"}, {"role": "decode"}])
        fe = side.cluster_fe(pool, "disagg")
        hs = []
        for p in shared:
            hs.append(fe.submit(side.spec(p)))
            fe.drain()
        return pool, hs

    cold_pool, cold = run(False)
    warm_pool, warm = run(True)
    refs = [solo(side, setup, p) for p in shared]
    assert [list(h.tokens) for h in cold] == refs
    assert [list(h.tokens) for h in warm] == refs
    assert warm_pool.n_tail_handoffs == 1
    assert warm_pool.handoff_bytes_saved == 8 * side.batching.kv_row_bytes(
        warm_pool.engines[0])
    assert (warm_pool.handoff_bytes + warm_pool.handoff_bytes_saved
            == cold_pool.handoff_bytes)
    rec = side.record(cold + warm, warm_pool)
    rec["cold_pool"] = side.record(pool=cold_pool)["pool"]
    return rec


def test_disagg_tail_handoff_parity(setup):
    assert_parity(setup, _tail_handoff, setup)


def _prefix_pause(side, setup):
    rng = np.random.default_rng(12)
    vocab = setup["vocab"]
    donor = rng.integers(0, vocab, size=14).astype(np.int32)
    probe = np.concatenate([donor[:9], rng.integers(0, vocab, size=6)
                            .astype(np.int32)])
    probe[9] = (donor[9] + 1) % vocab
    ref = solo(side, setup, probe)
    handles = []
    for mid_prefill in (False, True):
        fe = side.fe(max_batch=2, prefill_budget=3, prefix_cache=True)
        fe.submit(side.spec(donor))
        fe.drain()
        h = fe.submit(side.spec(probe))
        if mid_prefill:
            fe.poll()
            assert h.status == "prefilling"
        else:
            poll_until(fe, lambda: len(h.tokens) >= 2)
        snap = fe.pause(h)
        assert snap.state == ("prefilling" if mid_prefill else "running")
        fe.resume(snap, h)
        fe.drain()
        assert list(h.tokens) == ref and fe.engine.prefix.hit_tokens == 9
        fe.engine.prefix.check_invariants(fe.engine.W)
        handles.append(h)
    return side.record(handles)


def test_preempt_resume_prefix_reusing_request_parity(setup):
    assert_parity(setup, _prefix_pause, setup)
