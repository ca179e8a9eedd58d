"""The port's continuous-batching engine against itself: the exactness
contracts of tests/test_serving_batch.py, test_prefix.py and
test_snapshot.py held inside the port (no JAX), on a reduced Mixtral.

  * ``grouped_decode=False`` batched == the single-request engine run
    request by request, bit for bit (both take the einsum's numbers);
  * the grouped sweep (the expert kernel's numbers) is batch invariant: a
    batch of B gives each request the logits, tokens and traces it gets
    alone at ``max_batch=1``;
  * chunked prefill == monolithic for every chunk size and fairness;
  * cancellation, snapshot / restore, prefix reuse, roles and admission
    keep the residency bounded and the survivors' tokens unchanged.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.qos import AdmissionController, LatencyModel
from repro_torch.models.params import init_params
from repro_torch.serving.api import (FinishEvent, GenerationRequest,
                                     RejectEvent, SamplingParams, TokenEvent,
                                     as_request_spec)
from repro_torch.serving.batching import (BatchedServingEngine, RequestQueue,
                                          kv_row_bytes, parse_prefill_budget)
from repro_torch.serving.engine import MoEServingEngine

MAX_NEW = 5


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mixtral_8x7b"))
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (12, 16, 9, 14)]
    seq = MoEServingEngine(cfg, params, policy="duo", temperature=0.0)
    refs = [seq.serve(p, max_new=MAX_NEW) for p in prompts]
    return cfg, params, prompts, refs


def _engine(setup, **kw):
    cfg, params, _, _ = setup
    kw = dict(dict(policy="duo", max_batch=4, max_seq=32, temperature=0.0),
              **kw)
    return BatchedServingEngine(cfg, params, **kw)


def _logged(eng):
    """Record every logits row the engine samples from, per request."""
    rows = {}
    sample = eng._sample_req

    def record(req, row):
        rows.setdefault(req.rid, []).append(np.array(row))
        return sample(req, row)

    eng._sample_req = record
    return rows


def _drain(eng, prompts, **kw):
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW, **kw)
    return sorted(eng.run_until_drained(), key=lambda r: r.rid)


def _residency_ok(eng):
    c = eng.cache
    assert c.hbm_bound_ok
    assert set(c.slot_of) == set(c.resident)
    assert len(c.resident) <= c.capacity
    assert not any(c.resident.values()), "pins outlived the step"
    assert len(c._free) + len(c.slot_of) == c.pool_capacity


@pytest.mark.parametrize("B,max_batch", [(1, 1), (2, 2), (4, 4), (4, 2)])
def test_dense_batched_matches_sequential(setup, B, max_batch):
    """The dense baseline reproduces the single-request engine bit for
    bit, also when later requests are admitted as slots free up."""
    _, _, prompts, refs = setup
    eng = _engine(setup, max_batch=max_batch, grouped_decode=False)
    finished = _drain(eng, prompts[:B])
    assert max(eng.decode_batch_hist) == max_batch
    for r, ref in zip(finished, refs):
        np.testing.assert_array_equal(r.result().tokens, ref.tokens)
        np.testing.assert_array_equal(r.result().decode_trace,
                                      ref.decode_trace)
        assert r.prefill_active == ref.prefill_active
    _residency_ok(eng)


@pytest.mark.parametrize("B", [1, 2, 4])
def test_grouped_batch_invariant(setup, B):
    """Grouped decode: each request's logits, tokens and traces in a batch
    of B equal those it gets alone at max_batch=1."""
    _, _, prompts, _ = setup
    batched = _engine(setup, max_batch=B)
    rows_b = _logged(batched)
    got = _drain(batched, prompts[:B])
    assert max(batched.decode_batch_hist) == B
    alone = _engine(setup, max_batch=1)
    rows_1 = _logged(alone)
    want = _drain(alone, prompts[:B])
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.result().tokens, w.result().tokens)
        np.testing.assert_array_equal(r.result().decode_trace,
                                      w.result().decode_trace)
        for a, b in zip(rows_b[r.rid], rows_1[w.rid]):
            np.testing.assert_array_equal(a, b)
    assert batched.perf.decode_ffn_launches == batched.perf.decode_layers
    assert batched.perf.decode_rows_grouped <= batched.perf.decode_rows_dense


@pytest.mark.parametrize("chunk", [1, 3, "S"])
@pytest.mark.parametrize("fairness", ["rr", "fifo", "srf"])
def test_chunked_batched_matches_monolithic(setup, chunk, fairness):
    _, _, prompts, _ = setup
    mono = _engine(setup)
    rows_m = _logged(mono)
    want = _drain(mono, prompts)
    budget = max(len(p) for p in prompts) if chunk == "S" else chunk
    eng = _engine(setup, prefill_budget=budget, prefill_fairness=fairness)
    rows_c = _logged(eng)
    got = _drain(eng, prompts)
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.result().tokens, w.result().tokens)
        assert r.prefill_active == w.prefill_active
        np.testing.assert_array_equal(rows_c[r.rid][0], rows_m[w.rid][0])
    assert eng.prefilled_tokens == sum(len(p) for p in prompts)
    _residency_ok(eng)


def test_fairness_orders(setup):
    """rr rotates the per-step budget, fifo serves the head, srf the
    shortest remaining prompt first."""
    _, _, prompts, _ = setup
    pos = {}
    for fairness in ("rr", "fifo", "srf"):
        eng = _engine(setup, prefill_budget=4, prefill_fairness=fairness)
        for p in prompts:
            eng.submit(p, max_new=MAX_NEW)
        eng.step()
        eng.step()
        pos[fairness] = {r.rid: r.prefill_pos for r in eng.prefilling}
    assert pos["rr"] == {0: 4, 1: 4, 2: 0, 3: 0}
    assert pos["fifo"] == {0: 8, 1: 0, 2: 0, 3: 0}
    assert pos["srf"] == {0: 0, 1: 0, 2: 8, 3: 0}


@pytest.mark.parametrize("when", ["prefilling", "running"])
def test_cancel_releases_and_survivors_unchanged(setup, when):
    _, _, prompts, refs = setup
    eng = _engine(setup, prefill_budget=4, prefill_fairness="fifo",
                  grouped_decode=False)
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    victim = reqs[1]
    while victim.state != when:
        eng.step()
    if when == "running":
        eng.step()
    slot = victim.slot
    assert eng.cancel(victim) and not eng.cancel(victim)
    assert victim.state == "cancelled" and victim.finish_reason == "cancelled"
    assert slot in eng._free and (eng._slot_pos[slot] == -1).all()
    _residency_ok(eng)
    evs = eng.drain_events()
    assert [type(e) for e in evs] == [FinishEvent]
    eng.run_until_drained()
    assert all(not isinstance(e, TokenEvent) or e.rid != victim.rid
               for e in eng.drain_events())
    for r in reqs:
        if r is not victim:
            np.testing.assert_array_equal(r.result().tokens,
                                          refs[r.rid].tokens)
    _residency_ok(eng)
    assert list(eng.cancelled) == [victim]


@pytest.mark.parametrize("depth", [0, 2])
def test_snapshot_restore_bit_exact(setup, depth):
    """Pause a running request (and one mid-prefill), resume both on a
    second engine: the tokens equal an uninterrupted run's."""
    _, _, prompts, refs = setup
    src = _engine(setup, prefill_budget=4, prefill_fairness="fifo",
                  grouped_decode=False)
    reqs = [src.submit(p, max_new=MAX_NEW) for p in prompts[:3]]
    while reqs[0].state != "running":
        src.step()
    for _ in range(depth):
        src.step()
    dst = _engine(setup, prefill_budget=4, grouped_decode=False)
    moved = []
    for r in reqs[:2]:
        rows = r.pos if r.state == "running" else r.prefill_pos
        snap = src.snapshot(r)
        assert r.state == "paused"
        assert snap.kv_bytes == rows * kv_row_bytes(src)
        assert all(t.device.type == "cpu" for t in snap.kv_k)
        moved.append((r, dst.restore(snap)))
    _residency_ok(src)
    src.run_until_drained()
    dst.run_until_drained()
    np.testing.assert_array_equal(reqs[2].result().tokens, refs[2].tokens)
    for old, new in moved:
        np.testing.assert_array_equal(new.result().tokens,
                                      refs[old.rid].tokens)


def test_snapshot_queued_and_held(setup):
    """A queued snapshot carries no KV; a role='prefill' engine holds a
    request after its first token until its snapshot moves on."""
    _, _, prompts, refs = setup
    pre = _engine(setup, role="prefill", grouped_decode=False)
    held = pre.submit(prompts[0], max_new=MAX_NEW)
    queued = pre.submit(prompts[1], max_new=MAX_NEW)
    qsnap = pre.snapshot(queued)
    assert qsnap.state == "queued" and qsnap.kv_k == []
    pre.step()
    assert held.state == "held" and len(held.tokens) == 1 and not pre.idle
    assert pre.load().held == 1
    dec = _engine(setup, role="decode", grouped_decode=False)
    moved = dec.restore(pre.snapshot(held))
    requeued = dec.restore(qsnap)
    dec.run_until_drained()
    np.testing.assert_array_equal(moved.result().tokens, refs[0].tokens)
    np.testing.assert_array_equal(requeued.result().tokens, refs[1].tokens)
    assert pre.idle


@pytest.mark.parametrize("budget", [None, 4])
def test_prefix_hit_bit_exact(setup, budget):
    cfg, params, prompts, _ = setup
    rng = np.random.default_rng(9)
    head = rng.integers(0, cfg.vocab, 10).astype(np.int32)
    a = np.concatenate([head, rng.integers(0, cfg.vocab, 5).astype(np.int32)])
    b = np.concatenate([head, rng.integers(0, cfg.vocab, 6).astype(np.int32)])
    cold = _engine(setup, max_batch=2)
    want = _drain(cold, [a, b])
    eng = _engine(setup, max_batch=2, prefix_cache=True, prefill_budget=budget)
    eng.submit(a, max_new=MAX_NEW)
    eng.run_until_drained()
    assert eng.prefix_score(b) == 10
    hit = eng.submit(b, max_new=MAX_NEW)
    eng.run_until_drained()
    assert hit.prefix_len == 10
    assert eng.prefilled_tokens == len(a) + len(b) - 10
    np.testing.assert_array_equal(hit.result().tokens, want[1].result().tokens)
    _residency_ok(eng)


def test_stop_token_and_event_stream(setup):
    _, _, prompts, refs = setup
    stop = int(refs[1].tokens[2])
    eng = _engine(setup, grouped_decode=False)
    req = eng.submit(prompts[1], SamplingParams(
        temperature=0.0, max_new_tokens=MAX_NEW, stop_token_ids=(stop,)))
    events = []
    while not eng.idle:
        events += eng.step()
    first = int(np.argmax(refs[1].tokens == stop))
    np.testing.assert_array_equal(req.result().tokens,
                                  refs[1].tokens[: first + 1])
    assert req.finish_reason == "stop_token"
    toks = [e for e in events if isinstance(e, TokenEvent)]
    assert [e.token for e in toks] == req.tokens
    assert [e.index for e in toks] == list(range(len(req.tokens)))
    assert toks[0].first and not any(e.first for e in toks[1:])
    assert isinstance(events[-1], FinishEvent)
    assert events[-1].reason == "stop_token"
    assert eng.tbt.total_gaps == len(req.tokens) - 1


def test_priority_admission_and_shedding(setup):
    """A later high-priority request is admitted first; a request whose
    TBT target cannot be met is shed with a RejectEvent."""
    _, _, prompts, _ = setup
    eng = _engine(setup, max_batch=1, grouped_decode=False)
    low = eng.submit(prompts[0], max_new=1)
    high = eng.submit(prompts[1], max_new=1, priority=5)
    eng.step()
    assert high.state != "queued" and low.state == "queued"
    eng.run_until_drained()
    slow = AdmissionController(LatencyModel(prefill_per_token=1.0,
                                            decode_step=1.0))
    shed = _engine(setup, queue=RequestQueue(slow))
    r = shed.submit_request(GenerationRequest(prompt=prompts[2],
                                              tbt_slo=1e-3))
    evs = shed.step()
    assert r.state == "rejected" and shed.idle
    assert [(type(e), e.rid, e.reason) for e in evs] == \
        [(RejectEvent, r.rid, "slo")]


def test_api_rejects_bad_input():
    with pytest.raises(ValueError):
        SamplingParams(max_new_tokens=-1)
    spec = as_request_spec(np.arange(3), priority=2)
    assert spec.priority == 2 and as_request_spec(spec) is spec
    with pytest.raises(ValueError):
        as_request_spec(spec, priority=1)


def test_engine_options(setup):
    cfg, params, prompts, _ = setup
    assert parse_prefill_budget("none") is None
    assert parse_prefill_budget("auto") == "auto"
    assert parse_prefill_budget("8") == 8
    with pytest.raises(ValueError):
        _engine(setup, prefill_budget="auto")          # no tbt_slo
    with pytest.raises(ValueError):
        _engine(setup, prefill_fairness="lifo")
    eng = _engine(setup, prefill_budget="auto", tbt_slo=0.5,
                  finished_window=2, grouped_decode=False)
    assert eng.chunked and eng._current_budget() >= 1
    with pytest.raises(ValueError):
        eng.submit(np.zeros(30, np.int32), max_new=8)   # 39 > W = 32
    _drain(eng, prompts)
    assert [r.rid for r in eng.finished] == [2, 3]
    assert kv_row_bytes(eng) == 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    load = eng.load()
    assert load.free_slots == 4 and load.total_tokens == 0


def test_kv_rows_view_or_gather(setup):
    """Consecutive slots in order read the pool through a view (no copy);
    any other order gathers; both decode to the same tokens."""
    _, _, prompts, _ = setup
    eng = _engine(setup)
    k, _, jidx = eng._kv_rows(0, np.array([1, 2, 3]))
    assert jidx is None and k.data_ptr() == eng._K[0][1].data_ptr()
    _, _, jidx = eng._kv_rows(0, np.array([2, 0]))
    assert jidx.tolist() == [2, 0]
    # submit out of slot order: a request retires and its slot is reused
    eng2 = _engine(setup, max_batch=2)
    a = eng2.submit(prompts[0], max_new=1)
    b = eng2.submit(prompts[1], max_new=MAX_NEW)
    eng2.step()
    eng2.step()
    assert a.state == "done"
    c = eng2.submit(prompts[2], max_new=MAX_NEW)
    eng2.step()
    assert (b.slot, c.slot) == (1, 0)      # the batch reads rows [1, 0]
    eng2.run_until_drained()
    ref = _engine(setup, max_batch=1)
    want = _drain(ref, [prompts[1], prompts[2]])
    np.testing.assert_array_equal(b.result().tokens, want[0].result().tokens)
    np.testing.assert_array_equal(c.result().tokens, want[1].result().tokens)
