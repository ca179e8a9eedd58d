"""The port's streaming front-end against the JAX package's
(``repro_torch.serving.frontend`` vs ``repro.serving.frontend``).

The scenarios of tests/test_frontend.py, each driven through both packages
by the same calls (tests/torch_serving_parity.py says what is compared):
every poll/read schedule with monolithic and chunked prefill and
mid-flight admission, whose handle streams must also equal the same
engine's ``run_until_drained()``; cancel while queued, while prefilling
(two chunk depths) and while decoding (two token counts), with the slot
freed and reused at once; an admission-rejected handle; a stop token.
"""
import numpy as np
import pytest

from torch_serving_parity import MAX_NEW, assert_parity, reference_setup


@pytest.fixture(scope="module")
def setup():
    with reference_setup() as s:
        rng = np.random.default_rng(3)
        s["prompts"] = [rng.integers(0, s["vocab"], size=n).astype(np.int32)
                        for n in (12, 16, 9, 14)]
        yield s


def _drive_exhaust_each(fe, handles):
    return [list(h) for h in handles]


def _drive_round_robin(fe, handles):
    outs = [[] for _ in handles]
    iters = [iter(h) for h in handles]
    live = list(range(len(handles)))
    while live:
        for i in list(live):
            try:
                outs[i].append(next(iters[i]))
            except StopIteration:
                live.remove(i)
    return outs


def _drive_drain_then_read(fe, handles):
    fe.drain()
    return [h.tokens for h in handles]


DRIVERS = [_drive_exhaust_each, _drive_round_robin, _drive_drain_then_read]


def _streaming(side, prompts, budget, driver):
    fe = side.fe(max_batch=2, prefill_budget=budget)
    handles = [fe.submit(side.spec(p)) for p in prompts]
    outs = [list(o) for o in driver(fe, handles)]
    assert fe.idle
    for h, out in zip(handles, outs):
        assert out == list(h.tokens) and h.finish_reason == "length"
        assert list(h.result().tokens) == out
    eng = side.engine(max_batch=2, prefill_budget=budget)
    drained = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    eng.run_until_drained()
    assert outs == [list(r.tokens) for r in drained]
    return side.record(handles)


@pytest.mark.parametrize("budget", [None, 3])
@pytest.mark.parametrize("driver", DRIVERS, ids=lambda d: d.__name__[7:])
def test_streaming_any_poll_schedule_parity(setup, budget, driver):
    assert_parity(setup, _streaming, setup["prompts"], budget, driver)


def _cancel_decode(side, prompts, cancel_at):
    fe = side.fe(max_batch=4)
    eng = fe.engine
    handles = [fe.submit(side.spec(p)) for p in prompts[:3]]
    victim = handles[1]
    while len(victim.tokens) < cancel_at:
        fe.poll()
    vslot = victim.req.slot
    n_cancel = len(victim.tokens)
    assert victim.cancel() and not victim.cancel()
    assert victim.done and victim.status == "cancelled"
    assert vslot in eng._free and victim.req.rid not in eng.tbt._last
    fresh = fe.submit(side.spec(prompts[3]))
    fe.poll()
    assert fresh.req.slot == vslot
    fe.drain()
    assert len(victim.result().tokens) == n_cancel
    return side.record(handles + [fresh])


@pytest.mark.parametrize("cancel_at", [1, 3])
def test_cancel_mid_decode_parity(setup, cancel_at):
    assert_parity(setup, _cancel_decode, setup["prompts"], cancel_at)


def _cancel_prefill(side, prompts, polls):
    fe = side.fe(max_batch=4, prefill_budget=2)
    eng = fe.engine
    handles = [fe.submit(side.spec(p)) for p in prompts[:3]]
    victim = handles[1]
    for _ in range(polls):
        fe.poll()
    assert victim.status == "prefilling" and victim.req.prefill_remaining > 0
    vslot = victim.req.slot
    assert victim.cancel()
    assert vslot in eng._free and victim.req.active_sets is None
    fresh = fe.submit(side.spec(prompts[3]))
    fe.poll()
    assert fresh.req.slot == vslot
    fe.drain()
    assert victim.result().tokens.size == 0
    return side.record(handles + [fresh])


@pytest.mark.parametrize("polls", [1, 2])
def test_cancel_mid_prefill_parity(setup, polls):
    assert_parity(setup, _cancel_prefill, setup["prompts"], polls)


def _cancel_queued(side, prompts):
    fe = side.fe(max_batch=1)
    h0 = fe.submit(side.spec(prompts[0]))
    h1 = fe.submit(side.spec(prompts[1]))
    fe.poll()
    assert h1.status == "queued"
    assert h1.cancel()
    assert len(fe.engine.queue) == 0 and h1.req.slot == -1
    fe.drain()
    return side.record([h0, h1])


def test_cancel_queued_parity(setup):
    assert_parity(setup, _cancel_queued, setup["prompts"])


def _rejected(side, prompts):
    q = side.qos
    queue = side.batching.RequestQueue(q.AdmissionController(
        q.LatencyModel(prefill_per_token=100.0), default_ttft_slo=0.1))
    fe = side._logged(side.frontend.ServingFrontend(
        side.engine(max_batch=2, queue=queue)))
    h = fe.submit(side.spec(prompts[0], max_new=2))
    fe.poll()
    assert h.done and h.finish_reason == "rejected" and h.tokens == []
    with pytest.raises(RuntimeError, match="rejected"):
        h.result()
    return side.record([h])


def test_rejected_handle_parity(setup):
    assert_parity(setup, _rejected, setup["prompts"])


def _stop_token(side, prompts):
    fe = side.fe(max_batch=2)
    ref = fe.submit(side.spec(prompts[0]))
    fe.drain()
    toks = list(ref.tokens)
    # the first token after the first that has not been emitted before
    i = next(i for i in range(1, len(toks)) if toks[i] not in toks[:i])
    h = fe.submit(side.api.GenerationRequest(
        prompt=prompts[0], params=side.api.SamplingParams(
            max_new_tokens=MAX_NEW, stop_token_ids=(toks[i],))))
    assert list(h) == toks[:i + 1]
    assert h.finish_reason == "stop_token"
    return side.record([ref, h])


def test_handle_streams_stop_token_parity(setup):
    assert_parity(setup, _stop_token, setup["prompts"])
