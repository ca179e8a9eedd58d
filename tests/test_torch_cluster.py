"""The port's cluster layer against the JAX package's
(``repro_torch.serving.cluster`` vs ``repro.serving.cluster``).

The scenarios of tests/test_cluster.py and the two ``prefix_affinity``
tests of tests/test_prefix.py, each driven through both packages by the
same calls (tests/torch_serving_parity.py says what is compared, the
router's choice ``handle.replica`` among it): a 1-replica cluster under
each of the six routers, equal to a plain frontend; two replicas under
``least_loaded``; each router's own decision (``least_loaded`` spreading,
``slo_headroom``'s reject and its queue band, ``expert_affinity``'s warm
replica and overload gate, ``prefix_affinity``'s warm replica and gate);
cancel through the cluster; the autopilot's TBT, TTFT and queued sheds and
the admission queue band it must not shed. Port only: ``ValueError`` where
the reference asserts on its caller's input.

Deadlines are either pinned cost models or fabricated clocks far past any
wall time of either package, so no decision depends on how fast a package
runs.
"""
import time

import numpy as np
import pytest

from torch_serving_parity import assert_parity, reference_setup

FAR = 1e5   # seconds added to the clock where a deadline must have passed


@pytest.fixture(scope="module")
def setup():
    with reference_setup() as s:
        rng = np.random.default_rng(3)
        s["prompts"] = [rng.integers(0, s["vocab"], size=n).astype(np.int32)
                        for n in (12, 16, 9, 14)]
        head = rng.integers(0, s["vocab"], size=10).astype(np.int32)
        donor = np.concatenate([head, rng.integers(0, s["vocab"], size=4)
                                .astype(np.int32)])
        partial = np.concatenate([head, rng.integers(0, s["vocab"], size=5)
                                  .astype(np.int32)])
        partial[10] = (donor[10] + 1) % s["vocab"]
        s["prefix"] = dict(donor=donor, partial=partial)
        yield s


def _pool(side, n, **kw):
    kw = dict(dict(max_batch=2, prefill_budget=3), **kw)
    return side.pool(n, **kw)


def _plain_tokens(side, prompts):
    fe = side.fe(max_batch=2, prefill_budget=3)
    hs = [fe.submit(side.spec(p)) for p in prompts]
    fe.drain()
    return [list(h.tokens) for h in hs]


def _one_replica(side, prompts, router):
    refs = _plain_tokens(side, prompts)
    pool = _pool(side, 1)
    fe = side.cluster_fe(pool, router)
    handles = [fe.submit(side.spec(p)) for p in prompts]
    fe.drain()
    assert fe.idle
    assert [list(h.tokens) for h in handles] == refs
    assert all(h.replica == 0 and h.finish_reason == "length" for h in handles)
    return side.record(handles, pool)


@pytest.mark.parametrize("router", ["round_robin", "least_loaded", "slo_headroom",
                                    "expert_affinity", "prefix_affinity", "disagg"])
def test_one_replica_cluster_parity(setup, router):
    assert_parity(setup, _one_replica, setup["prompts"], router)


def _two_replicas(side, prompts):
    refs = _plain_tokens(side, prompts)
    pool = _pool(side, 2)
    fe = side.cluster_fe(pool, "least_loaded")
    handles = [fe.submit(side.spec(p)) for p in prompts]
    fe.drain()
    assert {h.replica for h in handles} == {0, 1}
    assert [list(h.tokens) for h in handles] == refs
    return side.record(handles, pool)


def test_multi_replica_parity(setup):
    assert_parity(setup, _two_replicas, setup["prompts"])


def _least_loaded(side, prompts):
    pool = _pool(side, 2)
    fe = side.cluster_fe(pool, "least_loaded")
    hs = [fe.submit(side.spec(prompts[i])) for i in (1, 2, 0)]
    assert [h.replica for h in hs] == [0, 1, 1]
    fe.drain()
    return side.record(hs, pool)


def test_least_loaded_avoids_busy_replica_parity(setup):
    assert_parity(setup, _least_loaded, setup["prompts"])


def _slo_reject(side, prompts):
    pool = _pool(side, 2)
    for eng in pool.engines:
        eng.queue.admission.model.prefill_per_token = 10.0
    fe = side.cluster_fe(pool, "slo_headroom")
    doomed = fe.submit(side.spec(prompts[0], ttft_slo=0.5))
    assert doomed.done and doomed.replica is None
    assert doomed.events[0].reason == "router_slo"
    assert all(len(e.queue) == 0 for e in pool.engines)
    assert list(doomed) == [] and not doomed.cancel()
    with pytest.raises(RuntimeError):
        doomed.result()
    ok = fe.submit(side.spec(prompts[2]))
    fe.drain()
    return side.record([doomed, ok], pool,
                       rejected=(fe.n_router_rejected, len(fe.router_rejected)))


def test_slo_headroom_rejects_parity(setup):
    assert_parity(setup, _slo_reject, setup["prompts"])


def _slo_queue_band(side, prompts):
    pool = _pool(side, 2)
    for fe_i in pool.frontends:
        fe_i.submit(side.spec(prompts[1]))
    for eng in pool.engines:
        eng.queue.admission.model.prefill_per_token = 0.3
        eng.queue.admission.model.decode_step = 0.01
    fe = side.cluster_fe(pool, "slo_headroom")
    h = fe.submit(side.spec(prompts[2], ttft_slo=5.0))
    assert h.replica is not None and fe.n_router_rejected == 0
    return side.record([h], pool)


def test_slo_headroom_queue_band_parity(setup):
    assert_parity(setup, _slo_queue_band, setup["prompts"])


def _expert_affinity(side, prompts):
    pool = _pool(side, 2)
    fe = side.cluster_fe(pool, "expert_affinity")
    keys = pool.likely_keys()
    assert keys
    for key in sorted(keys):
        pool.engines[1].cache.admit(key, pinned=False)
    spec = side.spec(prompts[0])
    warm = fe.router.choose(spec, pool, 0.0)
    for _ in range(2):
        pool.frontends[1].submit(side.spec(prompts[1]))
    loaded = fe.router.choose(spec, pool, 0.0)
    assert (warm, loaded) == (1, 0)
    return side.record([], pool, keys=sorted(keys), choices=(warm, loaded))


def test_expert_affinity_parity(setup):
    assert_parity(setup, _expert_affinity, setup["prompts"])


def _cancel_through_cluster(side, prompts):
    pool = _pool(side, 2)
    fe = side.cluster_fe(pool, "round_robin")
    surv0, victim, surv1 = [fe.submit(side.spec(p)) for p in prompts[:3]]
    assert (surv0.replica, victim.replica, surv1.replica) == (0, 1, 0)
    while len(victim.tokens) < 2 and not victim.done:
        fe.poll()
    assert victim.cancel()
    assert victim.req.slot in pool.engines[victim.replica]._free
    fe.drain()
    return side.record([surv0, victim, surv1], pool)


def test_cancel_through_cluster_parity(setup):
    assert_parity(setup, _cancel_through_cluster, setup["prompts"])


def _tbt_shed(side, prompts):
    fe = side.fe(max_batch=2, prefill_budget=3)
    ap = side.autopilot(fe)
    survivor = fe.submit(side.spec(prompts[0]))
    victim = fe.submit(side.spec(prompts[1], tbt_slo=60.0))
    while len(victim.tokens) < 2 and not victim.done:
        fe.poll()
    ev = fe.poll(time.perf_counter() + FAR)
    assert victim.finish_reason == "slo_shed"
    assert any(e.reason == "slo_shed" for e in ev if hasattr(e, "reason"))
    assert list(ap.shed) == [victim] and fe.engine.n_slo_shed == 1
    fe.drain()
    return side.record([survivor, victim], autopilot=ap)


def test_autopilot_tbt_shed_parity(setup):
    assert_parity(setup, _tbt_shed, setup["prompts"])


def _ttft_shed(side, prompts):
    pool = _pool(side, 1, prefill_budget=1)
    fe = side.cluster_fe(pool, "least_loaded")
    victim = fe.submit(side.spec(prompts[1], ttft_slo=1000.0))
    fe.poll()
    assert victim.status == "prefilling"
    ap = side.autopilot(fe)
    assert ap.scan(time.perf_counter() + FAR) == [victim]
    assert not pool.engines[0].prefilling
    return side.record([victim], pool, ap)


def test_autopilot_ttft_shed_mid_prefill_parity(setup):
    assert_parity(setup, _ttft_shed, setup["prompts"])


def _queued_shed(side, prompts):
    fe = side.fe(max_batch=1)
    runner = fe.submit(side.spec(prompts[0]))
    fe.poll()
    queued = fe.submit(side.spec(prompts[1], ttft_slo=1000.0))
    fe.poll()
    assert queued.status == "queued"
    ap = side.autopilot(fe)
    ap.scan(time.perf_counter() + FAR)
    assert queued.finish_reason == "slo_shed" and len(fe.engine.queue) == 0
    fe.drain()
    return side.record([runner, queued], autopilot=ap)


def test_autopilot_sheds_queued_parity(setup):
    assert_parity(setup, _queued_shed, setup["prompts"])


def _queue_band(side, prompts):
    fe = side.fe(max_batch=1, prefill_budget=1)
    runner = fe.submit(side.spec(prompts[1]))
    fe.poll()
    queued = fe.submit(side.spec(prompts[2], ttft_slo=5.0))
    model = fe.engine.queue.admission.model
    model.prefill_per_token, model.decode_step = 0.3, 0.01
    now = time.perf_counter()
    ap = side.autopilot(fe)
    assert ap.scan(now) == []
    assert ap.scan(now + 100.0) == [queued]
    fe.drain()
    return side.record([runner, queued], autopilot=ap)


def test_autopilot_preserves_queue_band_parity(setup):
    assert_parity(setup, _queue_band, setup["prompts"])


def _prefix_warm(side, p):
    pool = _pool(side, 2, prefix_cache=True)
    cf = side.cluster_fe(pool, "prefix_affinity")
    hd = cf.submit(side.spec(p["donor"]))
    cf.drain()
    hp = cf.submit(side.spec(p["partial"]))
    assert hp.replica == hd.replica
    cf.drain()
    trees = [(e.prefix.hits, e.prefix.hit_tokens) for e in pool.engines]
    assert trees[hd.replica][1] == 10 and trees[1 - hd.replica][0] == 0
    return side.record([hd, hp], pool, trees=trees)


def test_prefix_affinity_routes_to_warm_replica_parity(setup):
    assert_parity(setup, _prefix_warm, setup["prefix"])


def _prefix_gate(side, p):
    pool = _pool(side, 2, max_batch=4, prefill_budget=1, prefix_cache=True)
    cf = side.cluster_fe(pool, "prefix_affinity")
    hd = cf.submit(side.spec(p["donor"]))
    cf.drain()
    handles = [cf.submit(side.spec(p["partial"])) for _ in range(8)]
    assert {h.replica for h in handles} == {0, 1}
    cf.drain()
    assert len({tuple(h.tokens) for h in handles}) == 1
    return side.record([hd] + handles, pool)


def test_prefix_affinity_overload_gate_parity(setup):
    assert_parity(setup, _prefix_gate, setup["prefix"])


@pytest.mark.parametrize("case", ["n_replicas", "overrides", "queue", "queue_override",
                                  "typo", "drain"])
def test_pool_rejects_bad_caller_input(setup, case):
    """Where the reference asserts on its caller's input, the port raises
    ValueError (and names the nearest valid engine keyword for a typo)."""
    from repro_torch.serving import ReplicaPool
    from repro_torch.serving.batching import RequestQueue
    _, cfg, params, _ = setup["port"]
    kw = dict(policy="duo", max_batch=2, max_seq=32)
    build = {
        "n_replicas": lambda: ReplicaPool.build(cfg, params, 0, **kw),
        "overrides": lambda: ReplicaPool.build(cfg, params, 2, overrides=[{}], **kw),
        "queue": lambda: ReplicaPool.build(cfg, params, 1, queue=RequestQueue(), **kw),
        "queue_override": lambda: ReplicaPool.build(
            cfg, params, overrides=[{"queue": RequestQueue()}], **kw),
        "typo": lambda: ReplicaPool.build(cfg, params, 1, prefil_budget=4, **kw),
        "drain": lambda: ReplicaPool.build(cfg, params, 1, **kw).drain(1),
    }[case]
    with pytest.raises(ValueError) as e:
        build()
    if case == "typo":
        assert "did you mean 'prefill_budget'" in str(e.value)
