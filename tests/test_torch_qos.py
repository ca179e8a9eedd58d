"""The port's copies of the QoS and prefix-cache machinery against the JAX
package's: ``TBTLedger``, ``LatencyModel``, ``AdmissionController``,
``RequestQueue`` and ``PrefixTree`` fed the same seeded sequences give
identical outputs (exact: both are numpy and the standard library)."""
import numpy as np
import pytest

from repro.core import prefix as JP
from repro.core import qos as JQ
from repro.serving import batching as JB
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch.core import prefix as TP
from repro_torch.core import qos as TQ
from repro_torch.serving import batching as TB
from repro_torch.serving.api import SamplingParams


@pytest.mark.parametrize("seed", range(3))
def test_tbt_ledger_same_outputs(seed):
    rng = np.random.default_rng(seed)
    ledgers = [Q.TBTLedger(window=32, per_rid_window=8, closed_window=4)
               for Q in (JQ, TQ)]
    t = 0.0
    for _ in range(400):
        op = rng.choice(["observe", "observe", "observe", "close", "reopen"])
        rid = int(rng.integers(0, 12))
        t += float(rng.exponential(0.01)) * (50 if rng.random() < 0.02 else 1)
        gaps = list(rng.exponential(0.01, int(rng.integers(0, 4))))
        for led in ledgers:
            if op == "observe":
                led.observe(rid, t)
            elif op == "close":
                led.close(rid)
            else:
                led.reopen(rid, gaps)
    j, p = ledgers
    assert p.report() == j.report()
    assert {r: list(g) for r, g in p.by_rid.items()} == \
        {r: list(g) for r, g in j.by_rid.items()}
    assert list(p.gaps) == list(j.gaps) and p.max_gap() == j.max_gap()
    for rid in range(12):
        a, b = p.attainment(rid, 0.01), j.attainment(rid, 0.01)
        assert a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("seed", range(3))
def test_latency_model_and_admission_same_outputs(seed):
    rng = np.random.default_rng(seed)
    ctls = [Q.AdmissionController(Q.LatencyModel(alpha=0.25),
                                  default_ttft_slo=0.5) for Q in (JQ, TQ)]
    out = {0: [], 1: []}
    for _ in range(300):
        n = int(rng.integers(1, 600))
        wall = float(rng.exponential(0.02))
        step = float(rng.exponential(0.01))
        args = (float(rng.uniform(0, 2)), float(rng.uniform(0, 1)),
                int(rng.integers(1, 512)), int(rng.integers(0, 2048)))
        kw = dict(ttft_slo=(None if rng.random() < 0.3
                            else float(rng.uniform(0.01, 2))),
                  running_batch=int(rng.integers(0, 8)),
                  chunk_budget=(None if rng.random() < 0.3
                                else int(rng.integers(1, 512))),
                  tbt_slo=(None if rng.random() < 0.5
                           else float(rng.uniform(0.001, 0.2))),
                  chunk_adaptive=bool(rng.random() < 0.5))
        tgt = float(rng.uniform(0, 0.1))
        for i, ctl in enumerate(ctls):
            ctl.model.observe_prefill(n, wall)
            ctl.model.observe_decode_step(step)
            out[i].append((ctl.decide(*args, **kw).value,
                           ctl.headroom(*args, **kw),
                           ctl.predict_ttft(*args, running_batch=2,
                                            chunk_budget=64),
                           ctl.model.suggest_chunk(tgt),
                           ctl.model.predict_tbt(kw["chunk_budget"])))
    assert out[1] == out[0]
    assert ctls[1].n_rejected == ctls[0].n_rejected > 0


def test_qos_summaries_same_outputs():
    rng = np.random.default_rng(0)
    ttft, e2e = rng.exponential(0.1, 50), rng.exponential(1.0, 50)
    assert TQ.summarize(ttft, e2e, 800, 1e9, 0.4).row() == \
        JQ.summarize(ttft, e2e, 800, 1e9, 0.4).row()
    assert TQ.slo_attainment(e2e, 1.0) == JQ.slo_attainment(e2e, 1.0)
    assert TQ.percentile_report(e2e, (50, 90, 99)) == \
        JQ.percentile_report(e2e, (50, 90, 99))
    load = dict(queue_depth=2, queued_tokens=30, prefill_backlog=12,
                running=3, decode_backlog=40, free_slots=1, held=1)
    assert TQ.ReplicaLoad(**load).total_tokens == \
        JQ.ReplicaLoad(**load).total_tokens == 82


@pytest.mark.parametrize("seed", range(4))
def test_request_queue_same_admissions(seed):
    """Priority order, QUEUE stops, REJECT sheds, prefix-hit charging."""
    rng = np.random.default_rng(seed)
    queues = [B.RequestQueue(Q.AdmissionController(
        Q.LatencyModel(prefill_per_token=2e-3, decode_step=5e-3)))
        for B, Q in ((JB, JQ), (TB, TQ))]
    log = {0: [], 1: []}
    rid = 0
    for rnd in range(30):
        for _ in range(int(rng.integers(0, 4))):
            n = int(rng.integers(1, 300))
            kw = dict(ttft_slo=(None if rng.random() < 0.3
                                else float(rng.uniform(0.05, 1.5))),
                      tbt_slo=(None if rng.random() < 0.7
                               else float(rng.uniform(0.001, 0.05))),
                      priority=int(rng.integers(0, 3)),
                      arrival=float(rnd) * 0.05)
            for i, (B, sp) in enumerate(((JB, JSamplingParams),
                                         (TB, SamplingParams))):
                queues[i].submit(B.Request(
                    rid=rid, prompt=np.zeros(n, np.int32),
                    params=sp(max_new_tokens=4), **kw))
            rid += 1
        now = rnd * 0.05 + float(rng.uniform(0, 0.05))
        args = dict(limit=int(rng.integers(0, 4)),
                    backlog_tokens=int(rng.integers(0, 400)),
                    running_batch=int(rng.integers(0, 4)),
                    chunk_budget=(None if rng.random() < 0.5 else 64))
        hit = int(rng.integers(0, 8))
        for i, q in enumerate(queues):
            got = q.pop_admissible(now, hit_fn=lambda r: min(hit, r.prompt_len),
                                   **args)
            log[i].append(([r.rid for r in got], [r.rid for r in q.pending],
                           [(r.rid, r.state) for r in q.rejected],
                           q.queued_tokens(), len(q)))
    assert log[1] == log[0]
    assert any(r for _, _, r, _, _ in log[0])   # some requests were shed


class _Walk:
    """One package's PrefixTree driven by a shared op script."""

    def __init__(self, mod):
        self.tree = mod.PrefixTree()
        self.out = []

    def apply(self, op, arg):
        t = self.tree
        if op == "insert":
            self.out.append(t.insert(*arg))
        elif op == "match":
            self.out.append(t.match(*arg))
        elif op == "peek":
            self.out.append(t.peek(*arg))
        elif op == "release":
            t.release(*arg)
        elif op == "retire":
            self.out.append(t.slot_released(arg))
        elif op == "evict":
            self.out.append(t.evict_for(arg))
        self.out.append((t.n_reclaimable(), t.cached_rows(),
                         sorted(t.nodes_by_slot)))


@pytest.mark.parametrize("seed", range(6))
def test_prefix_tree_same_walk(seed):
    rng = np.random.default_rng(seed)
    walks = [_Walk(JP), _Walk(TP)]
    free, live, held, seqs = list(range(6)), {}, [], []

    def tokens():
        if seqs and rng.random() < 0.7:
            base = seqs[int(rng.integers(len(seqs)))]
            cut = int(rng.integers(0, len(base) + 1))
            tail = rng.integers(0, 4, int(rng.integers(0, 12)))
            return tuple(base[:cut]) + tuple(int(x) for x in tail)
        return tuple(int(x) for x in rng.integers(0, 4, int(rng.integers(1, 13))))

    for _ in range(200):
        op = rng.choice(["insert", "match", "peek", "release", "retire",
                         "evict"])
        if op == "insert" and free:
            toks = tokens()[:16]
            slot = free.pop(int(rng.integers(len(free))))
            arg = (toks, slot)
            live[slot] = toks
            seqs.append(toks)
        elif op in ("match", "peek"):
            q = tokens()
            arg = (q, None if rng.random() < 0.5
                   else int(rng.integers(0, len(q) + 1)))
        elif op == "release" and held:
            arg = held.pop(int(rng.integers(len(held))))
        elif op == "retire" and live:
            arg = list(live)[int(rng.integers(len(live)))]
            del live[arg]
        elif op == "evict":
            arg = int(rng.integers(1, 3))
        else:
            continue
        for w in walks:
            w.apply(op, arg)
        if op == "match" and walks[0].out[-2][0]:
            held.append((arg[0], walks[0].out[-2][0]))
        elif op == "retire" and not walks[0].out[-2]:
            free.append(arg)
        elif op == "evict":
            free.extend(walks[0].out[-2])
        walks[1].tree.check_invariants(16)
    assert walks[1].out == walks[0].out
