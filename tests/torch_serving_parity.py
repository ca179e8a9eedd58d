"""Shared machinery of the port's serving parity tests
(tests/test_torch_frontend.py, test_torch_cluster.py, test_torch_snapshot.py,
test_torch_obs.py).

Each test drives the JAX objects (``repro.serving``) and their port
counterparts (``repro_torch.serving``) through the same calls, one
``Side`` each, and asserts the two ``record``s equal: per handle its
tokens, event stream (types, rids, tokens, indices, reasons, counts; times
ignored), status, finish reason, replica and handoff hops; every top-level
poll's event stream; every engine's span stream by ``(name, lane, rid)``
and terminal reasons; the pool's handoff / migration counters and the
autopilot's by-reason counts.

Setup, as tests/test_torch_batching.py: ``reduced(mixtral_8x7b)`` with the
JAX weights carried by ``params_from_jax``, the DUO predictor trained in
JAX and carried across, greedy decoding, ``max_seq=32``, and the reference
grouped sweeps on the Pallas pool kernel in interpret mode
(``REPRO_OPT_GROUPED_FFN=1``): the numbers the port's grouped decode and
fused prefill take.

Two things are not compared:

  * The prefill-lane ``kv.scatter`` instant, which the reference emits at a
    request's final chunk (src/repro/serving/batching.py:1072) when it
    scatters its carry buffers into the slot pool. The port's chunks write
    the pool row in place, so there is nothing to scatter and the port
    emits no such instant.
  * Wall-clock times. The scenarios use only decisions that do not depend
    on them: fixed prefill budgets, SLO-less requests or pinned cost
    models, and fabricated future clocks where a deadline must pass.

The JAX engine jits its per-layer functions per instance (closures over the
config), so every new engine recompiles every shape. Here all JAX engines
of one config share the first one's jitted functions — the same closures
over the same config — so each shape compiles once. The weights, trace
stats, predictors and those functions are built once per process and
reused by every module that opens ``reference_setup`` (none of them is
mutated by an engine), so a test worker that runs two of these modules
pays the setup and the compiles once. While the context is open torch runs
one intra-op thread: under the tier-1 command's six workers on eight
cores, torch's thread teams spun against each other and made these files
run several times slower than alone; the CPU results are the same.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget, reduced as jreduced
from repro.core import qos as JQ
from repro.core.predictor import train_predictor as jtrain
from repro.core.state import StateConstructor as JStateConstructor
from repro.models.model import build
from repro.serving import api as JA, batching as JB, cluster as JC
from repro.serving import engine as JE, frontend as JF
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import qos as TQ
from repro_torch.core.predictor import ExpertMLP, TrainedPredictor
from repro_torch.models.params import params_from_jax
from repro_torch.serving import api as TA, batching as TB, cluster as TC
from repro_torch.serving import frontend as TF

MAX_NEW = 4
# (name, lane) pairs the port does not emit by design (module docstring)
SPAN_SKIP = {("kv.scatter", "prefill")}
_JIT_ATTRS = ("_attn_prefill", "_attn_prefill_chunk", "_attn_decode",
              "_attn_decode_batched", "_gate", "_expert_raw", "_grouped_raw",
              "_expert", "_shared", "_head")


_BUILT = {}   # the process's one setup (reference_setup)


def _share_jits(mp: pytest.MonkeyPatch, fns: dict) -> None:
    build_jits = JE.EngineCore._jit_fns

    def shared(self):
        have = fns.get(id(self.cfg))
        if have is None:
            build_jits(self)
            fns[id(self.cfg)] = {a: getattr(self, a) for a in _JIT_ATTRS}
        else:
            for a, f in have.items():
                setattr(self, a, f)

    mp.setattr(JE.EngineCore, "_jit_fns", shared)


def _build():
    jcfg = jreduced(jget("mixtral_8x7b"))
    cfg = reduced(get_config("mixtral_8x7b"))
    jp = build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    traced = [rng.integers(0, cfg.vocab, n).astype(np.int32)
              for n in (16, 12)]
    tracer, _ = JE.collect_traces(jcfg, jp, traced, max_new=4)
    stats = tracer.stats()
    X, Y = JStateConstructor(stats).build_dataset(tracer.as_array())
    jpred, _ = jtrain(jax.random.PRNGKey(1), X, Y, jcfg.top_k,
                      width_scale=0.1, epochs=2, batch=16)
    tpred = TrainedPredictor(ExpertMLP.from_jax(
        jax.tree.map(np.asarray, jpred.params),
        jax.tree.map(np.asarray, jpred.bn_state), device="cpu"),
        jcfg.top_k)
    return dict(jax=((JA, JB, JF, JC, JQ), jcfg, jp, jpred),
                port=((TA, TB, TF, TC, TQ), cfg, tp, tpred),
                stats=stats, vocab=cfg.vocab)


@contextlib.contextmanager
def parity_env():
    """The environment both packages' engines are compared in: the grouped
    Pallas sweeps in interpret mode, JAX engine jits shared per config
    object, torch on one intra-op thread."""
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_OPT_GROUPED_FFN", "1")
        mp.setenv("REPRO_PALLAS_INTERPRET", "1")
        _share_jits(mp, _BUILT.setdefault("jits", {}))
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)


@contextlib.contextmanager
def reference_setup():
    """Both packages' config, weights, trace stats and predictor (a fresh
    dict over the process's one build); the JAX environment stays set
    while the context is open."""
    with parity_env():
        if "setup" not in _BUILT:
            _BUILT["setup"] = _build()
        yield dict(_BUILT["setup"])


def event_rows(events):
    return [(type(e).__name__, e.rid, getattr(e, "token", None),
             getattr(e, "index", None), getattr(e, "reason", None),
             getattr(e, "n_tokens", None)) for e in events]


class Side:
    """One package's objects, built with the shared defaults (``duo``,
    ``max_seq=32``, greedy, spans on, the carried stats and predictor),
    with every engine kept and every top-level poll's events logged."""

    def __init__(self, setup, name: str):
        (self.api, self.batching, self.frontend, self.cluster,
         self.qos), self.cfg, self.params, self.pred = setup[name]
        self.name = name
        self.stats = setup["stats"]
        self.engines = []
        self.polls = []

    def _kw(self, kw):
        return dict(dict(policy="duo", max_seq=32, temperature=0.0,
                         stats=self.stats, predictor=self.pred, spans=True),
                    **kw)

    def engine(self, **kw):
        kw.setdefault("max_batch", 2)
        eng = self.batching.BatchedServingEngine(self.cfg, self.params,
                                                 **self._kw(kw))
        self.engines.append(eng)
        return eng

    def fe(self, **kw):
        return self._logged(self.frontend.ServingFrontend(self.engine(**kw)))

    def pool(self, n=None, **kw):
        pool = self.cluster.ReplicaPool.build(self.cfg, self.params, n,
                                              **self._kw(kw))
        self.engines += pool.engines
        return pool

    def cluster_fe(self, pool, router):
        return self._logged(self.cluster.ClusterFrontend(pool, router=router))

    def autopilot(self, fe, **kw):
        return self.cluster.QosAutopilot(fe, **kw)

    def spec(self, prompt, max_new=MAX_NEW, **kw):
        return self.api.GenerationRequest(
            prompt=prompt,
            params=self.api.SamplingParams(max_new_tokens=max_new), **kw)

    def _logged(self, fe):
        poll = fe.poll

        def logged(now=None):
            ev = poll(now)
            self.polls.append(event_rows(ev))
            return ev

        fe.poll = logged    # handles poll through it too
        return fe

    def record(self, handles=(), pool=None, autopilot=None, **extra):
        """What is compared between the two packages."""
        rec = dict(
            handles=[dict(rid=h.rid, tokens=list(h.tokens),
                          events=event_rows(h.events), status=h.status,
                          finish=h.finish_reason, replica=h.replica,
                          hops=[(x["src"], x["dst"]) for x in h.handoffs])
                     for h in handles],
            polls=self.polls,
            spans=[[(s.name, s.lane, s.rid) for s in e.obs.spans()
                    if (s.name, s.lane) not in SPAN_SKIP]
                   for e in self.engines],
            terminals=[e.obs.terminal_reasons() for e in self.engines],
            open_spans=[len(e.obs.open_spans()) for e in self.engines],
            hbm_ok=[e.cache.hbm_bound_ok for e in self.engines],
            **extra)
        if pool is not None:
            rec["pool"] = dict(
                n_handoffs=pool.n_handoffs, n_migrated=pool.n_migrated,
                handoff_bytes=pool.handoff_bytes,
                handoff_bytes_saved=pool.handoff_bytes_saved,
                n_tail_handoffs=pool.n_tail_handoffs,
                roles=list(pool.roles), routable=pool.routable())
        if autopilot is not None:
            rec["autopilot"] = dict(
                by_reason=autopilot.by_reason, n_shed=autopilot.n_shed,
                n_preempted=autopilot.n_preempted,
                n_resumed=autopilot.n_resumed,
                paused=len(autopilot.paused))
        return rec


def assert_parity(setup, scenario, *args):
    """Run ``scenario(side, *args) -> record`` on both packages; the port's
    record must equal the reference's. Returns the reference's."""
    want = scenario(Side(setup, "jax"), *args)
    got = scenario(Side(setup, "port"), *args)
    for key in want:
        assert got[key] == want[key], f"{key} differs"
    assert got.keys() == want.keys()
    return want


def poll_until(fe, pred, limit=500):
    for _ in range(limit):
        if pred():
            return
        fe.poll()
    raise AssertionError("condition not reached")
