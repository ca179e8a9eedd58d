"""Shared machinery of the port's example tests (tests/test_torch_examples*.py).

The reference side runs the JAX package's own example, ``examples/<name>.py``,
through its ``main()`` under a patched ``sys.argv``, its stdout captured;
the module-level names it calls (``collect_traces``, ``train_predictor``,
``simulate_request``, the engine class, ...) can be wrapped to record each
call's arguments and result. The port side calls the port example's
functions on the same weights (``params_from_jax``), trace statistics and
predictor (``ExpertMLP.from_jax``) and is held against those records.

Every reference example builds its own ``reduced(...)`` config; here each
config name maps to one object per process, and the JAX engines of one
config share their jitted functions (``torch_serving_parity.parity_env``),
so each shape compiles once per process.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np

from repro.configs.base import reduced as jreduced
from repro.models.model import build as jbuild
from repro_torch.core.predictor import ExpertMLP, TrainedPredictor
from repro_torch.models.params import params_from_jax

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
_CFGS, _PARAMS = {}, {}


def load_reference(name: str, mp):
    """A fresh module of ``examples/<name>.py`` whose ``reduced`` gives one
    config object per config name."""
    spec = importlib.util.spec_from_file_location(f"_reference_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.setattr(mod, "reduced", shared_reduced)
    return mod


def shared_reduced(cfg):
    if cfg.name not in _CFGS:
        _CFGS[cfg.name] = jreduced(cfg)
    return _CFGS[cfg.name]


def reference_params(jcfg):
    """``build(cfg).init(PRNGKey(0))``, what every reference example draws,
    once per config per process."""
    if jcfg.name not in _PARAMS:
        _PARAMS[jcfg.name] = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return _PARAMS[jcfg.name]


def record(mp, mod, name: str) -> list:
    """Wrap ``mod.<name>``; every call appends (args, kwargs, result)."""
    calls, fn = [], getattr(mod, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        calls.append((a, kw, out))
        return out

    mp.setattr(mod, name, wrapped)
    return calls


def record_serves(mp, mod) -> list:
    """Replace ``mod.MoEServingEngine`` by a subclass that appends
    (policy, RequestResult) for every ``serve``."""
    served, base = [], mod.MoEServingEngine

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.policy = kw["policy"]

        def serve(self, *a, **kw):
            r = super().serve(*a, **kw)
            served.append((self.policy, r))
            return r

    mp.setattr(mod, "MoEServingEngine", Recording)
    return served


def greedy_engines(mp) -> None:
    """Both packages' engines sample greedily unless told otherwise. At
    their default temperature (0.8) a sampled token moves to the next id
    where the packages' logits differ in the last bits (3 of the 8 requests
    quickstart traces on reduced Mixtral took another token)."""
    from repro.serving.engine import EngineCore as JCore
    from repro_torch.serving.engine import EngineCore as TCore
    for core in (JCore, TCore):
        fn = core.__init__
        mp.setattr(fn, "__kwdefaults__", dict(fn.__kwdefaults__, temperature=0.0))


def run_reference(mp, mod, argv=()) -> str:
    """``mod.main()`` with ``sys.argv`` = [name, *argv]; its stdout."""
    mp.setattr(sys, "argv", [mod.__name__, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def port_params(jp, **kw):
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu", **kw)


def port_predictor(jpred):
    return TrainedPredictor(ExpertMLP.from_jax(jax.tree.map(np.asarray, jpred.params),
                                               jax.tree.map(np.asarray, jpred.bn_state),
                                               device="cpu"), jpred.top_k)


# walls and rates, which two runs never share: "12.97s", "0.23ms", "(0.74x)",
# "0.03 it/s" and a percentile report's dict of times
_TIMES = (re.compile(r"\{'p50': [^}]*\}"),
          re.compile(r" *-?\d+\.\d+(?:e-?\d+)?(?=\s*(?:s\b|ms\b|x\)|it/s))"))


def without_times(text: str) -> list:
    """The lines of ``text`` with every wall and rate masked."""
    lines = []
    for line in text.splitlines():
        for pat in _TIMES:
            line = pat.sub("<t>", line)
        lines.append(line)
    return lines

