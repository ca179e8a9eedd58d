"""The port's ExpertMLP predictor, its training and its inputs (tracer,
state constructor) against the reference's, on weights and data carried
across as numpy arrays. f32 throughout: rtol = atol = 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.core.state import StateConstructor as JStateConstructor
from repro.core.tracer import ExpertsTracer as JTracer
from repro.training.optimizer import AdamW as JAdamW
from repro_torch.core import predictor as TP
from repro_torch.core.state import StateConstructor
from repro_torch.core.tracer import ExpertsTracer
from repro_torch.training.optimizer import AdamW

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
EXACT = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def trained_jax():
    """A reference predictor a few steps into training, so BatchNorm
    statistics and weights are away from their init values."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((96, 40)).astype(np.float32)
    Y = (rng.random((96, 6)) < 0.3).astype(np.float32)
    pred, _ = JP.train_predictor(jax.random.PRNGKey(0), X, Y, 2,
                                 width_scale=0.05, epochs=2, batch=32)
    return pred, X


def _model(pred):
    return TP.ExpertMLP.from_jax(jax.tree.map(np.asarray, pred.params),
                                 jax.tree.map(np.asarray, pred.bn_state),
                                 device="cpu")


def test_hidden_widths():
    assert TP.HIDDEN == JP.HIDDEN and TP.DROPOUT == JP.DROPOUT
    for s in (1.0, 0.1, 0.05):
        assert TP.hidden_dims(s) == JP.hidden_dims(s)


def test_eval_logits_match(trained_jax):
    pred, X = trained_jax
    model = _model(pred).eval()
    want, _ = JP.forward(pred.params, pred.bn_state, jnp.asarray(X), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    tp = TP.TrainedPredictor(model, 2)
    np.testing.assert_array_equal(tp.predict_topk(X[:7], k=3),
                                  pred.predict_topk(X[:7], k=3))


def test_train_mode_batchnorm_statistics_match(trained_jax):
    """Population variance, the reference's eps placement and momentum."""
    pred, X = trained_jax
    model = _model(pred).train()
    want, new_bn = JP.forward(pred.params, pred.bn_state, jnp.asarray(X[:32]),
                              train=True)
    got = model(torch.from_numpy(X[:32]))   # no generator: no dropout
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **EXACT)
    for bn, st in zip(model.norms, new_bn):
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(st["mean"]), **EXACT)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(st["var"]), **EXACT)


def test_bce_and_accuracy_metrics():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((20, 6)).astype(np.float32) * 4
    y = (rng.random((20, 6)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(TP.bce_loss(torch.from_numpy(z), torch.from_numpy(y))),
        float(JP.bce_loss(jnp.asarray(z), jnp.asarray(y))), **EXACT)
    assert TP.accuracy_metrics(z, y, 2) == JP.accuracy_metrics(z, y, 2)


def test_adamw_matches_reference_update():
    """b2 = 0.95, global-norm clip, decay on matrices only."""
    rng = np.random.default_rng(2)
    shapes = {"w": (5, 3), "b": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 3 for k, s in shapes.items()}
             for _ in range(3)]
    jopt = JAdamW(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = AdamW(list(tparams.values()), lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    for g in grads:
        jparams, jstate, jgn = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                           jstate, jparams)
        for k, t in tparams.items():
            t.grad = torch.from_numpy(g[k])
        tgn = topt.step()
        np.testing.assert_allclose(float(tgn), float(jgn), **EXACT)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), **EXACT)


def test_train_predictor_lowers_the_loss():
    """A learnable synthetic trace: layer l+1's experts follow layer l's."""
    L, E, k = 4, 6, 2
    rng = np.random.default_rng(3)
    tracer = ExpertsTracer(L, E, k)
    for _ in range(64):
        first = rng.choice(E, k, replace=False)
        tracer.add_path(np.stack([(first + l) % E for l in range(L)]))
    sc = StateConstructor(tracer.stats())
    X, Y = sc.build_dataset(tracer.as_array())
    pred, hist = TP.train_predictor(0, X, Y, k, width_scale=0.05, epochs=8,
                                    batch=32, lr=3e-3, device="cpu")
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert hist["val_loss"][-1] < hist["val_loss"][0]
    assert pred.predict_topk(X[:3]).shape == (3, k)


def test_tracer_and_state_constructor_match():
    L, E, k = 4, 8, 2
    rng = np.random.default_rng(4)
    paths = np.stack([np.stack([rng.choice(E, k, replace=False) for _ in range(L)])
                      for _ in range(10)])
    jt, tt = JTracer(L, E, k), ExpertsTracer(L, E, k)
    jt.add_paths(paths)
    tt.add_paths(paths)
    js, ts = jt.stats(), tt.stats()
    np.testing.assert_array_equal(ts.popularity, js.popularity)
    np.testing.assert_array_equal(ts.affinity, js.affinity)
    jX, jY = JStateConstructor(js).build_dataset(paths)
    tX, tY = StateConstructor(ts).build_dataset(paths)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tY, jY)
