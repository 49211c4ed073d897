"""Shared helpers for the port's parity tests (``test_torch_*.py``): build the
same small CNN, weights, data and swarm sessions in both packages from one
numpy seed."""
import jax
import numpy as np
import torch

from repro.configs.base import SwarmConfig as JSwarmConfig
from repro.core.session import SwarmSession as JSession
from repro.experiments import histo as jh
from repro.metrics import gate_metric_fn
from repro.models.cnn import forward_cnn
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs.base import SwarmConfig
from repro_torch.convert import from_reference
from repro_torch.core.flat import FlatLayout
from repro_torch.core.session import SwarmSession
from repro_torch.experiments import histo as th
from repro_torch.models.cnn import HistoCNN
from repro_torch.optim import adamw_init

# tests/test_experiments.py's TINY protocol config
TINY = dict(n_train=160, n_test=64, steps=6, image_size=16, batch_size=8,
            noise=0.6, growth=4, stem=8, feat_dim=32, hidden=16,
            n_blocks=1, layers_per_block=2)
WIDTHS = dict(growth=4, stem=8, feat_dim=32, hidden=16, n_blocks=1,
              layers_per_block=2)


def tiny_model(**widths):
    w = dict(WIDTHS, **widths)
    model = HistoCNN(**w)
    return model, FlatLayout.of_module(model), w


def jax_params(seed, widths):
    """A reference init as a numpy tree (the reference's own He init)."""
    tree = jax_init_cnn(jax.random.key(seed), None, **widths)
    return jax.tree.map(np.asarray, tree)


def carried(layout, tree):
    """Reference numpy tree → the port's flat f32 params [P]."""
    return from_reference(layout, tree)


def images(rng, b, size):
    return rng.normal(0, 1, (b, size, size, 3)).astype(np.float32)


def torch_cpu():
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False


SIZES = [16, 48, 48, 48]
THR = 0.8


def round_data(seed, t=3, r=1, n=4, b=8, size=16, v=10):
    """[R, T, N, B, H, W, 3] images, labels and a padded validation set."""
    rng = np.random.default_rng(seed)
    xs = images(rng, r * t * n * b, size).reshape((r, t, n, b, size, size, 3))
    ys = rng.integers(0, 3, (r, t, n, b)).astype(np.int32)
    vx = images(rng, n * v, size).reshape((n, v, size, size, 3))
    vy = rng.integers(0, 3, (n, v)).astype(np.int32)
    vm = np.ones((n, v), bool)
    vm[0, 6:] = False     # node 0 holds a shorter, padded validation set
    vx[0, 6:] = 0.0
    return xs, ys, (vx, vy, vm)


def session_fns():
    """The TINY CNN's train step and gate metric in both packages, plus the
    port's model and layout: (jtrain, jeval, ttrain, teval_for, layout)."""
    ecfg_j = jh.HistoExperimentConfig(**TINY)
    ecfg_t = th.HistoExperimentConfig(**TINY)
    jtrain, _, _ = jh._make_model_fns(ecfg_j)
    metric = gate_metric_fn("auc")

    def jeval(p, v):
        x, y, m = v
        return metric(jax.nn.sigmoid(forward_cnn(p, x)), y, m)

    model = th._model(ecfg_t)
    _, layout, _ = tiny_model()
    ttrain, _ = th._make_model_fns(ecfg_t, model, layout)
    return jtrain, jeval, ttrain, lambda cfg: th._make_eval_fn(cfg, model,
                                                               layout), layout


def sessions(kw, seed=0):
    """A reference and a port SwarmSession with the same config, weights
    (the reference's init carried across) and data sizes."""
    jtrain, jeval, ttrain, teval, layout = session_fns()
    tree = jax_params(seed, WIDTHS)
    flat = from_reference(layout, tree)
    js = JSession(JSwarmConfig(**kw), jtrain, jeval, params=tree,
                  opt_state=jadamw_init(tree), data_sizes=SIZES, seed=0)
    cfg = SwarmConfig(**kw)
    ts = SwarmSession(cfg, ttrain, teval(cfg), params=flat,
                      opt_state=adamw_init(flat), data_sizes=SIZES,
                      layout=layout, device="cpu")
    return js, ts, layout


def check_flat(got, want, layout):
    """Flat ``[N, P]`` params of the port against the reference's carried
    across: 1e-4, the head's FC biases at 2e-3."""
    # The FC biases feed a batch-statistics BN, so their gradient is zero in
    # exact arithmetic: AdamW turns each framework's rounding noise into
    # ±lr steps. They are held to the summed lr of the steps taken instead.
    noise = np.zeros(got.shape[1], bool)
    for leaf in layout.leaves:
        if leaf.path in ("head.fc1.b", "head.fc2.b"):
            noise[leaf.offset:leaf.offset + leaf.size] = True
    np.testing.assert_allclose(got[:, ~noise], want[:, ~noise],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:, noise], want[:, noise], atol=2e-3)


def check_round(js, ts, layout, jlog, tlog):
    """A round of the paired sessions (:func:`sessions`) agrees: params and
    wire reference by :func:`check_flat`, gate bits where the reference's
    margin |merged − THR·local| clears 1e-4, gate metrics at 2e-3, the
    membership masks equal."""
    check_flat(ts.state.params.numpy(),
               from_reference(layout, jax.tree.map(np.asarray,
                                                   js.state.params),
                              lead=1).numpy(), layout)
    if js.state.wire is not None:
        check_flat(ts.state.wire.numpy(),
                   from_reference(layout, jax.tree.map(np.asarray,
                                                       js.state.wire),
                                  lead=1).numpy(), layout)
    ml = np.asarray(jlog["metric_local"]).reshape(-1)
    mm = np.asarray(jlog["metric_merged"]).reshape(-1)
    clear = np.abs(mm - THR * ml) >= 1e-4
    assert clear.any()
    np.testing.assert_array_equal(
        tlog["gates"].numpy().reshape(-1)[clear],
        np.asarray(jlog["gates"]).reshape(-1)[clear])
    np.testing.assert_allclose(tlog["metric_local"].numpy().reshape(-1), ml,
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tlog["metric_merged"].numpy().reshape(-1), mm,
                               rtol=2e-3, atol=2e-3)
    assert np.array_equal(ts.active, js.active)
