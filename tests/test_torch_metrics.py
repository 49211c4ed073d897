"""The port's gate metrics (explicit node axis) against the reference's
traced metrics at 1e-6 — ties, masked rows, absent classes — and its host
metric copies against the originals (equal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import metrics as jm  # noqa: E402
from repro_torch import metrics as tm  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)


def _cases():
    """Per-node (probs [V, C], labels [V], valid [V]) stacked to [N, ...]:
    continuous scores; heavy ties; masked rows; one node missing a class."""
    rng = np.random.default_rng(0)
    n, v, c = 4, 40, 3
    probs = rng.random((n, v, c)).astype(np.float32)
    probs[1] = np.round(probs[1] * 4) / 4          # many ties
    labels = rng.integers(0, c, (n, v))
    labels[2][labels[2] == 2] = 0                  # class 2 absent at node 2
    valid = np.ones((n, v), bool)
    valid[3, 25:] = False                          # padded rows
    probs[3, 25:] = 0.99                           # garbage in the padding
    return probs, labels, valid


@pytest.mark.parametrize("name", ["auc", "accuracy", "f1", "sensitivity"])
@pytest.mark.parametrize("masked", [False, True])
def test_gate_metrics_match_reference(name, masked):
    probs, labels, valid = _cases()
    jf = jax.jit(jax.vmap(jm.gate_metric_fn(name)))
    want = np.asarray(jf(probs, labels, valid if masked else
                         np.ones_like(valid)))
    got = tm.gate_metric_fn(name)(
        torch.from_numpy(probs), torch.from_numpy(labels),
        torch.from_numpy(valid) if masked else None)
    assert got.shape == (probs.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_traced_auc_matches_host_oracle_and_no_axis_form():
    probs, labels, valid = _cases()
    got = tm.macro_auc_traced(torch.from_numpy(probs[0]),
                              torch.from_numpy(labels[0]))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), tm.macro_auc(probs[0], labels[0]),
                               **TOL)


def test_unknown_gate_metric_raises():
    with pytest.raises(ValueError, match="unknown gate_metric"):
        tm.gate_metric_fn("nope")


def test_host_metrics_equal():
    probs, labels, _ = _cases()
    emb = np.random.default_rng(3).normal(0, 1, (40, 5))
    for i in range(probs.shape[0]):
        p, y = probs[i].astype(np.float64), labels[i]
        assert tm.classify_report(p, y) == jm.classify_report(p, y)
        assert tm.davies_bouldin(emb, y) == jm.davies_bouldin(emb, y)
        preds = p.argmax(-1)
        assert tm.confusion_stats(preds, y, 3) == jm.confusion_stats(preds, y, 3)
        assert tm.accuracy(preds, y) == jm.accuracy(preds, y)
        assert tm.binary_auc(p[:, 0], y == 0) == jm.binary_auc(p[:, 0], y == 0)
