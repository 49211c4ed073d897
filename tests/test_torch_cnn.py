"""The port's DenseNet-lite CNN against the reference: forward logits,
penultimate features and parameter gradients at 1e-4 (the two frameworks
sum the convolutions in different orders), including the asymmetric
``"SAME"`` padding of the stride-2 stem conv and max pool."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import from_reference, to_reference_tree  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

tp.torch_cpu()
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (17, 7, 2, (3, 3)),
    (9, 3, 2, (1, 1)), (16, 7, 2, (2, 3)), (8, 3, 2, (0, 1)), (5, 3, 1, (1, 1)),
    (5, 1, 1, (0, 0))])
def test_same_pads_match_xla(size, k, s, want):
    assert tcnn.same_pads(size, k, s) == want
    # XLA's own padding for the same window
    pads = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
    assert tuple(pads[0]) == want


def test_paper_full_layout_matches_reference_tree():
    model = tcnn.HistoCNN(growth=32, stem=64, feat_dim=1152, hidden=512)
    layout = FlatLayout.of_module(model)
    shapes = jax.eval_shape(lambda k: jcnn.init_cnn(
        k, None, growth=32, stem=64, feat_dim=1152, hidden=512),
        jax.random.key(0))
    leaves = jax.tree.leaves(shapes)
    assert len(layout.leaves) == len(leaves) == 71
    assert layout.size == sum(int(np.prod(x.shape)) for x in leaves) == 1_639_705


def _both(widths, size, seed=0, b=4):
    model, layout, w = tp.tiny_model(**widths)
    tree = tp.jax_params(seed, w)
    x = tp.images(np.random.default_rng(seed + 1), b, size)
    flat = from_reference(layout, tree)
    return model, layout, tree, flat, x


@pytest.mark.parametrize("size", [16, 17, 24])
def test_forward_logits_and_features_match(size):
    widths = dict(n_blocks=2, layers_per_block=2)
    model, layout, tree, flat, x = _both(widths, size)
    fwd = jax.jit(lambda p, x: jcnn.forward_cnn(p, x, return_features=True))
    jl, jf = fwd(tree, x)
    tl, tf = tcnn.forward_cnn(model, layout.unflatten(flat),
                              torch.from_numpy(x), return_features=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)


def test_symmetric_padding_would_be_caught():
    """The trap: torch's symmetric padding keeps the output shape but shifts
    the window. At 16 px the stem pads (2, 3) and this must show."""
    model, layout, tree, flat, x = _both({}, 16)
    p = layout.unflatten(flat)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    same = tcnn.conv2d(xt, p["stem.w"], stride=2)
    symmetric = torch.nn.functional.conv2d(xt, p["stem.w"], stride=2, padding=3)
    assert same.shape == symmetric.shape
    assert not torch.allclose(same, symmetric, atol=1e-3)
    want = jcnn.conv2d(jnp.asarray(tree["stem"]["w"]), jnp.asarray(x), stride=2)
    np.testing.assert_allclose(same.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [16, 17])
def test_loss_and_grads_match(size):
    model, layout, tree, flat, x = _both({}, size, seed=3, b=6)
    y = np.random.default_rng(4).integers(0, 3, 6)

    def jloss(p, x, y):
        return jcnn.bce_loss(jcnn.forward_cnn(p, x), jax.nn.one_hot(y, 3))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(tree, x, y)

    def tloss(f):
        return tcnn.bce_loss(
            tcnn.forward_cnn(model, layout.unflatten(f), torch.from_numpy(x)),
            tcnn.one_hot(torch.from_numpy(y), 3))

    tg, tl = torch.func.grad_and_value(tloss)(flat)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = from_reference(layout, jax.tree.map(np.asarray, jg))
    np.testing.assert_allclose(tg.numpy(), want.numpy(), **TOL)


def test_convert_round_trip_is_exact():
    model, layout, tree, flat, _ = _both(dict(n_blocks=2), 16)
    back = to_reference_tree(layout, flat)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    stacked = np.stack([flat.numpy(), flat.numpy() * 2])
    tree2 = to_reference_tree(layout, torch.from_numpy(stacked))
    assert np.array_equal(from_reference(layout, tree2, lead=1).numpy(),
                          stacked)
