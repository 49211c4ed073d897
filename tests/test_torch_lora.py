"""The port's LoRA helpers (`repro_torch.core.lora`) and its fused LoRA
matmul (`repro_torch.kernels.lora_matmul`) against the reference on the same
numpy arrays: the flat payload's paths and round trip, the helpers' errors,
``merge_lora_into_base``, the plain kernel form against the reference's
Pallas kernel in interpret mode at its own sweep shapes and tolerance, and
the autograd Function's gradient against ``jax.grad`` of the unfused form.
The card-only kernel cases live in tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import lora as jl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lora_matmul import lora_apply as j_lora_apply  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul as j_lora_matmul  # noqa: E402
from repro_torch.core import lora as tl  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels.ref import lora_matmul_ref  # noqa: E402

torch.set_num_threads(2)


def _tol(dtype):
    # the reference's _tol (tests/test_kernels.py)
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _tree(seed=0):
    """A numpy params tree with lists, a 2-D and a stacked 3-D adapted
    linear, and frozen leaves."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {
        "head": {"proj": {"w": f(6, 5), "lora_A": f(6, 2), "lora_B": f(2, 5),
                          "lora_scale": np.float32(1.5)},
                 "out": {"w": f(5, 3), "b": f(3)}},
        "layers": [{"attn": {"w": f(3, 4, 4), "lora_A": f(3, 4, 2),
                             "lora_B": f(3, 2, 4),
                             "lora_scale": f(3)}},
                   {"mlp": {"w": f(4, 4)}}],
        "embed": f(7, 4),
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _assert_trees_equal(a, b, **tol):
    assert type(a) is type(b) or (a is None) == (b is None)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k], **tol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_trees_equal(u, v, **tol)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("select", [None, "head_out"])
def test_flatten_payload_matches_reference_and_round_trips(select):
    sel = (None if select is None else
           (lambda p: tl.is_adapter_path(p) or p.startswith("head/out/")))
    tree = _tree()
    want = jl.flatten_payload(jax.tree.map(jnp.asarray, tree), sel)
    got = tl.flatten_payload(_torch_tree(tree), sel)
    assert list(got) == list(want)             # same paths, same order
    assert "head/proj/lora_A" in got and "layers/0/attn/lora_scale" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # round trip: new payload leaves land at their paths, the rest pass
    new = {k: v + 1.0 for k, v in got.items()}
    back = tl.unflatten_payload(new, _torch_tree(tree))
    jback = jl.unflatten_payload(
        {k: jnp.asarray(v.numpy()) for k, v in new.items()},
        jax.tree.map(jnp.asarray, tree))
    _assert_trees_equal(_np(back), _np(jback), rtol=0, atol=0)
    assert tl.flatten_payload(back, sel).keys() == new.keys()


def test_lora_helper_errors():
    tree = _torch_tree(_tree())
    with pytest.raises(ValueError, match="no leaf matched"):
        tl.flatten_payload(tree, lambda p: False)
    with pytest.raises(ValueError, match="not present in the template"):
        tl.unflatten_payload({"head/proj/nope": torch.zeros(1)}, tree)


def test_split_combine_bytes_and_merge_match_reference():
    tree = _tree(1)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = _torch_tree(tree)
    adapters, base = tl.split_adapters(ttree)
    jad, jbase = jl.split_adapters(jtree)
    _assert_trees_equal(_np(adapters), _np(jad), rtol=0, atol=0)
    _assert_trees_equal(_np(base), _np(jbase), rtol=0, atol=0)
    _assert_trees_equal(_np(tl.combine(adapters, base)), tree, rtol=0, atol=0)
    for lora_only in (True, False):
        assert tl.payload_bytes(ttree, lora_only) == jl.payload_bytes(
            jtree, lora_only)
    _assert_trees_equal(_np(tl.merge_lora_into_base(ttree)),
                        _np(jl.merge_lora_into_base(jtree)),
                        rtol=1e-6, atol=1e-6)


def test_inject_lora_structure_matches_reference():
    """Same targets, shapes, dtypes, zero B and scales as the reference (the
    A draws come from a torch.Generator, so their numbers differ)."""
    tree = {"head": {"proj": {"w": np.ones((6, 5), np.float32)},
                     "out": {"w": np.ones((5, 3), np.float32)}},
            "blocks": [{"attn": {"w": np.ones((2, 4, 4), np.float32)}}]}
    want = jl.inject_lora(jax.tree.map(jnp.asarray, tree),
                          jax.random.PRNGKey(0), rank=2, alpha=8.0,
                          targets="(proj|attn)")
    got = tl.inject_lora(_torch_tree(tree), torch.Generator().manual_seed(0),
                         rank=2, alpha=8.0, targets="(proj|attn)")
    jflat = jl.flatten_payload(want, lambda p: True)
    tflat = tl.flatten_payload(got, lambda p: True)
    assert list(tflat) == list(jflat)
    for k in jflat:
        assert tuple(tflat[k].shape) == tuple(jflat[k].shape), k
        if "lora_A" not in k:
            np.testing.assert_array_equal(tflat[k].numpy(),
                                          np.asarray(jflat[k]), err_msg=k)
    assert float(tflat["head/proj/lora_A"].std()) > 0


SWEEP = [(128, 256, 128, 8, "float32"), (256, 512, 384, 16, "float32"),
         (128, 1024, 256, 64, "float32"), (256, 256, 256, 16, "bfloat16")]


def _sweep_inputs(m, k, n, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (m, k)), rng.normal(0, 1, (k, n)) / np.sqrt(k),
            rng.normal(0, 1, (k, r)) / np.sqrt(k),
            rng.normal(0, 1, (r, n)) / np.sqrt(r))


@pytest.mark.parametrize("m,k,n,r,dtype", SWEEP)
def test_plain_lora_matmul_matches_reference_kernel(m, k, n, r, dtype):
    """The port's plain form (the CPU path of the wrapper) against the
    reference's Pallas kernel in interpret mode, at the reference's sweep
    shapes and tolerance; and ``lora_apply`` against the reference's."""
    arrs = _sweep_inputs(m, k, n, r, seed=m + k + r)
    jx, jw, ja, jb = (jnp.asarray(a).astype(getattr(jnp, dtype))
                      for a in arrs)
    want = j_lora_matmul(jx, jw, ja, jb, 1.5, bm=128, bn=128, bk=128,
                         interpret=True)
    tx, tw, ta, tb = (torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (jx, jw, ja, jb))
    before = dict(LAUNCHES)
    got = lm.lora_matmul(tx, tw, ta, tb, torch.tensor(1.5))
    assert LAUNCHES == before                  # a CPU tensor: plain form
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    # the oracles agree too (the reference's own test compares the kernel
    # with lora_matmul_ref at this tolerance)
    np.testing.assert_allclose(
        lora_matmul_ref(tx, tw, ta, tb, 1.5).float().numpy(),
        np.asarray(jref.lora_matmul_ref(jx, jw, ja, jb, 1.5), np.float32),
        **_tol(dtype))
    got_apply = lm.lora_apply(tx, tw, ta, tb, 1.5)
    want_apply = j_lora_apply(jx, jw, ja, jb, 1.5)
    np.testing.assert_allclose(got_apply.float().numpy(),
                               np.asarray(want_apply, np.float32),
                               **_tol(dtype))


def test_lora_apply_gradient_matches_jax_unfused_form():
    """Gradients of the Function (backward in plain torch) against
    ``jax.grad`` of the reference's unfused form, for x, W, A, B and the
    trained scale."""
    rng = np.random.default_rng(3)
    x, w, a, b = (v.astype(np.float32)
                  for v in _sweep_inputs(20, 16, 16, 4, seed=3))
    b = b + 0.3                                # a live low-rank path
    s = np.float32(2.0)
    gy = rng.normal(0, 1, (20, 16)).astype(np.float32)

    def jloss(x, w, a, b, s):
        return jnp.sum(j_lora_apply(x, w, a, b, s) * gy)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(v) for v in (x, w, a, b, s)))
    tgy = torch.from_numpy(gy)
    got = torch.func.grad(
        lambda *v: (lm.lora_apply(*v) * tgy).sum(), argnums=(0, 1, 2, 3, 4))(
            *(torch.from_numpy(np.array(v)) for v in (x, w, a, b, s)))
    for name, g, h in zip("xWABs", got, want):
        assert tuple(g.shape) == tuple(np.shape(h)), name
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
