"""The port's AdamW, global-norm clipping and LR schedules against the
reference at 1e-6 (f32 arithmetic in the same order; the clipping norm sums
the leaves in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import TrainConfig as JTC  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import (adamw_from_reference,  # noqa: E402
                                 from_reference)
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

tp.torch_cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grad_scale,clip", [(0.01, 1.0), (10.0, 1.0),
                                             (1.0, 0.0)])
def test_adamw_steps_match(grad_scale, clip):
    """Five AdamW steps with a cosine lr from the pre-increment count: under
    the clip norm, above it, and with clipping off."""
    _, layout, w = tp.tiny_model()
    tree = tp.jax_params(0, w)
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-3, warmup_steps=2, max_steps=8, grad_clip=clip)
    jcfg, tcfg = JTC(**kw), TrainConfig(**kw)
    jsch, tsch = jsched.make_schedule(jcfg), tsched.make_schedule(tcfg)
    jp, jo = tree, jadamw.adamw_init(tree)
    tp_ = from_reference(layout, tree)
    to = tadamw.adamw_init(tp_)
    upd = jax.jit(lambda p, g, o: jadamw.adamw_update(
        p, g, o, jcfg, jsch(o["count"])))
    for _ in range(5):
        g = jax.tree.map(lambda x: (rng.normal(0, grad_scale, x.shape)
                                    .astype(np.float32)), tree)
        jp, jo = upd(jp, g, jo)
        tp_, to = tadamw.adamw_update(tp_, from_reference(layout, g), to,
                                      tcfg, tsch(to["count"]))
    np.testing.assert_allclose(
        tp_.numpy(), from_reference(layout, jax.tree.map(np.asarray, jp)),
        **TOL)
    want = adamw_from_reference(layout, jax.tree.map(np.asarray, jo))
    np.testing.assert_allclose(to["mu"].numpy(), want["mu"].numpy(), **TOL)
    np.testing.assert_allclose(to["nu"].numpy(), want["nu"].numpy(), **TOL)
    assert int(to["count"]) == int(want["count"]) == 5


def test_clip_by_global_norm_matches():
    g = np.random.default_rng(2).normal(0, 3, (500,)).astype(np.float32)
    jg, jn = jadamw.clip_by_global_norm({"a": jnp.asarray(g[:200]),
                                         "b": jnp.asarray(g[200:])}, 1.0)
    tg, tn = tadamw.clip_by_global_norm(torch.from_numpy(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    np.testing.assert_allclose(
        tg.numpy(), np.concatenate([jg["a"], jg["b"]]), **TOL)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, max_steps=100, schedule=schedule)
    js = jsched.make_schedule(JTC(**kw))
    ts = tsched.make_schedule(TrainConfig(**kw))
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray([js(jnp.int32(s)) for s in steps])
    got = np.asarray([float(ts(torch.tensor(s, dtype=torch.int32)))
                      for s in steps])
    np.testing.assert_allclose(got, want, **TOL)
