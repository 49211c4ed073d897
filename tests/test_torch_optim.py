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


def _wide_inputs(rng, lead, dtype):
    """A layout's two parts (an f32 prefix of 5 values, a rest of 37 in
    ``dtype``), their grads and AdamW state after a first step, with
    ``lead`` leading node dims."""
    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy(rng.normal(0, scale, lead + shape)
                                .astype(np.float32)).to(dt)

    params = (t(5), t(37, dt=dtype))
    grads = (t(5, scale=3.0), t(37, scale=3.0, dt=dtype))
    state = {"mu": t(42, scale=0.1), "nu": t(42, scale=0.1).abs(),
             "count": torch.full(lead, 3, dtype=torch.int32)}
    return params, grads, state


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_copy(v) for v in tree)
    return tree.clone()


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(
        torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("vmapped", [False, True])
def test_adamw_update_in_place_is_bit_identical(monkeypatch, dtype, clip,
                                                vmapped):
    """``adamw_update_`` against ``adamw_update`` bit for bit: an f32 and
    a 16-bit part (the layout's parts), with and without clipping, across
    chunk boundaries (``CHUNK`` = 8 cuts both parts and the moments), plain
    and under ``torch.func.vmap`` over 3 nodes (the engine's form). The
    in-place form hands back its inputs: the params' parts and the moments
    keep their storage."""
    monkeypatch.setattr(tadamw, "CHUNK", 8)
    rng = np.random.default_rng(5)
    lead = (3,) if vmapped else ()
    params, grads, state = _wide_inputs(rng, lead, dtype)
    cfg = TrainConfig(grad_clip=clip, weight_decay=0.1)
    lr = torch.tensor(1e-2)

    def run(fn):
        def one(p, g, s):
            return fn(p, g, s, cfg, lr)
        return (torch.func.vmap(one)(params_, grads, state_) if vmapped
                else one(params_, grads, state_))

    params_, state_ = _copy(params), _copy(state)
    want_p, want_s = run(tadamw.adamw_update)
    params_, state_ = _copy(params), _copy(state)
    ptrs = ([p.data_ptr() for p in params_], state_["mu"].data_ptr(),
            state_["nu"].data_ptr())
    got_p, got_s = run(tadamw.adamw_update_)
    for g, w in zip(got_p, want_p):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    for key in ("mu", "nu"):
        assert torch.equal(_bits(got_s[key]), _bits(want_s[key])), key
    assert torch.equal(got_s["count"], want_s["count"])
    assert [p.data_ptr() for p in params_] == ptrs[0]
    assert [p.data_ptr() for p in got_p] == ptrs[0]
    assert got_s["mu"].data_ptr() == ptrs[1]
    assert got_s["nu"].data_ptr() == ptrs[2]
    assert torch.equal(params_[1], got_p[1])        # written, not rebound
    assert not torch.equal(params_[1], params[1])


def test_adamw_update_in_place_through_slot_views():
    """A bf16 LM's slot buffer: the update of ``layout.parts`` (the f32
    prefix a dtype view of the buffer) lands in the buffer itself, the
    rest cast back in place, bit for bit the functional update joined."""
    from repro_torch.core.flat import FlatLayout
    layout = FlatLayout([("a", (3,)), ("w", (4, 5)), ("b", (7,))],
                        wide=["a", "b"])
    rng = np.random.default_rng(6)
    vals = torch.from_numpy(rng.normal(0, 1, (layout.n_values,))
                            .astype(np.float32))
    buf = layout.from_values(vals, torch.bfloat16)
    grads = tuple(torch.from_numpy(rng.normal(0, 1, p.shape).astype(
        np.float32)).to(p.dtype) for p in layout.parts(buf))
    state = tadamw.adamw_init(layout.parts(buf))
    cfg = TrainConfig()
    want_p, want_s = tadamw.adamw_update(layout.parts(buf), grads, state,
                                         cfg, 1e-2)
    want = layout.join(want_p)
    ptr = buf.data_ptr()
    tadamw.adamw_update_(layout.parts(buf), grads, state, cfg, 1e-2)
    assert buf.data_ptr() == ptr
    assert torch.equal(buf.view(torch.int16), want.view(torch.int16))
    assert torch.equal(state["mu"], want_s["mu"])


@pytest.mark.parametrize("merge", ["fisher", "gradmatch"])
def test_session_stats_and_storage_with_in_place_steps(monkeypatch, merge):
    """The TINY CNN's swarm steps (`experiments.histo`, in place) against
    the same steps through the functional ``adamw_update``: after
    ``run_local`` and a round the params, the moments and the
    fisher/gradmatch statistics (the Δθ² proxy, which reads the params
    from before each step) are bit-identical; and across the round the
    params and the moments keep their storage."""
    from repro_torch.experiments import histo as th
    kw = dict(n_nodes=4, sync_every=2, topology="ring", merge=merge,
              lora_only=False, val_threshold=tp.THR)
    xs, ys, val = tp.round_data(8, t=2, r=2)
    states = []
    for update in (tadamw.adamw_update, tadamw.adamw_update_):
        with monkeypatch.context() as m:
            m.setattr(th, "adamw_update_", update)
            ts = tp.sessions(kw, seed=1)[1]
            ts.run_local((xs[0], ys[0]))
            st = ts.state
            ptrs = (st.params.data_ptr(), st.opt_state["mu"].data_ptr(),
                    st.opt_state["nu"].data_ptr())
            ts.round((xs[1], ys[1]), val)
            st = ts.state
            kept = ptrs == (st.params.data_ptr(),
                            st.opt_state["mu"].data_ptr(),
                            st.opt_state["nu"].data_ptr())
            states.append((st, kept))
    (fresh, _), (inplace, kept) = states
    assert kept
    assert float(inplace.stats.abs().max()) > 0
    for a, b in ((fresh.params, inplace.params),
                 (fresh.stats, inplace.stats),
                 (fresh.opt_state["mu"], inplace.opt_state["mu"]),
                 (fresh.opt_state["nu"], inplace.opt_state["nu"])):
        assert torch.equal(_bits(a), _bits(b))
