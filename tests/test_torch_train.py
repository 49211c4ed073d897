"""The port's LM trainer (`repro_torch.launch.train`) against the
reference's (`repro.launch.train`) on the same numpy inputs and the
reference's own weights, carried across with
`repro_torch.convert.lm_params_from_reference` and `adamw_from_reference`:
the train step of the dense, ssm and hybrid smoke variants (f32, a bf16
hybrid whose f32 leaves train as f32, microbatch accumulation), the flash
and SSD Functions' gradients under ``vmap(grad)`` against JAX's
``vmap(value_and_grad)`` of the reference's jnp modules, two engine-backend
``SwarmSession`` rounds of an LM (fedavg on the f32 wire, fisher on the int8
wire, adapter-only sync), the token stream copy, and the CLI end to end on
the CPU. Smoke widths, TF32 off."""
import dataclasses
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.checkpointing import load_pytree as jload_pytree  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.lora import inject_lora as jinject_lora  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.data.synthetic import make_lm_stream as j_make_lm_stream  # noqa: E402
from repro.kernels.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import SwarmConfig, TrainConfig  # noqa: E402
from repro_torch.convert import (adamw_from_reference,  # noqa: E402
                                 lm_params_from_reference,
                                 lm_params_to_reference, to_reference_tree)
from repro_torch.core.session import SwarmSession  # noqa: E402
from repro_torch.data import make_lm_stream  # noqa: E402
from repro_torch.kernels.flash_attention import flash_apply  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_apply  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

FAMILIES = {"dense": "minicpm-2b", "ssm": "mamba2-370m",
            "hybrid": "hymba-1.5b"}
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _cfgs(arch, **kw):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).replace(**kw)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).replace(**kw)
    return jcfg, tcfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{dotted path: numpy leaf} of a reference tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _batch(rng, n, b, s, vocab):
    toks = rng.integers(0, vocab, (n, b, s + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _tc(cls, **kw):
    """TrainConfig's defaults (lr 1e-4, cosine over 10 steps) without
    warmup, so the first step already runs at lr."""
    return cls(**dict(dict(warmup_steps=0, max_steps=10, remat=False), **kw))


def _run_steps(arch, steps=3, accum=1, lr=1e-4, remat=False, **kw):
    """``steps`` train steps of both packages from the reference's init.
    Returns a namespace: the losses (``jl``, ``tl``), the initial params
    (``init``), the final params (``jp``, ``tp``) and AdamW moments
    (``jmu``/``tmu``, ``jnu``/``tnu``), and the first moment after the
    first step (``jmu1``/``tmu1``: 0.1 times the clipped gradient at the
    shared init), all as {path: numpy} of the reference's tree, and the
    port's ``layout``. ``remat`` is both steps' ``TrainConfig.remat``."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tree = jm.init(jax.random.key(0))
    init = _leaves(_np_tree(tree))
    jopt = jadamw_init(tree)
    flat = lm_params_from_reference(tm.layout, _np_tree(tree))
    topt = adamw_from_reference(tm.layout, _np_tree(jopt))
    jstep = jax.jit(jtrain.make_train_step(jm, _tc(
        JTrainConfig, accum_steps=accum, lr=lr, remat=remat)))
    tstep = ttrain.make_train_step(tm, _tc(TrainConfig, accum_steps=accum,
                                           lr=lr, remat=remat))
    values = tm.layout.value_layout

    def moments(jo, to, key):
        # a copy: the port's step updates the moments in place
        return (_leaves(_np_tree(jo[key])),
                _leaves(to_reference_tree(values, to[key].clone())))

    rng = np.random.default_rng(1)
    out = dict(jl=[], tl=[], init=init, layout=tm.layout)
    for i in range(steps):
        batch = {k: v[0] for k, v in _batch(rng, 1, 4, 32,
                                            tcfg.vocab_size).items()}
        tree, jopt, jm_ = jstep(tree, jopt, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        flat, topt, tm_ = tstep(flat, topt, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        out["jl"].append(float(jm_["loss"]))
        out["tl"].append(float(tm_["loss"]))
        if i == 0:
            out["jmu1"], out["tmu1"] = moments(jopt, topt, "mu")
    out["jmu"], out["tmu"] = moments(jopt, topt, "mu")
    out["jnu"], out["tnu"] = moments(jopt, topt, "nu")
    out.update(jl=np.array(out["jl"]), tl=np.array(out["tl"]),
               jp=_leaves(_np_tree(tree)),
               tp=_leaves(lm_params_to_reference(tm.layout, flat)))
    return types.SimpleNamespace(**out)


def _assert_leafwise(got, want, rel, what):
    """Every leaf of ``got`` within ``rel`` times the largest magnitude of
    the same leaf of ``want`` (a gradient's small elements cancel, so an
    elementwise relative bound would measure rounding, not the port)."""
    assert set(got) == set(want)
    for path in want:
        scale = np.abs(want[path]).max()
        assert scale > 0, (what, path)
        err = np.abs(got[path] - want[path]).max()
        assert err <= rel * scale, (what, path, err / scale)


def _assert_f32_steps(r):
    """The f32 checks of a :func:`_run_steps` result: the loss of every
    step within 1e-5 relative; every param within 1e-4; the moments (the
    gradients' decayed sums and squares) within 1e-4 of each leaf's
    largest magnitude; and the update of every leaf, p − init, within
    2e-3 of its norm in the reference (an element whose gradient sits at
    the rounding floor may move ±lr apart, the rest agree far closer)."""
    np.testing.assert_allclose(r.tl, r.jl, rtol=1e-5)
    assert set(r.tp) == set(r.jp)
    for path in r.jp:
        np.testing.assert_allclose(r.tp[path], r.jp[path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)
    _assert_leafwise(r.tmu, r.jmu, 1e-4, "mu")
    _assert_leafwise(r.tnu, r.jnu, 1e-4, "nu")
    for path in r.jp:
        dj, dt = r.jp[path] - r.init[path], r.tp[path] - r.init[path]
        assert np.linalg.norm(dj) > 0, path
        assert np.linalg.norm(dt - dj) <= 2e-3 * np.linalg.norm(dj), \
            (path, np.linalg.norm(dt - dj) / np.linalg.norm(dj))


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,bias", [(0, 0.0), (3, 1.0), (9, 2.5)])
def test_make_lm_stream_equals_reference(seed, bias):
    j = j_make_lm_stream(16, 24, 512, seed=seed, topic_bias=bias)
    t = make_lm_stream(16, 24, 512, seed=seed, topic_bias=bias)
    assert set(j) == set(t)
    for k in j:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family):
    """Three AdamW steps from the same init and batches in f32: the loss,
    the params, the moments and the update (:func:`_assert_f32_steps`)."""
    _assert_f32_steps(_run_steps(FAMILIES[family]))


def test_train_step_bf16_trains_f32_leaves_as_f32():
    """The hybrid smoke variant in bf16 (params and compute).

    Three steps at lr 1e-4: the f32 leaves (``A_log``, ``D``,
    ``dt_bias``) change and match the reference's within 1e-4 as f32
    numbers, and their update (p − init) within 5 % of its norm in the
    reference (the second and third steps divide moments of gradients that
    differ as below: 2.8 % here); the bf16 leaves within three bf16 ulps of their magnitude
    plus 2·3·lr (an element whose gradient changes sign between the two
    roundings steps the other way, 2·lr apart a step). The first step's gradient (AdamW's first moment) of every
    leaf within 6 % of the leaf's largest magnitude: the two packages round
    the bf16 forward at other places (the reference forms attention scores
    and x·dt in bf16 where the port's plain kernels keep f32), which moves
    the gradient by up to 3.2 % here.

    One step at lr 1e-2, which moves nearly every bf16 value: every leaf
    changes, each bf16 value of the port lands on the reference's for at
    least 97 % of each leaf (the rest one bf16 ulp apart, from the forward's
    rounding), and the f32 leaves' update within 1 % of its norm."""
    r = _run_steps("hymba-1.5b", **BF16)
    np.testing.assert_allclose(r.tl, r.jl, rtol=2e-2)
    wide = sorted(r.layout.wide)
    assert wide == ["layers.ssm.A_log", "layers.ssm.D", "layers.ssm.dt_bias"]
    for path in r.jp:
        if path in wide:
            dj, dt = r.jp[path] - r.init[path], r.tp[path] - r.init[path]
            assert not np.array_equal(r.tp[path], r.init[path]), path
            np.testing.assert_allclose(r.tp[path], r.jp[path], rtol=1e-4,
                                       atol=1e-4, err_msg=path)
            assert np.linalg.norm(dt - dj) <= 5e-2 * np.linalg.norm(dj), path
        else:
            np.testing.assert_allclose(r.tp[path], r.jp[path],
                                       rtol=3 * 2 ** -8, atol=6e-4,
                                       err_msg=path)
    _assert_leafwise(r.tmu1, r.jmu1, 6e-2, "first-step gradient")

    big = _run_steps("hymba-1.5b", steps=1, lr=1e-2, **BF16)
    for path in big.jp:
        dj = big.jp[path] - big.init[path]
        dt = big.tp[path] - big.init[path]
        assert (dj != 0).any() and (dt != 0).any(), path
        if path in wide:
            assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj), path
        else:
            agree = np.mean(big.tp[path] == big.jp[path])
            assert agree >= 0.97, (path, agree)


def test_train_step_accum_steps_matches_reference():
    """``accum_steps=2``: two microbatches' f32 gradients summed, as the
    reference's scan does; the checks of the plain f32 step."""
    _assert_f32_steps(_run_steps("mamba2-370m", steps=2, accum=2))


@pytest.mark.spmd
def test_remat_raises_and_sync_step_is_gossip_only(tmp_path):
    """``TrainConfig()`` (remat on, the reference's default) trains: one
    step's loss equals the ``remat=False`` step's bit for bit, its first
    moment (0.1 times the clipped gradient) agrees within 1e-5 of each
    leaf's largest magnitude, and ``loss_fn``'s default (remat) forward
    equals the plain one. The gossip backend's sync step builds on a
    one-rank gloo group (``make_swarm_mesh``) and its propose and commit
    give the full ring's mean and the gated select, as the reference's
    ``make_swarm_sync_step`` does."""
    _, tcfg = _cfgs("mamba2-370m")
    model = build_model(tcfg)
    params, opt = ttrain.init_train_state(
        model, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v[0]) for k, v in _batch(
        np.random.default_rng(0), 1, 2, 16, tcfg.vocab_size).items()}
    out = {}
    for remat in (True, False):
        p, o = params.clone(), {k: v.clone() for k, v in opt.items()}
        out[remat] = ttrain.make_train_step(
            model, TrainConfig(remat=remat, warmup_steps=0))(p, o, batch)
    assert torch.equal(out[True][2]["loss"], out[False][2]["loss"])
    values = model.layout.value_layout
    _assert_leafwise(_leaves(to_reference_tree(values, out[True][1]["mu"])),
                     _leaves(to_reference_tree(values,
                                               out[False][1]["mu"])),
                     1e-5, "remat first moment")
    tree = model.layout.unflatten_parts(model.layout.parts(params))
    assert torch.equal(model.loss_fn(tree, batch)[0],
                       model.loss_fn(tree, batch, remat=False)[0])
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_swarm_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh, axis = make_swarm_mesh(4)
        propose, commit = ttrain.make_swarm_sync_step(
            SwarmConfig(topology="full", merge="mean", lora_only=False), mesh,
            axis, [1] * 4)
        stacked = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        cand = propose(stacked)
        assert torch.allclose(cand, stacked.mean(0).expand(4, 3))
        out = commit(cand, stacked, torch.tensor([1.0, 0.0, 1.0, 0.0]),
                     torch.ones(4))
        assert torch.equal(out[1::2], stacked[1::2])
        assert torch.equal(out[0::2], cand[0::2])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_train_step_matches_reference(family):
    """``remat=True`` on both sides (the reference's ``jax.checkpoint`` of
    its layer scan, the port's checkpointed blocks): three steps held as
    the plain steps are (:func:`_assert_f32_steps`), and the first step's
    gradient (AdamW's first moment) within 1e-4 of each leaf's largest
    magnitude."""
    r = _run_steps(FAMILIES[family], remat=True)
    _assert_leafwise(r.tmu1, r.jmu1, 1e-4, "first-step gradient")
    _assert_f32_steps(r)


def test_swarm_train_step_is_the_vmap_of_the_step():
    """``make_swarm_train_step`` over [N, P] equals the per-node step
    node by node (both through the flash and SSD Functions: the vmapped
    one through their vmap rules)."""
    _, tcfg = _cfgs("hymba-1.5b")
    model = build_model(tcfg)
    tc = _tc(TrainConfig)
    ps = [ttrain.init_train_state(model, torch.Generator().manual_seed(i),
                                  "cpu") for i in range(3)]
    batch = _batch(np.random.default_rng(2), 3, 2, 32, tcfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    stacked = torch.stack([p for p, _ in ps])
    opt = {k: torch.stack([o[k] for _, o in ps]) for k in ps[0][1]}
    sp, so, sm = ttrain.make_swarm_train_step(model, tc)(stacked, opt, batch)
    step = ttrain.make_train_step(model, tc)
    for i, (p, o) in enumerate(ps):
        p1, o1, m1 = step(p, o, {k: v[i] for k, v in batch.items()})
        for key in ("mu", "nu"):
            scale = o1[key].abs().max()
            assert (so[key][i] - o1[key]).abs().max() <= 1e-5 * scale, key
        # the update at lr: an element whose gradient sits at the rounding
        # floor (|mu| within 1e-6 of the largest) divides by ~eps and may
        # move up to lr apart; every other element within 1e-5 / 1e-6
        floor = o1["mu"].abs() <= 1e-6 * o1["mu"].abs().max()
        close = torch.isclose(sp[i], p1, rtol=1e-5, atol=1e-6)
        assert (close | floor).all(), (~close).sum()
        assert ((sp[i] - p1).abs() <= tc.lr).all()
        assert not torch.equal(sp[i], p)
        torch.testing.assert_close(sm["loss"][i], m1["loss"], rtol=1e-6,
                                   atol=0)


# ---------------------------------------------------------------------------
# the kernels' Functions under vmap(grad)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
def test_flash_function_grad_under_vmap_matches_jax(window):
    """dQ, dK, dV of ``flash_apply`` under ``torch.func.vmap(grad)`` over
    N = 3 nodes against ``jax.vmap(jax.value_and_grad)`` of the reference's
    ``attention_ref`` (GQA, causal, window), f32 at 1e-5."""
    rng = np.random.default_rng(0)
    n, b, h, hkv, s, d = 3, 2, 4, 2, 16, 32
    q = rng.normal(0, 1, (n, b, h, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (n, b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (n, b, hkv, s, d)).astype(np.float32)
    w = rng.normal(0, 1, (n, b, h, s, d)).astype(np.float32)

    def jloss(q, k, v, w):
        return jnp.sum(jnp.sin(j_attention_ref(q, k, v, causal=True,
                                               window=window)) * w)

    jl, jg = jax.vmap(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        q, k, v, w)

    def tloss(q, k, v, w):
        return torch.sum(torch.sin(flash_apply(q, k, v, causal=True,
                                               window=window)) * w)

    tg, tl = torch.func.vmap(torch.func.grad_and_value(
        tloss, argnums=(0, 1, 2)))(*(torch.from_numpy(a)
                                     for a in (q, k, v, w)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_function_grad_under_vmap_matches_jax(g):
    """The gradients of ``ssd_apply`` (y and the final state) under
    ``torch.func.vmap(grad)`` over N = 3 nodes, each with its own
    ``A_log``, against ``jax.vmap(jax.value_and_grad)`` of the reference's
    jnp ``ssd_chunked``, f32 at 1e-4."""
    rng = np.random.default_rng(1)
    n, b, s, h, p, st, chunk = 3, 2, 32, 4, 8, 8, 16
    x = rng.normal(0, 1, (n, b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (n, b, s, h)))).astype(np.float32)
    a_log = rng.normal(0, 0.5, (n, h)).astype(np.float32)
    bm = rng.normal(0, 1, (n, b, s, g, st)).astype(np.float32)
    cm = rng.normal(0, 1, (n, b, s, g, st)).astype(np.float32)
    wy = rng.normal(0, 1, (n, b, s, h, p)).astype(np.float32)
    ws = rng.normal(0, 1, (n, b, h, p, st)).astype(np.float32)

    def jloss(x, dt, a_log, bm, cm, wy, ws):
        y, state = j_ssd_chunked(x, dt, a_log, bm, cm, chunk)
        return jnp.sum(y * wy) + jnp.sum(state * ws)

    jl, jg = jax.vmap(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        x, dt, a_log, bm, cm, wy, ws)

    def tloss(x, dt, a_log, bm, cm, wy, ws):
        y, state = ssd_apply(x, dt, a_log, bm, cm, chunk=chunk)
        return torch.sum(y * wy) + torch.sum(state * ws)

    tg, tl = torch.func.vmap(torch.func.grad_and_value(
        tloss, argnums=(0, 1, 2, 3, 4)))(*(torch.from_numpy(a) for a in (
            x, dt, a_log, bm, cm, wy, ws)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# LM swarm rounds on the engine backend
# ---------------------------------------------------------------------------

SIZES = [64, 128, 192, 256]


def _lm_sessions(arch, lora=False, **kw):
    """A reference and a port ``SwarmSession`` of an LM smoke variant with
    per-node params (node i from key i; with ``lora``, one base and each
    node's rank-4 adapters from key 1 + i, as the CLI injects them), the
    reference's weights carried across, the CLI's train step and gate
    metric 1 / (1 + loss)."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg, lora_rank=4 if lora else 0)
    trees = []
    for i in range(4):
        t = jm.init(jax.random.key(0 if lora else i))
        if lora:
            t = jinject_lora(t, jax.random.key(1 + i), rank=4)
        trees.append(t)
    jbase = jtrain.make_train_step(jm, _tc(JTrainConfig))

    def jeval(p, v):
        return 1.0 / (1.0 + jm.loss_fn(p, v, remat=False)[0])

    scfg = dict(n_nodes=4, sync_every=2, lora_only=lora, **kw)
    js = JSession(JSwarmConfig(**scfg), lambda p, o, b, s: jbase(p, o, b),
                  jeval, params=trees, opt_state=[jadamw_init(t)
                                                  for t in trees],
                  data_sizes=SIZES, seed=0)
    flat = [lm_params_from_reference(tm.layout, _np_tree(t)) for t in trees]
    tbase = ttrain.make_train_step(tm, _tc(TrainConfig))
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + tm.loss_fn(
        tm.layout.unflatten(p), v, remat=False)[0]))

    def make():
        return SwarmSession(SwarmConfig(**scfg),
                            lambda p, o, b, s: tbase(p, o, b),
                            lambda p, v: veval(p, v), params=flat,
                            opt_state=adamw_init(tm.layout.parts(flat[0])),
                            data_sizes=SIZES, layout=tm.layout,
                            device="cpu")

    return js, make, tm


def _lm_round_data(rng, vocab, rounds=2, t=2, b=2, s=16):
    blocks = [_batch(rng, t * 4, b, s, vocab) for _ in range(rounds)]
    blocks = [{k: v.reshape((t, 4) + v.shape[1:]) for k, v in blk.items()}
              for blk in blocks]
    return blocks, _batch(rng, 4, 4, s, vocab)


def _check_lm_round(js, ts, layout, jlog, tlog, int8_rounds=0):
    """Gates equal, gate metrics within 1e-5 relative, every node's params
    (and the wire reference) within 1e-4. On the int8 wire a local-step
    difference of 1e-7 can land a value on the other side of a rounding
    boundary of the wire's grid; its reconstruction, and so the merge, then
    moves one quantization step (at most max |leaf| / 127) in that round:
    after ``int8_rounds`` rounds at most 0.1 % of a leaf's values may
    exceed 1e-4, none by more than that many steps."""
    np.testing.assert_array_equal(tlog["gates"].numpy(),
                                  np.asarray(jlog["gates"]))
    for key in ("metric_local", "metric_merged"):
        np.testing.assert_allclose(tlog[key].numpy(), np.asarray(jlog[key]),
                                   rtol=1e-5)
    pairs = [(_leaves(lm_params_to_reference(layout, ts.state.params)),
              _leaves(_np_tree(js.state.params)))]
    if js.state.wire is not None:
        pairs.append((_leaves(ts._reference_tree(ts.state.wire)),
                      _leaves(_np_tree(js.state.wire))))
    for got, want in pairs:
        assert set(got) == set(want)
        for path in want:
            if not int8_rounds:
                np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                           atol=1e-4, err_msg=path)
                continue
            err = np.abs(got[path] - want[path])
            assert np.mean(err > 1e-4 + 1e-4 * np.abs(want[path])) <= 1e-3, \
                (path, np.mean(err > 1e-4 + 1e-4 * np.abs(want[path])))
            step = np.abs(want[path]).max() / 127
            assert err.max() <= int8_rounds * step + 1e-4, (path, err.max())


@pytest.mark.parametrize("arch,kw", [
    ("minicpm-2b", dict(merge="fedavg", topology="ring")),
    ("mamba2-370m", dict(merge="fisher", topology="full", wire_dtype="int8",
                         wire_block=128)),
], ids=["fedavg-f32-dense", "fisher-int8-ssm"])
def test_lm_swarm_rounds_match_reference(arch, kw):
    """Two rounds (2 local steps + a gated sync each) of an LM swarm with
    per-node params against the reference's engine-backend session: gates,
    gate metrics, every node's committed params and the int8 wire's
    reference θ̂ (tolerances of :func:`_check_lm_round`)."""
    js, make, tm = _lm_sessions(arch, **kw)
    ts = make()
    blocks, val = _lm_round_data(np.random.default_rng(3),
                                 tm.cfg.vocab_size)
    jval = {k: jnp.asarray(v) for k, v in val.items()}
    for r, blk in enumerate(blocks, 1):
        jlog = js.round({k: jnp.asarray(v) for k, v in blk.items()}, jval)
        tlog = ts.round(blk, val)
        _check_lm_round(js, ts, tm.layout, jlog, tlog,
                        int8_rounds=r if kw.get("wire_dtype") == "int8"
                        else 0)
    assert ts.payload_params == js.payload_params == tm.layout.n_values


def test_lm_swarm_adapter_only_sync_matches_reference():
    """``lora_only`` with ``payload="full"`` (the CLI's ``--lora``): two
    rounds of a LoRA'd hybrid against the reference's session (gates,
    metrics, params); at every sync the base leaves are their pre-sync
    values bit for bit and only the adapters merge; the payload is the
    adapters' values."""
    js, make, tm = _lm_sessions("hymba-1.5b", lora=True, merge="fedavg",
                                topology="full")
    ts, twin = make(), make()
    layout = tm.layout
    blocks, val = _lm_round_data(np.random.default_rng(4),
                                 tm.cfg.vocab_size)
    jval = {k: jnp.asarray(v) for k, v in val.items()}
    base = [lf.path for lf in layout.leaves if "lora_" not in lf.path]
    for blk in blocks:
        jlog = js.round({k: jnp.asarray(v) for k, v in blk.items()}, jval)
        tlog = ts.round(blk, val)
        _check_lm_round(js, ts, layout, jlog, tlog)
        # the same round in its two halves: local steps, then the sync
        st = twin.state
        p_loc, opt, _, _ = twin.engine.local_steps(
            st.params, st.opt_state, {k: torch.from_numpy(v)
                                      for k, v in blk.items()}, st.step)
        committed, _ = twin.engine.sync(p_loc, {k: torch.from_numpy(v)
                                                for k, v in val.items()})
        assert torch.equal(committed, ts.state.params)
        before, after = layout.unflatten(p_loc), layout.unflatten(committed)
        for path in base:
            assert torch.equal(after[path], before[path]), path
        assert not torch.equal(after["layers.attn.q.lora_A"],
                               before["layers.attn.q.lora_A"])
        twin._state = dataclasses.replace(st, params=committed,
                                          opt_state=opt, step=st.step + 2)
    assert ts.payload_params == js.payload_params == sum(
        lf.size for lf in layout.leaves if "lora_" in lf.path)


def _close_or_step(got, want, rtol, atol, step, frac, what):
    """``got`` within ``rtol``/``atol`` of ``want``, but for at most
    ``frac`` of the values, which may be one quantization ``step`` apart."""
    err = np.abs(got - want)
    off = err > atol + rtol * np.abs(want)
    assert off.mean() <= frac, (what, off.mean())
    assert (err[off] <= step + atol + rtol * np.abs(want[off])).all(), \
        (what, err.max(), step)


@pytest.mark.parametrize("merge,wire", [("fisher", "f32"), ("fedavg", "int8")])
def test_bf16_lm_sync_merges_f32_leaves_as_f32(merge, wire):
    """One sync of a bf16 ssm swarm (f32 ``A_log``/``D``/``dt_bias`` as
    wide leaves), port and reference engines on the same carried state
    (params, importance statistics, wire reference): fisher on the f32
    wire, fedavg on the int8 wire. The wide leaves commit as f32 numbers
    within 1e-6, the bf16 leaves within one bf16 ulp or 1e-7 (the merge's
    f32 sum in another order may round the other way, and cancels near
    zero), the new wire reference within 1e-6, gates equal, and a rejected
    node keeps its params bit for bit. On the int8 wire the reference's
    jitted round trip multiplies by the reciprocal of 127 where the
    definition (the port, numpy) divides, so a block's scale can sit an
    f32 ulp apart and, for about one value in 10^6, a value rounds to the
    neighbouring int8 level: at most 1e-5 of the values may then be one
    quantization step apart (max |θ − θ̂| / 127 of the leaf). (Fisher on
    the int8 wire also quantizes the importance mass after a normalization
    summed in another order: the round test above holds that path.)"""
    jcfg, tcfg = _cfgs("mamba2-370m", **BF16)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    layout = tm.layout
    trees = [_np_tree(jm.init(jax.random.key(i))) for i in range(4)]
    rng = np.random.default_rng(5)
    stats = [jax.tree.map(lambda a: np.abs(rng.normal(0, 1, a.shape)).astype(
        np.float32), t) for t in trees]
    wires = [jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(
        0, 1e-3, a.shape)).astype(np.float32), t) for t in trees]
    val = _batch(rng, 4, 2, 16, tcfg.vocab_size)
    kw = dict(n_nodes=4, sync_every=1, merge=merge, topology="ring",
              lora_only=False, wire_dtype=wire, wire_block=128,
              val_threshold=1.0)

    def jeval(p, v):
        return 1.0 / (1.0 + jm.loss_fn(p, v, remat=False)[0])

    stack = functools.partial(jax.tree.map, lambda *a: jnp.stack(a))
    js = JSession(JSwarmConfig(**kw), None, jeval, params=trees,
                  data_sizes=SIZES, seed=0)
    jstats = stack(*stats) if merge == "fisher" else None
    jwire = stack(*wires) if wire == "int8" else None
    jcommitted, jlog = jax.jit(js.engine.sync)(
        stack(*trees), {k: jnp.asarray(v) for k, v in val.items()},
        stats=jstats, wire=jwire)
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + tm.loss_fn(
        layout.unflatten(p), v, remat=False)[0]))
    params = torch.stack([lm_params_from_reference(layout, t)
                          for t in trees])
    values = layout.value_layout
    ts = SwarmSession(SwarmConfig(**kw), None, lambda p, v: veval(p, v),
                      params=list(params), data_sizes=SIZES, layout=layout,
                      device="cpu")
    tcommitted, tlog = ts.engine.sync(
        params, {k: torch.from_numpy(v) for k, v in val.items()},
        stats=(torch.stack([lm_params_from_reference(values, s)
                            for s in stats]) if merge == "fisher" else None),
        wire=(torch.stack([lm_params_from_reference(values, w)
                           for w in wires]) if wire == "int8" else None))
    gates = np.asarray(jlog["gates"])
    np.testing.assert_array_equal(tlog["gates"].numpy(), gates)
    assert gates.any() and not gates.all()
    want = _leaves(_np_tree(jcommitted))
    got = _leaves(lm_params_to_reference(layout, tcommitted))
    steps = {path: 0.0 for path in want}
    if wire == "int8":
        wt = _leaves(lm_params_to_reference(values, tlog["wire"]))
        wl = _leaves(_np_tree(jlog["wire"]))
        p0 = _leaves(lm_params_to_reference(layout, params))
        r0 = _leaves(lm_params_to_reference(values, torch.stack([
            lm_params_from_reference(values, w) for w in wires])))
        steps = {path: np.abs(p0[path] - r0[path]).max() / 127
                 for path in want}
        for path in wl:
            _close_or_step(wt[path], wl[path], 1e-6, 1e-6, steps[path],
                           1e-5, path)
    else:
        assert "wire" not in tlog
    for path in want:
        if path in layout.wide:
            _close_or_step(got[path], want[path], 1e-6, 1e-6, steps[path],
                           1e-5, path)
        else:
            # one bf16 ulp: at most 2^-7 of the value
            _close_or_step(got[path], want[path], 2 ** -7, 1e-7,
                           steps[path], 1e-5, path)
    for i in np.flatnonzero(~gates):
        assert torch.equal(tcommitted[i], params[i])


def test_bf16_lm_swarm_trains_wide_leaves_and_checkpoints(tmp_path):
    """Two rounds of a bf16 ssm swarm (fisher, int8 wire) through the
    session: its f32 leaves train and merge as f32 numbers (they change,
    every node's stay finite), the moments, statistics and wire live over
    the values, and a checkpoint restores every field bit for bit."""
    _, tcfg = _cfgs("mamba2-370m", **BF16)
    model = build_model(tcfg)
    layout = model.layout
    ps = [model.init(torch.Generator().manual_seed(i), "cpu")
          for i in range(4)]
    tbase = ttrain.make_train_step(model, _tc(TrainConfig, lr=1e-3))
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
        layout.unflatten(p), v, remat=False)[0]))
    kw = dict(n_nodes=4, sync_every=2, merge="fisher", topology="ring",
              lora_only=False, wire_dtype="int8", wire_block=128)

    def make():
        return SwarmSession(SwarmConfig(**kw),
                            lambda p, o, b, s: tbase(p, o, b),
                            lambda p, v: veval(p, v), params=ps,
                            opt_state=adamw_init(layout.parts(ps[0])),
                            data_sizes=SIZES, layout=layout, device="cpu")

    sess = make()
    blocks, val = _lm_round_data(np.random.default_rng(6), tcfg.vocab_size)
    for blk in blocks:
        sess.round(blk, val)
    st = sess.state
    v = layout.n_values
    assert st.params.shape == (4, layout.size)
    assert st.params.dtype == torch.bfloat16
    for t in (st.opt_state["mu"], st.opt_state["nu"], st.stats, st.wire):
        assert t.shape == (4, v) and t.dtype == torch.float32
    wide0 = layout.parts(torch.stack(ps))[0]
    wide = layout.parts(st.params)[0]
    assert torch.isfinite(wide).all() and not torch.equal(wide, wide0)
    assert sess.payload_params == v
    path = str(tmp_path / "s.msgpack")
    sess.save(path)
    back = make().load(path)
    # the slots compared as bits: a wide leaf's low half may read as a NaN
    assert torch.equal(back.state.params.view(torch.int16),
                       st.params.view(torch.int16))
    for name in ("stats", "wire"):
        assert torch.equal(getattr(back.state, name), getattr(st, name))
    for k in st.opt_state:
        assert torch.equal(back.state.opt_state[k], st.opt_state[k])
    tree = sess.node_params[0]
    assert np.asarray(tree["layers"]["ssm"]["A_log"]).dtype == np.float32


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_plain_and_swarm_on_cpu(tmp_path, capsys):
    """``main()`` with ``--device cpu``: plain training prints its step
    lines; a swarm run prints ``sync gates=`` lines and writes
    ``session.msgpack``, ``node{i}.msgpack`` (which the reference's
    ``load_pytree`` reads into its own model's tree) and ``sync_log.json``;
    ``--resume`` continues from the step the session was saved at."""
    base = ["--arch", "mamba2-370m", "--smoke", "--batch", "2", "--seq",
            "32", "--device", "cpu"]
    assert ttrain.main(base + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"step    2 loss=\d", out)
    ck = tmp_path / "ck"
    assert ttrain.main(base + ["--steps", "4", "--swarm-nodes", "4",
                               "--sync-every", "2", "--ckpt-dir",
                               str(ck)]) == 0
    out = capsys.readouterr().out
    assert len(re.findall(r"sync gates=\[(True|False)(, (True|False)){3}\]",
                          out)) == 2
    like = jbuild(jconfigs.smoke_variant(jconfigs.get_config(
        "mamba2-370m"))).init(jax.random.key(0))
    for i in range(4):
        tree = jload_pytree(str(ck / f"node{i}.msgpack"), like)
        assert all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree.leaves(tree))
    assert (ck / "sync_log.json").exists()
    assert ttrain.main(base + ["--steps", "6", "--swarm-nodes", "4",
                               "--sync-every", "2", "--resume",
                               str(ck / "session.msgpack")]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 4 (round 2)" in out
    assert re.search(r"step    6 loss=.* sync gates=", out)
    assert "step    2 " not in out
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else SystemExit):
        if torch.cuda.is_available():
            raise SystemExit
        ttrain.main(["--arch", "mamba2-370m", "--smoke", "--steps", "1"])
