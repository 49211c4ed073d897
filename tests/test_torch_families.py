"""The port's moe, vlm and audio (enc-dec) families (`repro_torch.models.
moe`, the vlm projector of `repro_torch.models.transformer`,
`repro_torch.models.encdec`) against the reference on the same numpy
inputs and the reference's own weights, carried across with
`repro_torch.convert.lm_params_from_reference`: the MoE layer (output, aux
loss, expert ids and keep masks; capacity drops; bf16), the smoke models'
prefill, decode and ``loss_fn`` (granite-moe, phi3.5-moe, internvl2 with
patch embeddings, seamless's ``encode`` + ``decode_step`` and
``forward_encdec``), the bf16 forwards, the weight carry of the three trees
bit for bit (the router's f32 weight a wide leaf of a bf16 layout), the
engine's token streams on the granite smoke model against the JAX
engine's, a granite train step against the reference's, the CLI on a moe
swarm and its refusal of vlm and audio, and the attention forms that take
the flash kernel. Smoke widths, f32 unless stated, TF32 off."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.checkpointing import load_pytree as jload_pytree  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.encdec import encode as jencode  # noqa: E402
from repro.models.encdec import forward_encdec as jforward_encdec  # noqa: E402
from repro.models.moe import init_moe as jinit_moe  # noqa: E402
from repro.models.moe import moe as jmoe  # noqa: E402
from repro.serve import BucketPolicy as JBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import (lm_params_from_reference,  # noqa: E402
                                 lm_params_to_reference, to_reference_tree)
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model, nest  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.encdec import encode as tencode  # noqa: E402
from repro_torch.models.encdec import forward_encdec  # noqa: E402
from repro_torch.serve import BucketPolicy, ServeEngine  # noqa: E402
from test_torch_train import (_assert_f32_steps,  # noqa: E402
                              _assert_leafwise, _leaves, _run_steps)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

GRANITE, PHI = "granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"
VLM, AUDIO = "internvl2-1b", "seamless-m4t-medium"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _smoke(arch, **kw):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).replace(**kw)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).replace(**kw)
    return jcfg, tcfg


def _models(arch, seed=0, **kw):
    """The reference's model and init, and the port's model with the same
    weights carried across (``{path: tensor}`` views)."""
    jcfg, tcfg = _smoke(arch, **kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    flat = lm_params_from_reference(tm.layout, tree)
    return jm, tm, tree, tm.layout.unflatten(flat)


def _get(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _j_routing(p, x, cfg):
    """The reference's expert ids [B,S,k] and keep mask [B·S·k]: the first
    steps of ``repro.models.moe.moe``, which returns neither."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32)
                           @ jnp.asarray(p["router"]["w"]), axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    cap_g = int(max(1, round(s * k / e * cfg.capacity_factor)))
    flat = ids.reshape(b, s * k)
    pos = jnp.cumsum(jax.nn.one_hot(flat, e, dtype=jnp.int32), axis=1) - 1
    pos = jnp.take_along_axis(pos, flat[..., None], axis=2)[..., 0]
    return np.asarray(ids), np.asarray(pos < cap_g).reshape(-1)


def _moe_case(seed, dtype=np.float32, **kw):
    jcfg, tcfg = _smoke(GRANITE, **kw)
    p = jax.tree.map(np.asarray, jinit_moe(jax.random.key(seed), jcfg))
    x = np.random.default_rng(seed).normal(
        0, 1, (3, 24, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                      p)
    if dtype != np.float32:  # the experts in bf16, the router f32
        tp["experts"] = jax.tree.map(lambda t: t.to(torch.bfloat16),
                                     tp["experts"])
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    return jcfg, tcfg, p, jx, tp, tx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_matches_reference(seed):
    jcfg, tcfg, p, jx, tp, tx = _moe_case(seed)
    want, jaux = jmoe(p, jx, jcfg)
    got, aux = tmoe.moe(tp, tx, tcfg)
    _close(got, want, 2e-4, "y")
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert aux.dtype == torch.float32
    ids, keep = _j_routing(p, jx, jcfg)
    _, tids, _ = tmoe.route(tp, tx, tcfg)
    _, tkeep, _ = tmoe.dispatch(tids, tcfg)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_array_equal(tkeep.numpy(), keep)


def test_moe_capacity_drops_tokens_gracefully():
    """The reference's capacity case on the port: a tiny capacity drops
    assignments (the keep masks agree), the output stays finite and equal
    to the reference's, and differs from the output with nothing dropped."""
    jcfg, tcfg, p, jx, tp, tx = _moe_case(3, capacity_factor=0.1)
    want, jaux = jmoe(p, jx, jcfg)
    got, aux = tmoe.moe(tp, tx, tcfg)
    _close(got, want, 2e-4)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    _, keep = _j_routing(p, jx, jcfg)
    _, tkeep, cap_g = tmoe.dispatch(tmoe.route(tp, tx, tcfg)[1], tcfg)
    assert cap_g == 1 and not keep.all()
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    full, _ = tmoe.moe(tp, tx, tcfg.replace(capacity_factor=8.0))
    assert bool(torch.isfinite(got).all())
    assert float((got - full).abs().max()) > 1e-6


def test_moe_bf16_matches_reference():
    """bf16 activations and experts, the router in f32: the ids and keep
    masks equal the reference's, the output within two bf16 ulps of its
    magnitude."""
    jcfg, tcfg, p, jx, tp, tx = _moe_case(4, dtype=jnp.bfloat16, **BF16)
    want, jaux = jmoe(jax.tree.map(jnp.asarray, dict(
        p, experts=jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                p["experts"]))), jx, jcfg)
    got, aux = tmoe.moe(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -6 * np.abs(want).max(), err
    assert abs(float(aux) - float(jaux)) <= 1e-6
    ids, keep = _j_routing(p, jx, jcfg)
    _, tids, _ = tmoe.route(tp, tx, tcfg)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_array_equal(tmoe.dispatch(tids, tcfg)[1].numpy(), keep)


# ---------------------------------------------------------------------------
# the smoke models: prefill, decode, loss
# ---------------------------------------------------------------------------

def _vlm_batch(cfg, rng, b, s):
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "patch_embeds": rng.normal(0, 1, (b, cfg.n_patches,
                                              cfg.frontend_dim)).astype(
                np.float32)}


@pytest.mark.parametrize("arch", [GRANITE, PHI, VLM])
def test_prefill_and_decode_match_reference(arch):
    """``model.prefill`` then four ``model.decode`` steps in both packages,
    the same weights and inputs: last-position logits at every step (a
    vlm prefill takes the patch embeddings before the text)."""
    jm, tm, tree, params = _models(arch, seed=1)
    cfg = tm.cfg
    rng = np.random.default_rng(10)
    b, s, t = 2, 20, 40
    batch = (_vlm_batch(cfg, rng, b, s) if cfg.family == "vlm" else
             {"tokens": rng.integers(0, cfg.vocab_size, (b, s))})
    start = s + (cfg.n_patches if cfg.family == "vlm" else 0)
    jc, tc = jm.init_cache(b, t), tm.init_cache(b, t, "cpu")
    want, jc = jm.prefill(tree, {k: jnp.asarray(v) for k, v in batch.items()},
                          jc)
    got, tc = tm.prefill(params, {k: _t(v) for k, v in batch.items()}, tc)
    _close(got, want, 2e-4, "prefill")
    nxt = rng.integers(0, cfg.vocab_size, (b, 4))
    for i in range(4):
        want, jc = jm.decode(tree, jnp.asarray(nxt[:, i:i + 1], jnp.int32),
                             jc, jnp.int32(start + i))
        got, tc = tm.decode(params, _t(nxt[:, i:i + 1]), tc, start + i)
        _close(got, want, 2e-4, f"decode {i}")


def _loss_batch(cfg, rng, b=2, s=16):
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _vlm_batch(cfg, rng, b, s)["patch_embeds"]
    if cfg.is_encdec:
        batch["frames"] = rng.normal(0, 1, (b, cfg.enc_seq_len,
                                            cfg.frontend_dim)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", [GRANITE, PHI, VLM, AUDIO])
def test_loss_fn_matches_reference(arch):
    """``loss_fn``'s loss, cross entropy and aux (the routers' Switch
    losses summed over the layers; zero without experts)."""
    jm, tm, tree, params = _models(arch, seed=2)
    batch = _loss_batch(tm.cfg, np.random.default_rng(11))
    jl, jmet = jm.loss_fn(tree, {k: jnp.asarray(v) for k, v in batch.items()},
                          remat=False)
    tl, tmet = tm.loss_fn(params, {k: _t(v) for k, v in batch.items()},
                          remat=False)
    for got, want in ((tl, jl), (tmet["xent"], jmet["xent"]),
                      (tmet["aux"], jmet["aux"])):
        assert abs(float(got) - float(want)) <= 2e-4 * max(1.0,
                                                           abs(float(want)))
    assert (float(tmet["aux"]) > 0) == (tm.cfg.family == "moe")
    # remat, both packages' default, checkpoints the blocks: the forward
    # is the plain one, bit for bit, and the reference's within the same
    # tolerance
    jr, _ = jm.loss_fn(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    tr, trmet = tm.loss_fn(params, {k: _t(v) for k, v in batch.items()})
    assert torch.equal(tr, tl) and torch.equal(trmet["aux"], tmet["aux"])
    assert abs(float(tr) - float(jr)) <= 2e-4 * max(1.0, abs(float(jr)))


# ---------------------------------------------------------------------------
# remat: activation checkpointing under the engine's vmap + vjp
# ---------------------------------------------------------------------------

REMAT_FAMILIES = {"dense": "minicpm-2b", "hybrid": "hymba-1.5b",
                  "moe": GRANITE, "vlm": VLM, "audio": AUDIO}


def _leaf_tree(layout, flat):
    """{dotted path: numpy} of a port ``[P]`` f32 vector (params or a
    gradient) in the reference's tree."""
    return _leaves(lm_params_to_reference(layout, flat))


@pytest.mark.parametrize("family", sorted(REMAT_FAMILIES))
def test_remat_grads_under_vmap_equal_plain(family):
    """The swarm step (``make_swarm_train_step``: vmap over 2 nodes of the
    vjp of ``loss_fn``, launch/train.py) with ``remat=True`` against
    ``remat=False``, one config of each family: the losses bit for bit and
    the first moment (0.1 times the clipped gradient) of every leaf within
    1e-5 of the leaf's largest magnitude (the recompute sums the same
    products in another order: 1e-6 of it here)."""
    _, tcfg = _smoke(REMAT_FAMILIES[family])
    model = build_model(tcfg)
    p, o = ttrain.init_train_state(model, torch.Generator().manual_seed(3),
                                   "cpu")
    rng = np.random.default_rng(4)
    batch = [_loss_batch(tcfg, rng, b=2, s=16) for _ in range(2)]
    batch = {k: torch.from_numpy(np.stack([b[k] for b in batch]))
             for k in batch[0]}
    out = {}
    for remat in (True, False):
        ps = torch.stack([p, p + 0.01 * torch.sin(p)])
        os_ = {k: torch.stack([v, v]) for k, v in o.items()}
        step = ttrain.make_swarm_train_step(model, TrainConfig(
            remat=remat, warmup_steps=0, max_steps=10))
        out[remat] = step(ps, os_, batch)
    assert torch.equal(out[True][2]["loss"], out[False][2]["loss"])
    values = model.layout.value_layout
    for i in range(2):
        got = _leaves(to_reference_tree(values, out[True][1]["mu"][i]))
        want = _leaves(to_reference_tree(values, out[False][1]["mu"][i]))
        _assert_leafwise(got, want, 1e-5, f"node {i} remat gradient")


@pytest.mark.parametrize("arch", [GRANITE, VLM, AUDIO])
def test_remat_loss_and_grads_match_reference(arch):
    """``loss_fn(..., remat=True)`` of the moe, vlm and enc-dec smoke
    models and its gradient (``torch.func.vjp``, the trainer's form)
    against the reference's ``jax.value_and_grad`` of its ``loss_fn``
    with ``remat=True``: the loss within 2e-4, every leaf's gradient
    within 1e-4 of the leaf's largest magnitude."""
    jm, tm, tree, _ = _models(arch, seed=5)
    batch = _loss_batch(tm.cfg, np.random.default_rng(12))
    jl, jg = jax.value_and_grad(lambda t: jm.loss_fn(
        t, {k: jnp.asarray(v) for k, v in batch.items()},
        remat=True)[0])(tree)
    flat = lm_params_from_reference(tm.layout, tree)
    layout = tm.layout
    tl, vjp_fn, _ = torch.func.vjp(lambda q: tm.loss_fn(
        layout.unflatten_parts(q), {k: _t(v) for k, v in batch.items()},
        remat=True), layout.parts(flat), has_aux=True)
    (tg,) = vjp_fn(torch.ones_like(tl))
    assert abs(float(tl) - float(jl)) <= 2e-4 * max(1.0, abs(float(jl)))
    _assert_leafwise(_leaf_tree(layout, layout.join(tg)),
                     _leaves(jax.tree.map(np.asarray, jg)), 1e-4,
                     "remat gradient")


def test_remat_moe_recompute_routes_as_forward(monkeypatch):
    """The checkpointed granite block's recompute routes every token to
    the experts its forward chose: the expert ids of each layer's forward
    equal those of its recompute (the backward walks the layers in
    reverse), under the trainer's vjp."""
    _, tcfg = _smoke(GRANITE)
    model = build_model(tcfg)
    p, _ = ttrain.init_train_state(model, torch.Generator().manual_seed(6),
                                   "cpu")
    seen = []
    route = tmoe.route

    def recording(*args, **kw):
        out = route(*args, **kw)
        seen.append(out[1].tolist())
        return out

    monkeypatch.setattr(tmoe, "route", recording)
    batch = {k: _t(v) for k, v in _loss_batch(
        tcfg, np.random.default_rng(7)).items()}
    layout = model.layout
    loss, vjp_fn, _ = torch.func.vjp(lambda q: model.loss_fn(
        layout.unflatten_parts(q), batch, remat=True), layout.parts(p),
        has_aux=True)
    n = tcfg.n_layers
    assert len(seen) == n
    vjp_fn(torch.ones_like(loss))
    assert len(seen) == 2 * n
    for i in range(n):
        assert seen[i] == seen[2 * n - 1 - i], i


def test_encdec_encode_and_decode_match_reference():
    """seamless: ``encode`` of the frames, its output copied into the
    cache's ``enc_out`` (the serving form), four ``decode`` steps against
    the reference's decode over the same ``enc_out``; and the
    teacher-forced ``forward_encdec``."""
    jm, tm, tree, params = _models(AUDIO, seed=3)
    cfg = tm.cfg
    rng = np.random.default_rng(12)
    b, t = 2, 24
    frames = rng.normal(0, 1, (b, cfg.enc_seq_len, cfg.frontend_dim)).astype(
        np.float32)
    jenc = jencode(tree, jm.cfg, jnp.asarray(frames))
    tenc = tencode(nest(params), cfg, _t(frames))
    _close(tenc, jenc, 2e-4, "encode")
    assert tm.prefill is None and jm.prefill is None
    jc = dict(jm.init_cache(b, t), enc_out=jenc)
    tc = tm.init_cache(b, t, "cpu")
    assert tuple(tc["enc_out"].shape) == (b, cfg.enc_seq_len, cfg.d_model)
    assert len(tc["self"]) == cfg.n_layers
    tc["enc_out"].copy_(tenc)
    toks = rng.integers(0, cfg.vocab_size, (b, 4))
    for i in range(4):
        want, jc = jm.decode(tree, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                             jc, jnp.int32(i))
        got, tc = tm.decode(params, _t(toks[:, i:i + 1]), tc, i)
        _close(got, want, 2e-4, f"decode {i}")
    toks = rng.integers(0, cfg.vocab_size, (b, 12))
    want, _ = jforward_encdec(tree, jm.cfg, jnp.asarray(frames),
                              jnp.asarray(toks, jnp.int32))
    got, aux = forward_encdec(nest(params), cfg, _t(frames), _t(toks))
    _close(got, want, 2e-4, "forward_encdec")
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", [GRANITE, VLM, AUDIO])
def test_bf16_forward_matches_reference(arch):
    """The bf16 smoke models against the reference's, same weights: logits
    within a tenth of their spread and the argmax nearly everywhere, as
    the bf16 dense, ssm and hybrid models are held (test_torch_lm)."""
    jm, tm, tree, params = _models(arch, **BF16)
    cfg = tm.cfg
    batch = _loss_batch(cfg, np.random.default_rng(9), s=24)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    if cfg.is_encdec:
        want, _ = jforward_encdec(tree, jm.cfg, jb["frames"], jb["tokens"])
        got, _ = forward_encdec(nest(params), cfg, tb["frames"], tb["tokens"])
    else:
        jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64, "cpu")
        want, _ = jm.prefill(tree, jb, jc)
        got, _ = tm.prefill(params, tb, tc)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)[..., :cfg.vocab_size]
    got = got.float().numpy()[..., :cfg.vocab_size]
    assert np.abs(got - want).max() <= 0.1 * want.std()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


# ---------------------------------------------------------------------------
# params: the trees, the carry, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, VLM, AUDIO])
def test_weight_carry_round_trip_bit_equal(arch):
    """A bf16 reference tree carried in and back bit for bit; the moe
    router's weight is the layout's one wide leaf, its f32 values kept."""
    jm, tm, _, _ = _models(arch, **BF16)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(5)))
    leaves = {leaf.path for leaf in tm.layout.leaves}
    want = {p: _get(tree, p) for p in leaves}
    assert set(jax.tree_util.tree_leaves(jax.tree.map(
        lambda a: a.size, tree))) and len(leaves) == len(
        jax.tree_util.tree_leaves(tree))
    wide = {"layers.moe.router.w"} if tm.cfg.family == "moe" else set()
    assert tm.layout.wide == wide
    flat = lm_params_from_reference(tm.layout, tree)
    assert flat.dtype == torch.bfloat16
    views = tm.layout.unflatten(flat)
    back = lm_params_to_reference(tm.layout, flat)
    for path, a in want.items():
        assert (a.dtype == np.float32) == (path in wide), path
        assert views[path].dtype == (torch.float32 if path in wide
                                     else torch.bfloat16)
        np.testing.assert_array_equal(_get(back, path),
                                      np.asarray(a, np.float32), path)


@pytest.mark.parametrize("arch", [GRANITE, PHI, VLM, AUDIO])
def test_port_init_fills_every_leaf(arch):
    """``Model.init`` writes every value, norms one and biases zero; a bf16
    moe model's router weight stays f32."""
    for kw in ({}, BF16):
        tm = build_model(_smoke(arch, **kw)[1])
        dtype = getattr(torch, tm.cfg.param_dtype)
        buf = torch.full((tm.layout.size,), float("nan"), dtype=dtype)
        tm.init(torch.Generator().manual_seed(0), "cpu", out=buf)
        views = tm.layout.unflatten(buf)
        for path, t in views.items():
            assert bool(torch.isfinite(t).all()), path
            if path.endswith("scale"):
                assert bool((t == 1).all()), path
            if path.endswith(".b"):
                assert bool((t == 0).all()), path
        if tm.cfg.family == "moe":
            assert views["layers.moe.router.w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the attention forms that take the flash kernel
# ---------------------------------------------------------------------------

def test_encoder_cross_and_prefill_attention_take_the_kernel_form(
        monkeypatch):
    """Decided by shape: the encoder's bidirectional self-attention, the
    teacher-forced cross-attention and every causal prefill go through
    ``ops.attention_op`` (the kernel on a CUDA tensor); a decode step's S =
    1 attention and its cross-attention stay plain."""
    calls = []
    real = ops.attention_op

    def counting(q, k, v, *, causal=True, window=0):
        calls.append((causal, tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "attention_op", counting)
    _, tm, _, params = _models(AUDIO)
    cfg = tm.cfg
    frames = torch.randn(2, cfg.enc_seq_len, cfg.frontend_dim)
    toks = torch.randint(0, cfg.vocab_size, (2, 10))
    tencode(nest(params), cfg, frames)
    enc = (False, (2, cfg.n_heads, cfg.enc_seq_len, cfg.head_dim),
           (2, cfg.n_kv_heads, cfg.enc_seq_len, cfg.head_dim))
    assert calls == [enc] * cfg.n_enc_layers
    calls.clear()
    forward_encdec(nest(params), cfg, frames, toks)
    self_ = (True, (2, cfg.n_heads, 10, cfg.head_dim),
             (2, cfg.n_kv_heads, 10, cfg.head_dim))
    cross = (False, (2, cfg.n_heads, 10, cfg.head_dim), enc[2])
    assert calls == [enc] * cfg.n_enc_layers + [self_, cross] * cfg.n_layers
    calls.clear()
    tm.decode(params, toks[:, :1], tm.init_cache(2, 16, "cpu"), 0)
    assert calls == []
    _, vm, _, vparams = _models(VLM)
    batch = {k: _t(v) for k, v in _vlm_batch(vm.cfg, np.random.default_rng(0),
                                             2, 6).items()}
    vm.prefill(vparams, batch, vm.init_cache(2, 32, "cpu"))
    assert len(calls) == vm.cfg.n_layers and all(c[0] for c in calls)
    before = dict(LAUNCHES)
    forward_encdec(nest(params), cfg, frames, toks)
    assert LAUNCHES == before                 # plain on a CPU tensor


# ---------------------------------------------------------------------------
# serving, training, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [GRANITE, VLM])
def test_engine_token_streams_equal_jax_engine(arch):
    """The port engine's per-node token streams on the granite smoke model
    and the internvl2 one (served as text only, as the reference's engine
    serves it) equal the JAX engine's (vocab 64, three nodes) under
    continuous batching with staggered admission; the port's slots fold
    into one batch, the reference's are vmapped, and each row is its own
    moe capacity group in both."""
    jcfg, tcfg = _smoke(arch, vocab_size=64)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jax.vmap(jm.init)(
        jax.random.split(jax.random.key(0), 3)))
    flat = lm_params_from_reference(tm.layout, tree, lead=1)
    prompts = [np.arange(1, 1 + n) % 64 for n in (5, 9, 3, 7)]
    policy = dict(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))

    def streams(eng):
        reqs = [eng.submit(p, max_new=5) for p in prompts[:2]]
        eng.step()
        reqs += [eng.submit(p, max_new=5) for p in prompts[2:]]
        eng.drain()
        return [[np.asarray(v).tolist() for v in r.node_tokens]
                for r in reqs]

    jeng = JServeEngine(jm, tree, max_len=32, max_slots=4,
                        policy=JBucketPolicy(**policy))
    teng = ServeEngine(tm, flat, max_len=32, max_slots=4, device="cpu",
                       policy=BucketPolicy(**policy))
    assert streams(teng) == streams(jeng)


def test_granite_train_step_matches_reference():
    """Three AdamW steps of the granite smoke model in both packages from
    the reference's init and batches, f32, lr 1e-4 without warmup, held as
    the other families' steps are (`test_torch_train._assert_f32_steps`):
    the loss (cross entropy plus the routers' aux) within 1e-5 relative,
    every param within 1e-4, AdamW's moments (the gradients' decayed sums
    and squares) within 1e-4 of each leaf's largest magnitude, and the
    update p − init within 2e-3 of its norm. The first moment after the
    first step, 0.1 times the gradient, holds the backward through the
    router's f32 weight, the sorted gate values, the dispatch into the
    stacked experts and the aux term."""
    r = _run_steps(GRANITE)
    for path in ("layers.moe.router.w", "layers.moe.experts.gate.w",
                 "layers.moe.experts.up.w", "layers.moe.experts.down.w"):
        assert path in r.jmu1 and np.abs(r.jmu1[path]).max() > 0, path
    _assert_leafwise(r.tmu1, r.jmu1, 1e-4, "first-step gradient")
    _assert_f32_steps(r)


def test_generate_on_encdec_equals_jax_generate():
    """``generate`` without a prefill feeds the prompt token by token
    against the cache's zero ``enc_out``, as the JAX ``generate`` does; the
    tokens equal the reference's."""
    jm, tm, tree, _ = _models(AUDIO, seed=4, vocab_size=64)
    flat = lm_params_from_reference(tm.layout, tree)
    prompt = np.random.default_rng(13).integers(0, 64, (2, 5))
    want = jgenerate(jm, tree, jnp.asarray(prompt, jnp.int32), 6, 16)
    got = generate(tm, flat, torch.from_numpy(prompt), 6, 16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cli(arch, *extra):
    return ttrain.parse_args(["--arch", arch, "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device",
                              "cpu", *extra])


def test_cli_trains_a_moe_swarm(capsys, tmp_path):
    """A granite smoke swarm through the CLI (the routers' aux in the loss,
    the vmapped step over the nodes); its node checkpoints load into the
    reference's tree with the stacked experts ``[L, E, in, out]`` as the
    session holds them (an LM's 4-D leaves are not convs)."""
    out = ttrain.run(_cli(GRANITE, "--swarm-nodes", "2", "--sync-every",
                          "2", "--ckpt-dir", str(tmp_path)))
    assert out["steps"] == 2 and len(out["sync_log"]) == 1
    assert "sync gates=" in capsys.readouterr().out
    like = jbuild(_smoke(GRANITE)[0]).init(jax.random.key(0))
    tree = jload_pytree(str(tmp_path / "node1.msgpack"), like)
    views = out["model"].layout.unflatten(out["session"].state.params[1])
    for path in ("layers.moe.experts.up.w", "layers.moe.router.w"):
        np.testing.assert_array_equal(np.asarray(_get(tree, path)),
                                      views[path].numpy(), path)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_cli_refuses_vlm_and_audio(arch):
    with pytest.raises(SystemExit, match="decoder-only"):
        ttrain.run(_cli(arch))


def test_ten_configs_build():
    """Every arch's smoke variant builds, and its layout covers the
    reference's init leaf for leaf (shapes equal)."""
    for arch in tconfigs.ARCH_IDS:
        jcfg, tcfg = _smoke(arch)
        tm = build_model(tcfg)
        shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
        for leaf in tm.layout.leaves:
            assert tuple(_get(shapes, leaf.path).shape) == leaf.shape, \
                (arch, leaf.path)
        assert len(tm.layout.leaves) == len(jax.tree_util.tree_leaves(
            shapes)), arch
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
