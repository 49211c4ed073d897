"""The port's LM families (`repro_torch.models`: dense, ssm and hybrid)
against the reference on the same numpy inputs and the reference's own
weights, carried across with `repro_torch.convert.lm_params_from_reference`:
the config copies (all ten archs; the moe, vlm and enc-dec families'
models are held in tests/test_torch_families.py), the layer primitives, the attention module (windows,
GQA, the KV cache), the SSM mixer (chunked prefill with state, decode),
whole-model logits, prefill + decode, the decode-matches-forward property,
and the param conversion's round trip. Smoke sizes, f32, TF32 off;
the bf16 cases hold the leaves the reference keeps in f32 and the logits
against its bf16 models."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.attention import attention as jattention  # noqa: E402
from repro.models.attention import init_attention, make_cache  # noqa: E402
from repro.models.ssm import init_ssm, make_ssm_state  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro.models.ssm import ssm_block as jssm_block  # noqa: E402
from repro.models.transformer import forward_lm as jforward  # noqa: E402
from repro.models.transformer import layer_windows as jwindows  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (lm_params_from_reference,  # noqa: E402
                                 lm_params_to_reference)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import build_model, nest  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.attention import attention as tattention  # noqa: E402
from repro_torch.models.ssm import ssd_chunked as t_ssd_chunked  # noqa: E402
from repro_torch.models.ssm import ssm_block as tssm_block  # noqa: E402
from repro_torch.models.transformer import forward_lm as tforward  # noqa: E402
from repro_torch.models.transformer import layer_windows  # noqa: E402

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["hymba-1.5b", "minicpm-2b", "mamba2-370m"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    """Reference numpy/jax tree → the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _smoke(arch, **kw):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).replace(**kw)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).replace(**kw)
    return jcfg, tcfg


def _models(arch, seed=0, **kw):
    """The reference's model and init, and the port's model with the same
    weights carried across."""
    jcfg, tcfg = _smoke(arch, **kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    flat = lm_params_from_reference(tm.layout, tree)
    return jm, tm, tree, tm.layout.unflatten(flat)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_model_config_fields_equal():
    fr = [(f.name, f.default) for f in dataclasses.fields(JModelConfig)]
    fp = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert fr == fp


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copies_equal(arch):
    for fn in (lambda c: c, jconfigs.smoke_variant):
        j = fn(jconfigs.get_config(arch))
        t = (tconfigs.smoke_variant(tconfigs.get_config(arch))
             if fn is jconfigs.smoke_variant else tconfigs.get_config(arch))
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("padded_vocab", "d_inner", "n_ssm_heads",
                     "is_attention_free", "is_encdec"):
            assert getattr(j, prop) == getattr(t, prop)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
        np.testing.assert_array_equal(jwindows(j), layer_windows(t))
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(1, 0.1, (16,)).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5),
           jlayers.rmsnorm({"scale": scale}, x, 1e-5), 1e-6)
    pos = np.broadcast_to(np.arange(7, 12)[None], (2, 5)).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), 1e4),
           jlayers.apply_rope(x, pos, 1e4), 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_activations(act):
    cfg = JModelConfig(d_model=32, d_ff=48, activation=act, use_bias=True)
    p = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.key(1), cfg))
    x = np.random.default_rng(1).normal(0, 1, (3, 4, 32)).astype(np.float32)
    tcfg = ModelConfig(d_model=32, d_ff=48, activation=act, use_bias=True)
    _close(tlayers.mlp(_tree_t(p), _t(x), tcfg), jlayers.mlp(p, x, cfg),
           1e-5)


def test_softmax_xent():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = rng.random((3, 5)) > 0.3
    for m in (None, mask):
        want = jlayers.softmax_xent(logits, labels, m)
        got = tlayers.softmax_xent(_t(logits), _t(labels),
                                   None if m is None else _t(m))
        _close(got, want, 1e-6)


def test_linear_reads_lora_adapters():
    rng = np.random.default_rng(3)
    p = {"w": rng.normal(0, 1, (8, 6)), "b": rng.normal(0, 1, (6,)),
         "lora_A": rng.normal(0, 1, (8, 2)), "lora_B": rng.normal(0, 1, (2, 6)),
         "lora_scale": np.float32(0.5)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (4, 8)).astype(np.float32)
    _close(tlayers.linear(_tree_t(p), _t(x)), jlayers.linear(p, x), 1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CFG = dict(name="t", d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                vocab_size=10, rope_theta=1e4)


@pytest.mark.parametrize("window", [0, 32])
def test_attention_module_without_cache(window):
    """The prefill form (the flash kernel's plain version on the CPU)
    against the reference's jnp module; tolerance 2e-4, the reference's own
    module-vs-kernel tolerance (tests/test_model_consistency.py)."""
    jcfg, tcfg = JModelConfig(**ATTN_CFG), ModelConfig(**ATTN_CFG)
    p = jax.tree.map(np.asarray, init_attention(jax.random.key(0), jcfg))
    b, s = 2, 96
    x = np.random.default_rng(4).normal(0, 1, (b, s, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    want, _ = jattention(p, x, jcfg, positions=pos, window=window)
    got = tattention(_tree_t(p), _t(x), tcfg, positions=_t(pos).long(),
                     window=window)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("window", [0, 32])
def test_attention_module_with_cache(window):
    """Prefill into a deeper cache at cache_pos 0, then two decode steps:
    outputs and the cache rows against the reference."""
    jcfg, tcfg = JModelConfig(**ATTN_CFG), ModelConfig(**ATTN_CFG)
    p = jax.tree.map(np.asarray, init_attention(jax.random.key(5), jcfg))
    tp = _tree_t(p)
    b, s, t = 2, 40, 48
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (b, s + 2, 128)).astype(np.float32)
    jc = make_cache(jcfg, b, t, jnp.float32)
    tc = {"k": torch.zeros(b, t, 2, 32), "v": torch.zeros(b, t, 2, 32)}
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    want, jc = jattention(p, x[:, :s], jcfg, positions=pos, window=window,
                          cache=jc, cache_pos=jnp.int32(0))
    got = tattention(tp, _t(x[:, :s]), tcfg, positions=_t(pos).long(),
                     window=window, cache=tc, cache_pos=0)
    _close(got, want, 2e-4, "prefill")
    for i in (s, s + 1):
        pos1 = np.full((b, 1), i, np.int32)
        want, jc = jattention(p, x[:, i:i + 1], jcfg, positions=pos1,
                              window=window, cache=jc, cache_pos=jnp.int32(i))
        # the engine's form: a per-row position tensor
        got = tattention(tp, _t(x[:, i:i + 1]), tcfg,
                         positions=_t(pos1).long(), window=window, cache=tc,
                         cache_pos=torch.full((b,), i))
        _close(got, want, 2e-4, f"decode at {i}")
    _close(tc["k"], jc["k"], 1e-5, "k cache")
    _close(tc["v"], jc["v"], 1e-5, "v cache")


def test_decode_commit_mask_keeps_other_rows():
    cfg = ModelConfig(**ATTN_CFG)
    p = _tree_t(jax.tree.map(np.asarray,
                             init_attention(jax.random.key(6),
                                            JModelConfig(**ATTN_CFG))))
    b, t = 3, 16
    cache = {"k": torch.randn(b, t, 2, 32), "v": torch.randn(b, t, 2, 32)}
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.randn(b, 1, 128)
    pos = torch.tensor([3, 7, 5])
    commit = torch.tensor([True, False, True])
    tattention(p, x, cfg, positions=pos[:, None], cache=cache, cache_pos=pos,
               commit=commit)
    for key in ("k", "v"):
        assert torch.equal(cache[key][1], before[key][1])
        changed = (cache[key] != before[key]).any(-1).any(-1)
        assert changed[0].tolist() == [i == 3 for i in range(t)]
        assert changed[2].tolist() == [i == 5 for i in range(t)]


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def test_ssd_chunked_twin():
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 64, 4, 16, 8
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(0.1, 0.05, (b, s, h))).astype(np.float32)
    alog = np.log(np.linspace(1, 8, h)).astype(np.float32)
    bm = rng.normal(0, 0.5, (b, s, 2, n)).astype(np.float32)
    cm = rng.normal(0, 0.5, (b, s, 2, n)).astype(np.float32)
    yw, sw = j_ssd_chunked(x, dt, alog, bm, cm, 16)
    yg, sg = t_ssd_chunked(_t(x), _t(dt), _t(alog), _t(bm), _t(cm), 16)
    _close(yg, yw, 1e-5)
    _close(sg, sw, 1e-5)


def test_ssm_block_prefill_with_state_then_decode():
    """Chunked prefill (length not a chunk multiple: padded) returning its
    state, then three O(1) decode steps; tolerance 1e-4, the reference's
    kernel-vs-module tolerance (tests/test_kernels.py)."""
    jcfg, tcfg = _smoke("hymba-1.5b")
    p = jax.tree.map(np.asarray, init_ssm(jax.random.key(8), jcfg))
    tp = _tree_t(p)
    b, s = 2, 21
    x = np.random.default_rng(8).normal(0, 1, (b, s + 3, 256)).astype(
        np.float32)
    jst = make_ssm_state(jcfg, b, jnp.float32)
    tst = {k: _t(v) for k, v in jax.tree.map(np.asarray, jst).items()}
    want, jst = jssm_block(p, x[:, :s], jcfg, state=jst)
    got, tst = tssm_block(tp, _t(x[:, :s]), tcfg, state=tst)
    _close(got, want, 1e-4, "prefill")
    _close(tst["ssd"], jst["ssd"], 1e-4, "state")
    _close(tst["conv"], jst["conv"], 1e-6, "conv prefix")
    for i in range(s, s + 3):
        want, jst = jssm_block(p, x[:, i:i + 1], jcfg, state=jst)
        got, tst = tssm_block(tp, _t(x[:, i:i + 1]), tcfg, state=tst)
        _close(got, want, 1e-4, f"decode {i}")
    _close(tst["ssd"], jst["ssd"], 1e-4, "final state")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_logits(arch):
    jm, tm, tree, params = _models(arch)
    cfg = tm.cfg
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24))
    want, _, _ = jforward(tree, jm.cfg, jnp.asarray(toks, jnp.int32))
    got, _, _ = tforward(nest(params), cfg, _t(toks))
    _close(got, want, 2e-4)
    assert got.shape[-1] == cfg.padded_vocab
    assert bool((got[..., cfg.vocab_size:] < -1e29).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """``model.prefill`` then four ``model.decode`` steps, both packages,
    the same weights and tokens: last-position logits at every step."""
    jm, tm, tree, params = _models(arch, seed=1)
    cfg = tm.cfg
    rng = np.random.default_rng(10)
    b, s, t = 2, 20, 32
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jc = jm.init_cache(b, t)
    tc = tm.init_cache(b, t, "cpu")
    want, jc = jm.prefill(tree, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    got, tc = tm.prefill(params, {"tokens": _t(toks)}, tc)
    _close(got, want, 2e-4, "prefill")
    nxt = rng.integers(0, cfg.vocab_size, (b, 4))
    for i in range(4):
        want, jc = jm.decode(tree, jnp.asarray(nxt[:, i:i + 1], jnp.int32), jc,
                             jnp.int32(s + i))
        got, tc = tm.decode(params, _t(nxt[:, i:i + 1]), tc, s + i)
        _close(got, want, 2e-4, f"decode {i}")


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_decode_matches_forward(arch):
    """The reference's property (tests/test_smoke_archs.py) on the port:
    step-by-step decode == teacher-forced forward, same tolerance."""
    _, tm, _, params = _models(arch, seed=2, ssm_chunk=8)
    cfg = tm.cfg
    s = 16
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, s)))
    full, _, _ = tforward(nest(params), cfg, toks)
    caches = tm.init_cache(1, s, "cpu")
    outs = []
    for i in range(s):
        lg, caches = tm.decode(params, toks[:, i:i + 1], caches, i)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.detach().numpy(), 2e-2)


def test_cpu_forward_counts_no_launch():
    _, tm, _, params = _models("hymba-1.5b")
    before = dict(LAUNCHES)
    tm.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
               tm.init_cache(1, 8, "cpu"))
    assert LAUNCHES == before


def test_convert_round_trip():
    jm, tm, tree, _ = _models("hymba-1.5b", seed=3)
    flat = lm_params_from_reference(tm.layout, tree)
    back = lm_params_to_reference(tm.layout, flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # bf16: a JAX bf16 tree arrives as ml_dtypes arrays; bits are kept
    tree16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          tree)
    flat16 = lm_params_from_reference(tm.layout, tree16)
    assert flat16.dtype == torch.bfloat16
    assert torch.equal(flat16.float(),
                       lm_params_from_reference(tm.layout, tree16,
                                                dtype=torch.float32))
    np.testing.assert_array_equal(
        flat16.float().numpy(),
        np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in
                        [_get(tree16, leaf.path) for leaf in tm.layout.leaves]]))
    # a stacked ensemble [N, ...] carries across with lead=1
    stacked = jax.tree.map(lambda a: np.stack([a, a * 2]), tree)
    flat2 = lm_params_from_reference(tm.layout, stacked, lead=1)
    assert torch.equal(flat2[0], flat) and torch.equal(flat2[1], flat * 2)


def _get(tree, path):
    for part in path.split("."):
        tree = tree[part]
    return tree


def test_flat_layout_wide_leaves():
    """Wide leaves: f32 values over two slots of a bf16 buffer, at even
    offsets, the buffer padded to even; views write through; a stacked
    ``[N, P]`` buffer's rows stay aligned."""
    from repro_torch.core.flat import FlatLayout
    layout = FlatLayout([("a", (3,)), ("w", (5,)), ("z", (2, 1))],
                        wide={"w"})
    assert layout.size == 3 + 10 + 2 + 1
    assert [lf.offset for lf in layout.leaves] == [10, 0, 13]
    vals = {"a": torch.tensor([1.0, 2.0, 3.0]),
            "w": torch.linspace(0.1, 0.5, 5) + 1e-4,
            "z": torch.tensor([[4.0], [5.0]])}
    flat = layout.flatten(vals, torch.bfloat16)
    assert flat.dtype == torch.bfloat16 and flat.shape == (layout.size,)
    stacked = torch.stack([flat, flat])
    for row in (flat, stacked[1]):
        views = layout.unflatten(row)
        assert list(views) == ["a", "w", "z"]
        assert views["w"].dtype == torch.float32
        assert torch.equal(views["w"], vals["w"])
        assert torch.equal(views["a"].float(), vals["a"])
    layout.unflatten(stacked)["w"][1].fill_(7.0)
    assert bool((layout.unflatten(stacked[1])["w"] == 7.0).all())
    assert torch.equal(layout.unflatten(stacked[0])["w"], vals["w"])
    with pytest.raises(ValueError, match="16-bit"):
        layout.unflatten(torch.zeros(layout.size))
    with pytest.raises(ValueError, match="16-bit"):
        layout.flatten(vals, torch.float32)


BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_bf16_model_keeps_f32_leaves(arch):
    """In a bf16 model the SSM's A_log, D and dt_bias stay f32, as the
    reference keeps them: carried across bit for bit, back again exactly,
    and ``Model.init`` writes the reference's f32 constants."""
    jm, tm, tree, params = _models(arch, **BF16)
    wide = {"layers.ssm.A_log", "layers.ssm.D", "layers.ssm.dt_bias"}
    assert tm.layout.wide == wide
    for leaf in tm.layout.leaves:
        want = np.asarray(_get(tree, leaf.path))
        got = params[leaf.path]
        if leaf.path in wide:
            assert want.dtype == np.float32 and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
    back = lm_params_to_reference(tm.layout, tm.layout.flatten(
        params, torch.bfloat16))
    for path in wide:
        np.testing.assert_array_equal(_get(back, path), _get(tree, path))
    buf = torch.full((tm.layout.size,), float("nan"), dtype=torch.bfloat16)
    tm.init(torch.Generator().manual_seed(0), "cpu", out=buf)
    a_log = tm.layout.unflatten(buf)["layers.ssm.A_log"]
    assert a_log.dtype == torch.float32
    assert torch.equal(a_log[0], torch.log(torch.linspace(
        1.0, 16.0, tm.cfg.n_ssm_heads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_lm_logits(arch):
    """The bf16 smoke models against the reference's bf16 models, same
    weights: the packages round at different points (the reference casts
    probs to bf16 before P·V and forms x·dt in bf16; the port's kernels and
    their plain versions work in f32), so logits agree within a tenth of
    their spread, and the argmax nearly everywhere."""
    jm, tm, tree, params = _models(arch, **BF16)
    cfg = tm.cfg
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24))
    want, _, _ = jforward(tree, jm.cfg, jnp.asarray(toks, jnp.int32))
    got, _, _ = tforward(nest(params), cfg, _t(toks))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)[..., :cfg.vocab_size]
    got = got.float().numpy()[..., :cfg.vocab_size]
    assert np.abs(got - want).max() <= 0.1 * want.std()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

FLASH_SWEEP = [  # tests/test_kernels.py's sweep
    (1, 4, 4, 128, 64, True, 0), (2, 4, 2, 256, 64, True, 0),
    (1, 8, 2, 256, 64, True, 64), (1, 4, 1, 128, 128, True, 0),
    (2, 2, 2, 128, 64, False, 0)]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", FLASH_SWEEP)
def test_flash_plain_matches_pallas(b, h, hkv, s, d, causal, window):
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(12)
    q = rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    want = jflash(q, k, v, causal=causal, window=window, bq=64, bk=64,
                  interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    _close(got, want, 2e-5)


def test_flash_plain_matches_pallas_bf16():
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(0, 1, (1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  bq=64, bk=64, interpret=True)
    got = flash_attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)


def test_flash_window_without_causal_raises():
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=False, window=4)


SSD_SWEEP = [(1, 64, 2, 32, 16, 16), (2, 128, 3, 32, 16, 32),
             (1, 256, 4, 64, 128, 64), (2, 96, 2, 32, 8, 32)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SWEEP)
def test_ssd_plain_matches_pallas(b, s, h, p, n, chunk):
    from repro.kernels.ssd_scan import ssd_scan as jssd
    from repro_torch.kernels.ssd_scan import ssd_scan
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(0.1, 0.05, (b, s, h))).astype(np.float32)
    alog = np.log(np.linspace(1, 8, h)).astype(np.float32)
    bm = rng.normal(0, 0.5, (b, s, h, n)).astype(np.float32)
    cm = rng.normal(0, 0.5, (b, s, h, n)).astype(np.float32)
    yw, sw = jssd(x, dt, alog, bm, cm, chunk=chunk, interpret=True)
    yg, sg = ssd_scan(_t(x), _t(dt), _t(alog), _t(bm), _t(cm), chunk=chunk)
    _close(yg, yw, 1e-4)
    _close(sg, sw, 1e-4)


def test_ssd_plain_matches_model_module():
    """The reference's kernel-vs-module property on the port: the plain SSD
    scan with B/C per group == the port's ``ssd_chunked`` twin (and the
    reference's), 1e-4."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    rng = np.random.default_rng(15)
    b, s, h, p, n = 1, 128, 2, 32, 16
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(0.1, 0.05, (b, s, h))).astype(np.float32)
    alog = np.log(np.linspace(1, 4, h)).astype(np.float32)
    bm = rng.normal(0, 0.5, (b, s, 1, n)).astype(np.float32)
    cm = rng.normal(0, 0.5, (b, s, 1, n)).astype(np.float32)
    ym, sm = j_ssd_chunked(x, dt, alog, bm, cm, 32)
    yk, sk = ssd_scan(_t(x), _t(dt), _t(alog), _t(bm), _t(cm), chunk=32)
    _close(yk, ym, 1e-4)
    _close(sk, sm, 1e-4)


def test_fused_merge_plain_matches_reference():
    from repro.kernels import ref as jref
    from repro.kernels.fused_merge import fused_merge as jmerge
    from repro_torch.kernels.fused_merge import fused_merge
    rng = np.random.default_rng(16)
    x = rng.normal(0, 1, (4, 1000)).astype(np.float32)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    for gate in (True, False):
        want = jref.fused_merge_ref(x, w, 2, gate)
        got = fused_merge(_t(x), _t(w), 2, gate)
        _close(got, want, 1e-6)
        _close(got, jmerge(x, w, 2, gate, interpret=True), 1e-6)
    assert torch.equal(fused_merge(_t(x), _t(w), 2, False), _t(x)[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_fills_every_leaf(arch):
    """``Model.init`` writes every value of the buffer it is given, with
    the reference's constants where the reference has them."""
    tm = build_model(tconfigs.smoke_variant(tconfigs.get_config(arch)))
    buf = torch.full((tm.layout.size,), float("nan"))
    tm.init(torch.Generator().manual_seed(0), "cpu", out=buf)
    assert bool(torch.isfinite(buf).all())
    p = nest(tm.layout.unflatten(buf))
    assert bool((p["final_norm"]["scale"] == 1).all())
    if "ssm" in p["layers"]:
        np.testing.assert_allclose(p["layers"]["ssm"]["A_log"][0].numpy(),
                                   np.log(np.linspace(1, 16, tm.cfg.n_ssm_heads)),
                                   rtol=1e-6)
