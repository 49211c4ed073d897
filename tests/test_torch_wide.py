"""The three dense configs that the card serves at full width
(nemotron-4-15b, deepseek-coder-33b, minicpm-2b) against the reference, at
smoke widths on the CPU: nemotron's and deepseek's smoke variants at their
real head dim (128) and GQA groups (6 and 7 query heads over one KV head),
so that the port's flash path sees the D = 128 shapes it sees on the card.
The weights are the reference's, carried across with
`repro_torch.convert.lm_params_from_reference`.

- whole-model logits, then a prefill and 4 decode steps, within 2e-4 (f32);
- flash's plain version (what the wrapper computes for a CPU tensor) at
  the served form, K/V strided views of a ``[B, T, Hkv, 128]`` cache whose
  depth is not a multiple of the 64-key tile, against the Pallas kernel in
  interpret mode;
- ``ServeEngine`` at N = 1 on nemotron's smoke variant against the
  reference engine's token streams;
- ``generate`` handed the step buffers' own params: no copy into them, the
  same tokens as handed a copy and as the reference's ``generate``;
- ``layers.normal_`` bit-identical to the ``randn(...) * scale`` form it
  replaced.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_wide.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.transformer import forward_lm as jforward  # noqa: E402
from repro.serve import BucketPolicy as JBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch.serve import generate, step_buffers  # noqa: E402
from repro_torch.models import build_model, nest  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.transformer import forward_lm as tforward  # noqa: E402
from repro_torch.serve import BucketPolicy, ServeEngine  # noqa: E402

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

CPU = torch.device("cpu")
# the smoke variants at the full-width configs' head dim and GQA group
D128 = {"nemotron-4-15b": dict(head_dim=128, n_heads=6, n_kv_heads=1),
        "deepseek-coder-33b": dict(head_dim=128, n_heads=7, n_kv_heads=1)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _models(arch, seed=0, lead=None, **kw):
    """Both packages' models of ``arch``'s D = 128 smoke variant, the
    reference's init (``lead`` nodes stacked when given) and the same
    weights as the port's flat vector."""
    upd = dict(D128[arch], **kw)
    jm = jbuild(jconfigs.smoke_variant(jconfigs.get_config(arch))
                .replace(**upd))
    tm = build_model(tconfigs.smoke_variant(tconfigs.get_config(arch))
                     .replace(**upd))
    key = jax.random.key(seed)
    if lead is None:
        tree = jax.tree.map(np.asarray, jm.init(key))
        return jm, tm, tree, lm_params_from_reference(tm.layout, tree)
    tree = jax.tree.map(np.asarray, jax.vmap(jm.init)(
        jax.random.split(key, lead)))
    return jm, tm, tree, lm_params_from_reference(tm.layout, tree, lead=1)


@pytest.mark.parametrize("arch", sorted(D128))
def test_smoke_d128_configs_keep_the_full_width_attention(arch):
    full = tconfigs.get_config(arch)
    _, tm, _, _ = _models(arch)
    assert tm.cfg.head_dim == full.head_dim == 128
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == \
        full.n_heads // full.n_kv_heads
    assert tm.cfg.activation == full.activation


@pytest.mark.parametrize("arch", sorted(D128))
def test_forward_lm_logits_d128(arch):
    jm, tm, tree, flat = _models(arch)
    toks = np.random.default_rng(9).integers(0, tm.cfg.vocab_size, (2, 24))
    want, _, _ = jforward(tree, jm.cfg, jnp.asarray(toks, jnp.int32))
    got, _, _ = tforward(nest(tm.layout.unflatten(flat)), tm.cfg, _t(toks))
    _close(got, want, 2e-4)


@pytest.mark.parametrize("arch", sorted(D128))
def test_prefill_and_decode_d128_match_reference(arch):
    """``model.prefill`` (the flash form: a cache written at 0, K/V its
    strided views over the whole depth) then four ``model.decode`` steps,
    both packages, the same weights and tokens."""
    jm, tm, tree, flat = _models(arch, seed=1)
    params = tm.layout.unflatten(flat)
    rng = np.random.default_rng(10)
    b, s, t = 2, 20, 36
    toks = rng.integers(0, tm.cfg.vocab_size, (b, s))
    jc, tc = jm.init_cache(b, t), tm.init_cache(b, t, CPU)
    want, jc = jm.prefill(tree, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    got, tc = tm.prefill(params, {"tokens": _t(toks)}, tc)
    _close(got, want, 2e-4, "prefill")
    nxt = rng.integers(0, tm.cfg.vocab_size, (b, 4))
    for i in range(4):
        want, jc = jm.decode(tree, jnp.asarray(nxt[:, i:i + 1], jnp.int32),
                             jc, jnp.int32(s + i))
        got, tc = tm.decode(params, _t(nxt[:, i:i + 1]), tc, s + i)
        _close(got, want, 2e-4, f"decode {i}")


@pytest.mark.parametrize("group", [6, 7])
def test_flash_served_form_d128_matches_pallas(group):
    """The served prefill's flash call at D = 128 and a GQA group of 6 or 7:
    q [1, 2·group, S, 128] over two KV heads whose K/V are ``[B, T, 2,
    128]`` cache views (T = 72, a 64-key tile and 8 more), against the
    Pallas kernel in interpret mode."""
    from repro.kernels.flash_attention import flash_attention as jflash
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(14 + group)
    s, t, d, hkv = 40, 72, 128, 2
    q = rng.normal(0, 1, (1, group * hkv, s, d)).astype(np.float32)
    cache_k, cache_v = (rng.normal(0, 1, (1, t, hkv, d)).astype(np.float32)
                        for _ in range(2))
    k, v = (_t(c).transpose(1, 2) for c in (cache_k, cache_v))
    assert not k.is_contiguous()
    want = jflash(q, np.swapaxes(cache_k, 1, 2), np.swapaxes(cache_v, 1, 2),
                  bq=8, bk=8, interpret=True)
    got = flash_attention(_t(q), k, v)
    _close(got, want, 2e-5)


def _streams(eng, prompts, max_new, stagger):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts[:stagger]]
    eng.step()
    reqs += [eng.submit(p, max_new=max_new) for p in prompts[stagger:]]
    eng.drain()
    return [[np.asarray(v).tolist() for v in r.node_tokens] for r in reqs]


def test_engine_n1_streams_equal_jax_engine():
    """Nemotron's smoke variant behind ``ServeEngine`` as one node in
    consensus mode, under continuous batching with staggered admission:
    the token streams equal the reference engine's."""
    jm, tm, tree, flat = _models("nemotron-4-15b", lead=1, vocab_size=64)
    assert flat.shape[0] == 1
    prompts = [np.arange(1, 1 + n) % 64 for n in (5, 9, 3, 7)]
    policy = dict(batch_buckets=(1, 2, 4), seq_buckets=(8, 16))
    jeng = JServeEngine(jm, tree, mode="consensus", max_len=32, max_slots=4,
                        policy=JBucketPolicy(**policy))
    teng = ServeEngine(tm, flat, mode="consensus", max_len=32, max_slots=4,
                       policy=BucketPolicy(**policy), device="cpu")
    got = _streams(teng, prompts, 5, 2)
    assert got == _streams(jeng, prompts, 5, 2)
    assert all(len(r) == 5 for r in got)


def test_generate_serves_the_step_buffers_own_params():
    """deepseek's smoke variant initialised into the step buffers' params
    (as the card path does) and generated from them: nothing is written
    into that buffer, the tokens equal those of a call handed a copy and
    the reference's."""
    jm, tm, tree, flat = _models("deepseek-coder-33b", seed=4,
                                 vocab_size=64)
    b, s, new, max_len = 2, 12, 6, 32
    prompt = np.random.default_rng(15).integers(0, 64, (b, s))
    st = step_buffers(tm, b, max_len, CPU)
    st.params.copy_(flat)
    ptr, version = st.params.data_ptr(), st.params._version
    own = generate(tm, st.params, prompt, new, max_len, device="cpu")
    assert st.params._version == version        # no in-place write
    assert step_buffers(tm, b, max_len, CPU).params is st.params
    assert st.params.data_ptr() == ptr
    copied = generate(tm, flat.clone(), prompt, new, max_len, device="cpu")
    assert st.params._version == version + 1    # this one was copied in
    assert torch.equal(own, copied)
    want = np.asarray(jgenerate(jm, tree, jnp.asarray(prompt, jnp.int32),
                                new, max_len))
    assert own.numpy().tolist() == want.tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normal_bit_identical_to_scaled_draw(dtype):
    dt = getattr(torch, dtype)
    got = tlayers.normal_(torch.empty(5, 333, dtype=dt),
                          torch.Generator().manual_seed(6), 0.02)
    want = torch.empty(5, 333, dtype=dt).copy_(
        torch.randn((5, 333), generator=torch.Generator().manual_seed(6))
        * 0.02)
    assert torch.equal(got, want)
