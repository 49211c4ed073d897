"""Serving under tensor parallelism: a node's prefill, decode step and
``generate`` over its model group (`repro_torch.launch.serve` with a mesh
of ``model`` = M > 1), the decode cache on the reference's placement
(`repro_torch.sharding.rules.cache_cut`: K/V on the KV heads, else on the
head dim; the SSM state on its heads; an enc-dec's encoder output whole),
the residual whole where M does not divide the sequence
(`repro_torch.sharding.tensor.TensorPlan.for_sequence`).

Worlds of `tests/torch_gossip_world.py`, gloo on the CPU: ``tp_serve_m2``
(node, data, model) = (1, 1, 2) serves each M = 2 case of
``TP_SERVE`` (a head-parallel dense model, a dense model whose one KV
head does not divide M, the moe with its experts cut and whole, the ssm,
the hybrid, a dense model with an odd unpadded vocab, the ssm whose heads
read their groups unevenly, the enc-dec head-parallel and with one KV
head), ``tp_serve_m4`` (1, 1, 4) the hybrid whose 2 SSM heads stay whole
at M = 4. The smoke models in f32, from the JAX package's own init
(seeded), carried across by `repro_torch.convert`.

Held: each rank's token stream equal to the JAX package's ``generate``
and to the port's unsharded ``generate``, for a prompt M divides and one
it does not (an enc-dec's prompt fed token by token against a zero
encoder output, as the reference's ``generate`` feeds it); the prefill's
and every decode step's logits within 2e-4 of the reference's (the JAX
model's ``prefill`` and ``decode``); an enc-dec's frames encoded over the
group and its prompt fed after them against the reference's ``encode``
and ``decode_step``; a rank's caches of the cut shapes and its params its
compute blocks only; the bytes by kind of a prefill (an enc-dec's
encode) and of a decode step equal to the count from the config
(`chip_smoke._tp_serve_bytes`); the model group's step programs eager
(gloo) and counted, a single-process program's pool not; a forward that
records a gradient on a sequence the group does not divide takes the
whole residual, and its gradient's shares sum to the unsharded one's.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_gossip_world as W
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.launch.serve import generate as jgenerate
from repro.models import build_model as jbuild
from repro.models.encdec import encode as jencode
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model
from repro_torch.sharding.rules import (cache_cut, compute_blocks,
                                        placement)

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300
LOGIT_TOL = 2e-4
CASES = [c[0] for c in W.TP_SERVE]


def _case(case):
    return next(c for c in W.TP_SERVE if c[0] == case)


def _reference(jm, tree, prompt, new, max_len, enc_out=None):
    """The JAX package's logits for the prefill of ``prompt`` and each
    greedy decode step after it [B, new, V]; an enc-dec's prompt fed token
    by token (its every step's logits [B, S + new - 1, V]) against the
    zero encoder output, or ``enc_out``."""
    decode = jax.jit(jm.decode)
    caches = jm.init_cache(prompt.shape[0], max_len)
    if jm.prefill is None:
        if enc_out is not None:
            caches = dict(caches, enc_out=enc_out)
        seen = []
        for i in range(prompt.shape[1]):
            logits, caches = decode(tree, prompt[:, i:i + 1], caches,
                                    jnp.int32(i))
            seen.append(logits[:, -1])
    else:
        logits, caches = jax.jit(jm.prefill)(tree, {"tokens": prompt},
                                             caches)
        seen = [logits[:, -1]]
    for i in range(new - 1):
        tok = jnp.argmax(seen[-1], axis=-1)[:, None].astype(jnp.int32)
        logits, caches = decode(tree, tok, caches,
                                jnp.int32(prompt.shape[1] + i))
        seen.append(logits[:, -1])
    return np.asarray(jnp.stack(seen, axis=1))


def _greedy(logits, s, new):
    """The greedy stream [B, new] of a token-fed run's logits: the pick
    after the prompt's last token and after each new one."""
    return np.argmax(logits[:, s - 1:s - 1 + new], axis=-1).astype(np.int32)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds' ranks' outputs, and the JAX package's streams and
    logits, computed while the worlds run."""
    d = tmp_path_factory.mktemp("tp_serve")
    rng = np.random.default_rng(31)
    inputs, jax_side = {}, {}
    for k, (case, arch, changes, m) in enumerate(W.TP_SERVE):
        jcfg = jsmoke(jget_config(arch)).replace(**changes)
        jm = jbuild(jcfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.key(k)))
        layout = build_model(W.tp_serve_cfg(arch, changes)).layout
        inputs[f"serve/{case}/flat"] = lm_params_from_reference(
            layout, tree).numpy()
        for s in W.tp_serve_prompts(m):
            inputs[f"serve/{case}/prompt{s}"] = rng.integers(
                0, jcfg.vocab_size, (W.TP_SERVE_B, s)).astype(np.int64)
        if jcfg.is_encdec:
            inputs[f"serve/{case}/frames"] = rng.normal(0, 1, (
                W.TP_SERVE_B, jcfg.enc_seq_len, jcfg.frontend_dim)).astype(
                    np.float32)
        jax_side[case] = (jm, tree)
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    procs = [subprocess.Popen(
        [sys.executable, script, task, str(r), str(n),
         f"file://{d}/rdv_{task}", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for task, n in W.TP_SERVE_WORLDS.items() for r in range(n)]
    try:
        want = {}
        for case, arch, changes, m in W.TP_SERVE:
            jm, tree = jax_side[case]
            enc_out = None
            if jm.cfg.is_encdec:
                enc_out = jax.jit(lambda t, f: jencode(t, jm.cfg, f))(
                    tree, jnp.asarray(inputs[f"serve/{case}/frames"]))
            for s in W.tp_serve_prompts(m):
                prompt = jnp.asarray(inputs[f"serve/{case}/prompt{s}"],
                                     jnp.int32)
                want[(case, s)] = (
                    np.asarray(jgenerate(jm, tree, prompt, W.TP_SERVE_NEW,
                                         W.TP_SERVE_LEN)),
                    _reference(jm, tree, prompt, W.TP_SERVE_NEW,
                               W.TP_SERVE_LEN))
                if enc_out is not None:
                    want[(case, s, "encoded")] = _reference(
                        jm, tree, prompt, W.TP_SERVE_NEW, W.TP_SERVE_LEN,
                        enc_out)
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = {m: [dict(np.load(d / f"{task}_rank{r}.npz")) for r in range(m)]
           for task, m in W.TP_SERVE_WORLDS.items()}
    return out, want


def _ranks(worlds, case):
    return worlds[0][_case(case)[3]]


@pytest.mark.parametrize("case", CASES)
def test_streams_equal_the_reference_generate_and_the_unsharded(worlds,
                                                                 case):
    """Every rank's greedy stream over the model group equals the JAX
    package's ``generate`` and the port's unsharded ``generate``, for a
    prompt M divides (the residual cut on it) and one it does not (the
    residual whole)."""
    _, arch, _, m = _case(case)
    for s in W.tp_serve_prompts(m):
        want = worlds[1][(case, s)][0]
        for rank in _ranks(worlds, case):
            np.testing.assert_array_equal(rank[f"serve/{case}/{s}/tokens"],
                                          want, err_msg=f"{case} S={s}")
            np.testing.assert_array_equal(
                rank[f"serve/{case}/{s}/single_tokens"], want)


@pytest.mark.parametrize("case", CASES)
def test_logits_within_2e4_of_the_reference(worlds, case):
    """The prefill's logits and every decode step's, all_gathered over
    the vocab cut on every rank, within 2e-4 of the JAX package's (the
    vocab's padding columns left out), for both prompts."""
    _, arch, changes, m = _case(case)
    v = W.tp_serve_cfg(arch, changes).vocab_size
    for s in W.tp_serve_prompts(m):
        want = worlds[1][(case, s)][1][:, -W.TP_SERVE_NEW:, :v]
        for rank in _ranks(worlds, case):
            got = rank[f"serve/{case}/{s}/logits"][..., :v]
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"{case} S={s}")


ENCODED = [c[0] for c in W.TP_SERVE
           if W.tp_serve_cfg(c[1], c[2]).is_encdec]


@pytest.mark.parametrize("case", ENCODED)
def test_encdec_encoded_over_the_group_matches_the_reference(worlds, case):
    """An enc-dec's frames encoded over the model group (the encode step:
    the residual cut where M divides the frames, whole where not), its
    prompt fed token by token after them: every step's logits within
    2e-4 of the reference's ``encode`` then ``decode_step`` on the same
    frames, the stream equal to theirs and to the unsharded encode's."""
    _, arch, changes, m = _case(case)
    v = W.tp_serve_cfg(arch, changes).vocab_size
    for s in W.tp_serve_prompts(m):
        want = worlds[1][(case, s, "encoded")]
        for rank in _ranks(worlds, case):
            key = f"serve/{case}/{s}"
            np.testing.assert_allclose(rank[f"{key}/encoded_logits"][..., :v],
                                       want[..., :v], rtol=0, atol=LOGIT_TOL,
                                       err_msg=f"{case} S={s}")
            np.testing.assert_array_equal(
                rank[f"{key}/encoded_tokens"],
                _greedy(want[..., :v], s, W.TP_SERVE_NEW))
            np.testing.assert_array_equal(
                rank[f"{key}/encoded_tokens"],
                rank[f"{key}/single_encoded_tokens"])


@pytest.mark.parametrize("case", CASES)
def test_cache_has_the_references_cut(worlds, case):
    """A rank's decode state: K/V [B, T, nkv/M, hd] where the KV heads
    divide M, else [B, T, nkv, hd/M]; under an SSM heads cut the SSD state
    [B, H/M, P, N] and the conv tail on the rank's channels (its heads' x
    columns and the one B/C group they read), else both whole (the heads
    that read their groups unevenly too); an enc-dec's self K/V cut so and
    its encoder output whole [B, enc_seq_len, D] (the reference's
    ``cache_specs``)."""
    _, arch, changes, m = _case(case)
    cfg = W.tp_serve_cfg(arch, changes)
    b, t = W.TP_SERVE_B, W.TP_SERVE_LEN
    want = {}
    if cfg.family != "ssm":
        nkv, hd = cfg.n_kv_heads, cfg.head_dim
        kv = ([b, t, nkv // m, hd] if nkv % m == 0
              else [b, t, nkv, hd // m])
        want.update(k=kv, v=kv)
    if cfg.family in ("ssm", "hybrid"):
        h, n, di = cfg.n_ssm_heads, cfg.ssm_state, cfg.d_inner
        g = cfg.ssm_groups
        cut = m if h % m == 0 and g == 1 else 1
        want["ssd"] = [b, h // cut, di // h, n]
        want["conv"] = [b, cfg.conv_width - 1, di // cut + 2 * g * n]
    for rank in _ranks(worlds, case):
        caches = json.loads(str(rank[f"serve/{case}/cache"]))
        assert len(caches) == cfg.n_layers
        for c in caches:
            assert c == want, (case, c, want)
        if cfg.is_encdec:
            assert rank[f"serve/{case}/enc_out"].tolist() == [
                b, cfg.enc_seq_len, cfg.d_model]


@pytest.mark.parametrize("case", CASES)
def test_rank_holds_its_compute_blocks_only(worlds, case):
    """A rank's resident params are its compute block of every leaf
    (`compute_blocks`), fewer values than the node's, the cut leaves
    narrower than the whole."""
    _, arch, changes, m = _case(case)
    cfg = W.tp_serve_cfg(arch, changes)
    layout = build_model(cfg).layout
    place = placement(cfg, m)
    for r, rank in enumerate(_ranks(worlds, case)):
        model_rank = int(rank["model_rank"])
        blocks = compute_blocks(layout, cfg, place, model_rank)
        shapes = json.loads(str(rank[f"serve/{case}/leaves"]))
        want = {p: [sum(n for _, n in iv) for iv in ivs]
                for p, ivs in blocks.items()}
        assert shapes == want
        total = sum(int(np.prod(sh)) for sh in want.values())
        assert int(rank[f"serve/{case}/params"]) == total   # f32: no pad
        assert total < layout.n_values
        head = "embed_tied.table" if cfg.tie_embeddings else "lm_head.w"
        # the head cut on the vocab where M divides it, else whole
        assert int(np.prod(shapes[head])) * (m if place.vocab else 1) == \
            int(np.prod(next(lf.shape for lf in layout.leaves
                             if lf.path == head)))


@pytest.mark.parametrize("case", CASES)
def test_bytes_by_kind_equal_the_layout_count(worlds, case):
    """A prefill's (an enc-dec's encode of its frames) and a decode step's
    bytes by kind on every rank equal `chip_smoke._tp_serve_bytes` from
    the config: the residual cut on a prompt M divides, whole on the other
    and on a decode step."""
    _, arch, changes, m = _case(case)
    cfg = W.tp_serve_cfg(arch, changes)
    b, t = W.TP_SERVE_B, W.TP_SERVE_LEN
    for s in W.tp_serve_prompts(m):
        want = (W.tp_serve_bytes(cfg, m, b, cfg.enc_seq_len, t, encode=True)
                if cfg.is_encdec else W.tp_serve_bytes(cfg, m, b, s, t))
        for rank in _ranks(worlds, case):
            got = json.loads(str(rank[f"serve/{case}/{s}/bytes_prefill"]))
            assert got == want, (case, s)
            got = json.loads(str(rank[f"serve/{case}/{s}/bytes_token"]))
            assert got == W.tp_serve_bytes(cfg, m, b, 1, t), (case, s)


@pytest.mark.parametrize("case", CASES)
def test_model_group_programs_are_eager_and_counted(worlds, case):
    """The model group's step programs sit in an eager pool (gloo) and
    count every run, one prefill and ``new - 1`` decode steps a
    ``generate`` (an enc-dec's: no prefill, ``S + new - 1`` decode steps,
    its encode program run only alone); the single-process programs' pool
    is not eager and nothing is captured on the CPU."""
    _, arch, changes, m = _case(case)
    encdec = W.tp_serve_cfg(arch, changes).is_encdec
    fed = 0
    for k, s in enumerate(W.tp_serve_prompts(m)):
        fed += (s if encdec else 0) + W.TP_SERVE_NEW - 1
        for rank in _ranks(worlds, case):
            assert rank[f"serve/{case}/{s}/pools"].tolist() == [
                True, False, False, False]
            calls = rank[f"serve/{case}/{s}/eager_calls"].tolist()
            # the decode program is shared by both prompts' generate
            # calls (and the first one's lone counted step)
            assert calls == [k if encdec else 1, fed + k]


@pytest.mark.parametrize("case", CASES)
def test_a_recorded_forward_still_refuses_an_undivided_sequence(worlds,
                                                                case):
    """With a gradient recorded, the forward over the model group on a
    prompt M does not divide (an enc-dec's frames too) takes the whole
    residual at every block's entry instead of refusing it: its cross
    entropy equals the unsharded forward's within 1e-6, and the ranks'
    gradient shares, each summed where its compute block lands, equal the
    unsharded gradient within 1e-5 of each leaf's largest magnitude."""
    _, arch, changes, m = _case(case)
    cfg = W.tp_serve_cfg(arch, changes)
    layout = build_model(cfg).layout
    place = placement(cfg, m)
    ranks = _ranks(worlds, case)
    key = f"serve/{case}/grad"
    for rank in ranks:
        forms = rank[f"{key}/forms"]
        assert forms.size and forms.all(), forms
        np.testing.assert_allclose(rank[f"{key}/loss"],
                                   rank[f"{key}/whole_loss"], rtol=1e-6)
    for lf in layout.leaves:
        want = ranks[0][f"{key}/whole/{lf.path}"]
        total = np.zeros(want.shape, np.float32)
        for rank in ranks:
            ivs = compute_blocks(layout, cfg, place,
                                 int(rank["model_rank"]))[lf.path]
            total[np.ix_(*W.tp_slices(ivs))] += rank[f"{key}/rank/{lf.path}"]
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(total, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=lf.path)


@pytest.mark.parametrize("arch,m,want", [
    ("hymba-1.5b", 2, "head_dim"), ("hymba-1.5b", 4, "head_dim"),
    ("granite-moe-3b-a800m", 2, "kv_heads"),
    ("granite-moe-3b-a800m", 16, "head_dim"),
    ("minicpm-2b", 4, "kv_heads"), ("minicpm-2b", 8, "head_dim"),
    ("nemotron-4-15b", 16, "head_dim"), ("mamba2-370m", 2, "none"),
    ("command-r-plus-104b", 8, "kv_heads"),
    ("command-r-plus-104b", 256, "whole")])
def test_cache_cut_follows_the_references_rule(arch, m, want):
    """The reference's decode rule on the published configs: K/V on
    ``kv_heads`` where they divide M (granite's 8 at 2, command-r's 8 at
    8), else on ``head_dim`` where M divides it (Hymba's 5 KV heads at 2
    and 4, granite's 8 at 16), else whole (head dim 128 at 256); no
    K/V for the ssm."""
    assert cache_cut(get_config(arch), placement(get_config(arch), m)) \
        == want
