"""Tensor parallelism on ``model`` in the split step: each layer's work
divided over a node's model group (`repro_torch.sharding.tensor`, the
placements of `repro_torch.sharding.rules.placement`, the compute blocks
of `repro_torch.core.flat.LayerCut.gather_compute`).

Worlds of `tests/torch_gossip_world.py`, gloo on the CPU:

  * ``tp_units``, (node, data, model) = (1, 1, 2): each collective
    Function against its plain single-rank form, the vocab-parallel
    embedding and cross entropy against the reference's, and every block
    (head- and sequence-parallel attention, the MLP, the MoE with its
    experts cut and whole, the SSM with its heads cut, an enc-dec's
    encoder and decoder blocks in both forms) against the JAX package's
    own functions on the same inputs, and its gradients, leaf by leaf,
    against the port's unsharded block;
  * ``tp_m2`` (1, 1, 2) and ``tp_d2m2`` (1, 2, 2): two split steps of the
    dense, ssm, moe, hybrid and enc-dec smoke models from the JAX
    package's params against `repro.launch.train.make_train_step` on the
    whole batch, the first step's gradient leaf by leaf against the
    unsharded step's, the bytes by kind against the layout's count
    (`chip_smoke._tp_bytes`), what a rank gathers, the split gate's
    metric against the whole node's; the enc-dec's sequence-parallel form
    (one KV head, a padded vocab) against the whole node's step, in its
    four pairs of encoder and decoder forms (odd frames or tokens: the
    whole residual), each against the whole node's step and the JAX
    package's; the ``TP_UNEVEN`` steps (an odd sequence, an odd unpadded
    vocab, SSM heads that read their groups unevenly) against the JAX
    package's step and the whole node's, with their bytes;
  * ``tp_encdec_gate`` (2, 1, 2): an enc-dec smoke session's split gate
    against its whole-node gate.

Held: the collectives within 1e-6; blocks within rtol 1e-5, atol 1e-5 of
the reference (f32); the steps' losses within rtol 1e-5 and params within
rtol 1e-4, atol 1e-4; every leaf's gradient within 1e-4 of its largest
magnitude (a leaf summed twice or not at all would be off by its whole
size); bytes exactly; no gathered block of a model-cut leaf whole; at
most two compute blocks alive with remat; the gate's metric within 1e-5.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gossip_world as W
from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import train as jtrain
from repro.models import build_model as jbuild
from repro.models.attention import attention as jattention
from repro.models.layers import embed as jembed, mlp as jmlp
from repro.models.layers import rmsnorm as jrmsnorm
from repro.models.layers import softmax_xent as jxent
from repro.models.moe import moe as jmoe
from repro.models.ssm import ssm_block as jssm
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.core.flat import ShardLayout
from repro_torch.kernels.ref import attention_ref, flash_attention_plain
from repro_torch.models import build_model, nest
from repro_torch.sharding.rules import (block_spec, compute_cut, param_specs,
                                        placement, ssm_groups_of)

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 420
PARAMS_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
#: a leaf's gradient against the unsharded one, over its largest magnitude
GRAD_REL = 1e-4


def _numpy_tree(jm, rng):
    """The reference model's param tree drawn from ``rng``: linears N(0,
    1/in), the tables N(0, 0.02²), norm scales 1 + N(0, 0.1²), biases
    N(0, 0.1²)."""
    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "scale":
            a = 1.0 + 0.1 * rng.normal(0, 1, shape)
        elif name == "table":
            a = 0.02 * rng.normal(0, 1, shape)
        elif name == "b":
            a = 0.1 * rng.normal(0, 1, shape)
        else:
            a = rng.normal(0, 1, shape) / np.sqrt(shape[-2])
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.key(0)))


def _jax_model(arch, rng, changes=None):
    """The JAX package's smoke ``arch`` (with config ``changes``) from its
    own init (an enc-dec's drawn from ``rng``): (the model, its params,
    the port's layout)."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).replace(
        **(changes or {}))
    jm = jbuild(jcfg)
    layout = build_model(smoke_variant(get_config(arch)).replace(
        **(changes or {}))).layout
    tree = (_numpy_tree(jm, rng) if jcfg.is_encdec
            else jm.init(jax.random.key(0)))
    return jm, tree, layout


def _jax_run(jm, tree, batch, steps):
    """``steps`` steps of `repro.launch.train.make_train_step` (remat off)
    on ``batch`` (arrays ``[steps, ...]``): the losses and the params."""
    opt = jadamw_init(tree)
    step = jax.jit(jtrain.make_train_step(jm, JTrainConfig(
        lr=1e-4, warmup_steps=0, max_steps=10, remat=False)))
    losses = []
    for k in range(steps):
        tree, opt, m = step(tree, opt, {
            key: jnp.asarray(v[k].astype(np.int32) if v.dtype == np.int64
                             else v[k]) for key, v in batch.items()})
        losses.append(float(m["loss"]))
    return {"loss": np.asarray(losses),
            "params": jax.tree.map(np.asarray, tree)}


def _jax_steps(arch, rng):
    """The JAX package's smoke ``arch``: the converted flat params, the
    batches (an enc-dec's frames too) and a thunk running TP_JAX_STEPS
    steps (`_jax_run`)."""
    jm, tree, layout = _jax_model(arch, rng)
    jcfg = jm.cfg
    flat = lm_params_from_reference(layout, jax.tree.map(np.asarray, tree))
    toks = rng.integers(0, jcfg.vocab_size, (
        W.TP_JAX_STEPS, W.TP_JAX_BATCH, W.TP_JAX_SEQ + 1))
    batch = {"tokens": toks[..., :-1].astype(np.int64),
             "labels": toks[..., 1:].astype(np.int64)}
    if jcfg.is_encdec:
        batch["frames"] = rng.normal(0, 1, (
            W.TP_JAX_STEPS, W.TP_JAX_BATCH, jcfg.enc_seq_len,
            jcfg.frontend_dim)).astype(np.float32)
    return (dict(batch, flat=flat.numpy()),
            lambda: _jax_run(jm, tree, batch, W.TP_JAX_STEPS))


def _encdec_pair_batch(b, what):
    """The enc-dec's batch ``b`` with its frames, tokens or both one
    shorter (`W.TP_ENCDEC_PAIRS`)."""
    out = dict(b)
    if what in ("frames", "both"):
        out["frames"] = b["frames"][:, 1:]
    if what in ("tokens", "both"):
        out["tokens"], out["labels"] = b["tokens"][:, 1:], b["labels"][:, 1:]
    return out


def _encdec_pair_runs(inputs):
    """Thunks of the JAX package's step of the enc-dec's sequence-parallel
    form (`W.TP_ENCDEC_SEQ`) from the port's seed-0 init, one a pair of
    `W.TP_ENCDEC_PAIRS`, keyed ``encdec_seq/<pair>``."""
    arch, changes = W.TP_ENCDEC_SEQ
    model = build_model(smoke_variant(get_config(arch)).replace(**changes))
    p0 = model.init(torch.Generator().manual_seed(0), "cpu")
    tree = jax.tree.map(jnp.asarray, lm_params_to_reference(model.layout,
                                                            p0))
    jm = jbuild(jconfigs.smoke_variant(jconfigs.get_config(arch)).replace(
        **changes))
    b = {k: inputs[f"encdec_seq/{k}"] for k in ("tokens", "labels",
                                                "frames")}
    return {f"encdec_seq/{what}": (
        lambda bad=_encdec_pair_batch(b, what): _jax_run(
            jm, tree, {k: v[None] for k, v in bad.items()}, 1))
        for what in W.TP_ENCDEC_PAIRS}


def _spawn(d, task, world, env):
    script = os.path.join(HERE, "torch_gossip_world.py")
    return [subprocess.Popen(
        [sys.executable, script, task, str(r), str(world),
         f"file://{d}/rdv_{task}", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every tensor-parallel world's ranks' outputs, the inputs, and the
    JAX package's steps."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(8)
    inputs, runs = W.tp_inputs(), {}
    for fam, arch in W.TP_ARCHS:
        port, runs[fam] = _jax_steps(arch, rng)
        inputs.update({f"jax/{fam}/{k}": v for k, v in port.items()})
    inputs.update(W.tp_encdec_batch(rng))
    for name, arch, changes, _, _ in W.TP_UNEVEN:
        jm, tree, layout = _jax_model(arch, rng, changes)
        batch = W.tp_uneven_batch(name, rng)
        inputs[f"uneven/{name}/flat"] = lm_params_from_reference(
            layout, jax.tree.map(np.asarray, tree)).numpy()
        inputs.update({f"uneven/{name}/{k}": v for k, v in batch.items()})
        runs[f"uneven/{name}"] = (lambda jm=jm, tree=tree, batch=batch:
                                  _jax_run(jm, tree, {k: v[None] for k, v
                                                      in batch.items()}, 1))
    runs.update(_encdec_pair_runs(inputs))
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    sizes = {"tp_units": int(np.prod(W.TP_UNITS)),
             "tp_encdec_gate": int(np.prod(W.TP_GATE))}
    sizes.update({t: int(np.prod(s)) for t, s in W.TP_WORLDS.items()})
    procs = []
    try:
        for task, n in sizes.items():
            procs += _spawn(d, task, n, env)
        # the JAX package's steps while the worlds run
        want = {key: run() for key, run in runs.items()}
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = {task: [dict(np.load(d / f"{task}_rank{r}.npz"))
                  for r in range(n)] for task, n in sizes.items()}
    out["jax"], out["inputs"] = want, inputs
    return out


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("q_off", [0, 8, 12])
def test_plain_flash_query_offset_matches_the_reference_rows(q_off, window):
    """The plain flash with query positions q_off.. against the matching
    rows of `repro.kernels.ref.attention_ref` on the whole sequence,
    within 1e-6."""
    from repro.kernels.ref import attention_ref as jref
    rng = np.random.default_rng(q_off + 10 * window)
    t, s = 20, 8 if q_off else 20
    qf = rng.normal(0, 1, (2, 4, t, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 2, t, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 2, t, 16)).astype(np.float32)
    want = np.asarray(jref(jnp.asarray(qf), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window))[:, :, q_off:q_off + s]
    q = torch.from_numpy(qf[:, :, q_off:q_off + s])
    got = flash_attention_plain(q, torch.from_numpy(k), torch.from_numpy(v),
                                causal=True, window=window, q_off=q_off)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    same = attention_ref(torch.from_numpy(qf), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), same[:, :, q_off:q_off + s]
                               .numpy(), rtol=0, atol=1e-6)


def test_query_offset_needs_the_causal_mask_and_every_rows_key():
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(1, 2, 10, 16)
    with pytest.raises(ValueError):
        flash_attention_plain(q, kv, kv, causal=False, q_off=2)
    with pytest.raises(ValueError):
        flash_attention_plain(q, kv, kv, causal=True, q_off=7)


@pytest.mark.parametrize("arch,m,want", [
    ("granite-moe-3b-a800m", 2, dict(attention="heads", experts=True,
                                     embed="d_model", vocab=True)),
    ("hymba-1.5b", 2, dict(attention="sequence", ff=True, ssm_heads=True,
                           embed="d_model", vocab=True)),
    ("mamba2-370m", 2, dict(attention="none", ssm_heads=True,
                            embed="vocab", vocab=True)),
    ("granite-moe-3b-a800m", 16, dict(attention="sequence", experts=False)),
    ("minicpm-2b", 2, dict(attention="heads", ff=True, embed="vocab")),
    ("seamless-m4t-medium", 2, dict(attention="heads", ff=True,
                                    experts=False, ssm_heads=False,
                                    embed="d_model", vocab=True))])
def test_placement_follows_the_references_decisions(arch, m, want):
    """Head-parallel attention where the KV heads divide M (granite's 8 at
    2, seamless's 16), sequence-parallel otherwise (Hymba's 5, granite's 8
    at 16); experts cut where M divides them (granite's 40 at 2, whole at
    16, the reference's fallback); Hymba's 50 SSM heads and 5,504 ff cut
    at 2, seamless's 4,096; the vocab cut (padded: seamless's 256,256);
    a tied table on its vocab, an input-only one on d_model (seamless's
    1,024 columns)."""
    place = placement(get_config(arch), m)
    for key, value in want.items():
        assert getattr(place, key) == value, (key, place)


@pytest.mark.parametrize("groups,heads,m,even", [
    (3, 6, 2, False), (1, 8, 2, True), (2, 8, 2, True), (4, 8, 2, True),
    (2, 8, 4, True), (4, 8, 8, True), (2, 6, 3, False)])
def test_placement_keeps_unevenly_read_ssm_groups_whole(groups, heads, m,
                                                        even):
    """The SSM's heads are cut only where each rank's heads read their B/C
    groups evenly (one group, or whole groups from a group's first head):
    6 heads in 3 groups at M = 2 (3 heads a rank over 2 groups) and at
    M = 3 over 2 groups of 3 stay whole, as ``ff`` and the experts do where
    M does not divide them; ``ssm_groups_of`` raises only there."""
    cfg = smoke_variant(get_config("mamba2-370m")).replace(
        d_model=32 * heads, ssm_groups=groups)
    assert cfg.n_ssm_heads == heads
    assert placement(cfg, m).ssm_heads == even
    if not even:
        with pytest.raises(ValueError):
            ssm_groups_of(cfg, m, 0 if (groups, m) == (3, 2) else 1)


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_placement_keeps_an_undivided_vocab_whole(arch):
    """An odd unpadded vocab at M = 2: the logits and ``lm_head`` whole, a
    tied table whole, an input-only table still cut on d_model."""
    cfg = smoke_variant(get_config(arch)).replace(vocab_size=501,
                                                  vocab_pad_to=0)
    place = placement(cfg, 2)
    assert not place.vocab
    assert place.embed == ("whole" if cfg.tie_embeddings else "d_model")
    d, v = cfg.d_model, cfg.padded_vocab
    if not cfg.tie_embeddings:
        assert compute_cut(cfg, place, "lm_head.w", (d, v), 1) == (
            ((0, d),), ((0, v),))


def test_block_spec_is_the_per_layer_rule():
    """`block_spec` of a stacked leaf's layer is its rule without the
    layer axis: q's output and the experts' axis over model, the other
    weight axis over data; `param_specs` of the stacked leaf lands one
    dimension early."""
    sizes = {"node": 1, "data": 2, "model": 2}
    assert block_spec("layers.attn.q.w", (1536, 1536), sizes) == \
        ("data", "model")
    assert block_spec("layers.moe.experts.up.w", (40, 1536, 512), sizes) == \
        ("model", "data", None)
    assert param_specs({"layers.attn.q.w": (8, 1536, 1536)}, sizes)[
        "layers.attn.q.w"] == ("data", "model", None)


def test_compute_cut_takes_the_ssm_packed_leaves_by_part():
    """Hymba's in_proj [d, 2·di + 2·n + h] at M = 2: z, x and dt by heads,
    B and C whole (one group); the conv's channels the same way; the
    blocks of the two ranks cover the columns, the shared ones twice."""
    cfg = get_config("hymba-1.5b")
    place = placement(cfg, 2)
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    width = 2 * di + 2 * n + h
    cover = np.zeros(width, int)
    for r in range(2):
        ivs = compute_cut(cfg, place, "layers.ssm.in_proj.w",
                          (cfg.d_model, width), r)
        assert ivs[0] == ((0, cfg.d_model),)
        assert [iv[1] for iv in ivs[1]] == [di // 2, di // 2, n, n, h // 2]
        for a, k in ivs[1]:
            cover[a:a + k] += 1
    assert (cover[:2 * di] == 1).all() and (cover[-h:] == 1).all()
    assert (cover[2 * di:2 * di + 2 * n] == 2).all()
    conv = compute_cut(cfg, place, "layers.ssm.conv.w",
                       (cfg.conv_width, di + 2 * n), 1)
    assert conv[1] == ((di // 2, di // 2), (di, n), (di + n, n))


@pytest.mark.parametrize("m", [2, 4])
def test_compute_cut_takes_the_encdec_layers_and_cross_attention(m):
    """seamless-m4t-medium at M = 2 and 4: cross-attention's q, k, v
    column-parallel on heads and o row-parallel, as self-attention's in
    both stacks; the MLP's ff cut; the front end, the norms (cross_norm
    too) whole; the vocab-cut head and the d_model-cut embedding; with
    one KV head (sequence-parallel) the attention leaves whole."""
    cfg = get_config("seamless-m4t-medium")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    place = placement(cfg, m)
    for r in range(m):
        cut = lambda path, shape: compute_cut(cfg, place, path, shape, r)
        for top in ("enc_layers.attn", "dec_layers.attn",
                    "dec_layers.cross"):
            for name in ("q", "k", "v"):
                assert cut(f"{top}.{name}.w", (d, d)) == (
                    ((0, d),), ((r * d // m, d // m),))
            assert cut(f"{top}.o.w", (d, d)) == (
                ((r * d // m, d // m),), ((0, d),))
        assert cut("enc_layers.mlp.up.w", (d, f)) == (
            ((0, d),), ((r * f // m, f // m),))
        for path, shape in (("frontend_proj.w", (cfg.frontend_dim, d)),
                            ("frontend_proj.b", (d,)),
                            ("enc_norm.scale", (d,)),
                            ("dec_layers.cross_norm.scale", (d,)),
                            ("enc_layers.attn_norm.scale", (d,))):
            assert cut(path, shape) == tuple(((0, n),) for n in shape)
        assert cut("lm_head.w", (d, v)) == (((0, d),),
                                            ((r * v // m, v // m),))
        assert cut("embed.table", (v, d)) == (((0, v),),
                                              ((r * d // m, d // m),))
    seq = cfg.replace(n_kv_heads=1)
    place = placement(seq, m)
    assert place.attention == "sequence"
    assert compute_cut(seq, place, "dec_layers.cross.k.w", (d, 64), 1) == (
        ((0, d),), ((0, 64),))


# ---------------------------------------------------------------------------
# the collectives, the loss, the embedding
# ---------------------------------------------------------------------------

def _coll_want(inp, name, m):
    """Each rank's (output, gradient) of a collective from every rank's
    input and cotangent, in numpy."""
    xs = [inp[f"x{r}"] for r in range(m)]
    cs = [inp[f"cot/{name}{r}"] for r in range(m)]
    n = W.TP_X[1] // m
    if name == "gather":
        out, w = np.concatenate(xs, 1), W.TP_X[1]
        return [(out, sum(cs)[:, r * w:(r + 1) * w]) for r in range(m)]
    if name == "scatter":
        total = sum(xs)
        grad = np.concatenate(cs, 1)
        return [(total[:, r * n:(r + 1) * n], grad) for r in range(m)]
    if name == "a2a":
        out = [np.concatenate([x[:, r * n:(r + 1) * n] for x in xs], 2)
               for r in range(m)]
        d = W.TP_X[2]
        grad = [np.concatenate([c[:, :, r * d:(r + 1) * d] for c in cs], 1)
                for r in range(m)]
        return list(zip(out, grad))
    if name == "local":
        res = []
        for r in range(m):
            g = np.zeros_like(xs[r])
            g[:, r * n:(r + 1) * n] = cs[r]
            res.append((xs[r][:, r * n:(r + 1) * n], g))
        return res
    if name == "reduce":
        return [(sum(xs), sum(cs)) for r in range(m)]
    return [(xs[r], cs[r] / m) for r in range(m)]


@pytest.mark.parametrize("name", ["gather", "scatter", "a2a", "local",
                                  "reduce", "replicated"])
def test_collective_matches_its_plain_form(worlds, name):
    """Forward and backward of each collective Function against the plain
    single-rank form (numpy over every rank's input and cotangent),
    within 1e-6."""
    ranks, inp = worlds["tp_units"], worlds["inputs"]
    want = _coll_want(inp, name, len(ranks))
    for r, (out, (y, g)) in enumerate(zip(ranks, want)):
        np.testing.assert_allclose(out[f"coll/{name}/out"], y, rtol=0,
                                   atol=1e-6, err_msg=f"{name} {r}")
        np.testing.assert_allclose(out[f"coll/{name}/grad"], g, rtol=0,
                                   atol=1e-6, err_msg=f"{name} {r}")


def test_vocab_parallel_xent_matches_the_reference(worlds):
    """The masked token-mean cross entropy from each rank's vocab cut of
    the logits against `repro.models.layers.softmax_xent` on the whole
    vocab, and each rank's gradient against its cut of `jax.grad`'s,
    within 1e-6."""
    inp = worlds["inputs"]
    logits = jnp.asarray(inp["xent/logits"])
    args = (jnp.asarray(inp["xent/labels"]), jnp.asarray(inp["xent/mask"]))
    loss, grad = jax.value_and_grad(lambda z: jxent(z, *args))(logits)
    ranks = worlds["tp_units"]
    v = W.TP_VOCAB // len(ranks)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["xent/loss"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(out["xent/grad"],
                                   np.asarray(grad)[..., r * v:(r + 1) * v],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("cut", ["vocab", "d_model"])
def test_vocab_parallel_embedding_matches_the_reference(worlds, cut):
    """A tied table cut on the vocab (masked lookup, reduce_scatter) and an
    input-only one cut on d_model (lookup, all_to_all): each rank's cut
    of the sequence equals `repro.models.layers.embed` of the whole
    table, bit for bit."""
    inp = worlds["inputs"]
    want = np.asarray(jembed({"table": jnp.asarray(inp["xent/table"])},
                             jnp.asarray(inp["xent/tokens"]), jnp.float32))
    ranks = worlds["tp_units"]
    n = want.shape[1] // len(ranks)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"embed/{cut}"],
                                      want[:, r * n:(r + 1) * n])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _jcfg(arch, changes):
    return jconfigs.smoke_variant(jconfigs.get_config(arch)).replace(
        **changes)


def _block_reference(case):
    """The JAX package's block on the whole inputs: (y, aux or None); an
    enc-dec's encoder and decoder blocks composed of the reference's
    functions as its ``encode`` and ``decode_step`` bodies compose
    them."""
    inp = next(c for c in W.TP_BLOCKS if c[0] == case)
    _, arch, changes, module, window = inp
    worlds_inp = _block_inputs(case)
    jcfg = _jcfg(arch, changes)
    p = jax.tree.map(jnp.asarray, nest(worlds_inp["params"]))
    h = jnp.asarray(worlds_inp["h"])
    positions = jnp.broadcast_to(jnp.arange(W.TP_S)[None], (W.TP_B, W.TP_S))
    if module == "attn":
        return np.asarray(jattention(p, h, jcfg, positions=positions,
                                     window=window)[0]), None
    if module == "mlp":
        return np.asarray(jmlp(p, h, jcfg)), None
    if module == "moe":
        y, aux = jmoe(p, h, jcfg)
        return np.asarray(y), float(aux)
    if module == "ssm":
        return np.asarray(jssm(p, h, jcfg)[0]), None
    norm = lambda name, x: jrmsnorm(p[name], x, jcfg.norm_eps)
    if module == "enc":
        x = h + jattention(p["attn"], norm("attn_norm", h), jcfg,
                           positions=positions, causal=False)[0]
    else:
        kv = jnp.asarray(worlds_inp["kv"])
        kv_pos = jnp.broadcast_to(jnp.arange(W.TP_T)[None], (W.TP_B, W.TP_T))
        x = h + jattention(p["attn"], norm("attn_norm", h), jcfg,
                           positions=positions)[0]
        x = x + jattention(p["cross"], norm("cross_norm", x), jcfg,
                           positions=positions, kv_x=kv,
                           kv_positions=kv_pos, causal=False)[0]
    return np.asarray(x + jmlp(p["mlp"], norm("mlp_norm", x), jcfg)), None


_INPUTS = {}


def _block_inputs(case):
    """A block case's params (keyed relative to its prefix), input,
    cotangent and, for a decoder block, encoder output."""
    if not _INPUTS:
        _INPUTS.update(W.tp_inputs())
    module = next(c for c in W.TP_BLOCKS if c[0] == case)[3]
    prefix = f"block/{case}/p/{W.tp_block_prefix(module)}"
    return {"params": {k[len(prefix):]: v for k, v in _INPUTS.items()
                       if k.startswith(prefix)},
            "h": _INPUTS[f"block/{case}/h"],
            "cot": _INPUTS[f"block/{case}/cot"],
            "kv": _INPUTS.get(f"block/{case}/kv")}


@pytest.mark.parametrize("case", [c[0] for c in W.TP_BLOCKS])
def test_block_matches_the_reference(worlds, case):
    """Each block under tensor parallelism at (data, model) = (1, 2),
    every rank's cut of the output gathered, against the JAX package's
    function on the same inputs, within rtol 1e-5, atol 1e-5 (the MoE's
    aux loss too, alike on every rank)."""
    want, aux = _block_reference(case)
    ranks = worlds["tp_units"]
    got = np.concatenate([out[f"block/{case}/y"] for out in ranks], 1)
    np.testing.assert_allclose(got, want, **BLOCK_TOL)
    if aux is not None:
        for out in ranks:
            np.testing.assert_allclose(out[f"block/{case}/aux"], aux,
                                       **BLOCK_TOL)


@pytest.mark.parametrize("case", [c[0] for c in W.TP_BLOCKS])
def test_block_gradients_sum_to_the_unsharded_blocks(worlds, case):
    """Each block's gradients, leaf by leaf: the ranks' shares of each
    leaf's compute blocks summed where they land equal the port's
    unsharded block's gradient of Σ y · cotangent (+ aux), the input's
    cut its cut of the input's gradient, and a decoder block's shares of
    the whole encoder output's gradient sum to it, within 1e-5 of the
    leaf's largest magnitude: a leaf summed twice (or a share dropped)
    would be off by its whole size."""
    _, arch, changes, module, window = next(c for c in W.TP_BLOCKS
                                            if c[0] == case)
    cfg = W.tp_block_cfg(arch, changes)
    inp = _block_inputs(case)
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in inp["params"].items()}
    ins = [torch.from_numpy(inp["h"]).requires_grad_()]
    if inp["kv"] is not None:
        ins.append(torch.from_numpy(inp["kv"]).requires_grad_())
    positions = torch.arange(W.TP_S)[None].expand(W.TP_B, W.TP_S)
    y = W.tp_block_fn(module)(nest(params), ins[0], cfg, positions, window,
                              ins[1] if len(ins) > 1 else None)
    aux = 0
    if module == "moe":
        y, aux = y
    loss = (y * torch.from_numpy(inp["cot"])).sum() + aux
    grads = torch.autograd.grad(loss, ins + list(params.values()))
    ranks = worlds["tp_units"]
    m = len(ranks)
    place = placement(cfg, m)
    gh = np.concatenate([out[f"block/{case}/gh"] for out in ranks], 1)
    np.testing.assert_allclose(gh, grads[0].numpy(), rtol=0,
                               atol=1e-5 * float(grads[0].abs().max()))
    if len(ins) > 1:
        gkv = sum(out[f"block/{case}/gkv"] for out in ranks)
        np.testing.assert_allclose(gkv, grads[1].numpy(), rtol=0,
                                   atol=1e-5 * float(grads[1].abs().max()))
    for name, want in zip(params, grads[len(ins):]):
        path = W.tp_block_prefix(module) + name
        total = np.zeros(want.shape, np.float32)
        for r, out in enumerate(ranks):
            idx = np.ix_(*W.tp_slices(compute_cut(cfg, place, path,
                                                  want.shape, r)))
            total[idx] += out[f"block/{case}/g/{path}"]
        scale = float(want.abs().max())
        np.testing.assert_allclose(total, want.numpy(), rtol=0,
                                   atol=1e-5 * max(scale, 1e-12),
                                   err_msg=path)


# ---------------------------------------------------------------------------
# the split steps
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("fam", [f for f, _ in W.TP_ARCHS])
def test_tp_split_steps_match_the_jax_package(worlds, world, fam):
    """Two tensor-parallel split steps (remat on) from the JAX package's
    params: the loss within rtol 1e-5, the node's params within rtol
    1e-4, atol 1e-4 of `repro.launch.train.make_train_step` on the whole
    batch; every rank of the node gathers the same node."""
    arch = dict(W.TP_ARCHS)[fam]
    layout = build_model(smoke_variant(get_config(arch))).layout
    want = worlds["jax"][fam]
    ranks = worlds[world]
    for out in ranks:
        np.testing.assert_allclose(out[f"{fam}/loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(out[f"{fam}/params"],
                                      ranks[0][f"{fam}/params"])
    g = _leaves(lm_params_to_reference(layout, torch.from_numpy(
        ranks[0][f"{fam}/params"])))
    w = _leaves(want["params"])
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=path,
                                   **PARAMS_TOL)


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("fam", [f for f, _ in W.TP_ARCHS])
def test_every_leafs_gradient_matches_the_unsharded_twin(worlds, world, fam):
    """The first split step's gradient, gathered from the shards, against
    the unsharded step's on the same batch, leaf by leaf: within 1e-4 of
    the leaf's largest magnitude."""
    for out in worlds[world]:
        rel = dict(zip(out[f"{fam}/grad_leaves"], out[f"{fam}/grad_rel"]))
        assert rel and max(rel.values()) <= GRAD_REL, rel


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("fam", [f for f, _ in W.TP_ARCHS])
def test_tp_step_bytes_match_the_layout(worlds, world, fam):
    """Each split step's bytes by kind, and the split gate's, equal the
    layout's count (`chip_smoke._tp_bytes`): the compute blocks' exchange
    (``layer_gather``, ``gate_gather``), the gradient's way back
    (``grad_to_shard``) and the model group's activations (``tp_*``)."""
    n, d, m = W.TP_WORLDS[world]
    arch = dict(W.TP_ARCHS)[fam]
    cfg = smoke_variant(get_config(arch))
    layout = build_model(cfg).layout
    sizes = {"data": d, "model": m}
    specs = param_specs(layout, dict(node=n, **sizes))
    rows = W.TP_JAX_BATCH // d
    for out in worlds[world]:
        coords = {"data": int(out["coords"][0]),
                  "model": int(out["coords"][1])}
        sh = ShardLayout(layout, specs, sizes, coords)
        step, gate = W.tp_bytes(sh, cfg, cfg.n_layers, 4, rows,
                                W.TP_JAX_SEQ, d > 1,
                                val=(W.TP_JAX_BATCH, W.TP_JAX_SEQ))
        for k in range(W.TP_JAX_STEPS):
            for kind, nbytes in step.items():
                assert out.get(f"{fam}/bytes{k}/{kind}", 0) == nbytes, \
                    (k, kind)
            assert "grad_reduce" not in out.get(f"{fam}/bytes{k}", {})
        for kind, nbytes in gate.items():
            assert out.get(f"{fam}/gate_bytes/{kind}", 0) == nbytes, kind


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
def test_a_rank_holds_compute_blocks_only(worlds, world):
    """No block a step gathers of a model-cut leaf is the leaf's whole
    layer, and with remat at most two layers' compute blocks are alive at
    once."""
    for out in worlds[world]:
        for fam, _ in W.TP_ARCHS:
            assert not out[f"{fam}/whole_layer"], fam
            assert 1 <= out[f"{fam}/peak_blocks"] <= 2, fam


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
def test_tp_gate_matches_the_whole_node_gate(worlds, world):
    """The split gate under tensor parallelism against the whole node's
    metric on the same params and rows: within 1e-5."""
    for out in worlds[world]:
        for fam, _ in W.TP_ARCHS:
            split, whole = out[f"{fam}/gate"]
            assert abs(split - whole) <= 1e-5, (fam, split, whole)


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("name", [n for n, _, _ in W.TP_MORE])
def test_vlm_and_lora_gradients_match_the_unsharded_twin(worlds, world,
                                                         name):
    """The vlm smoke model (its patches projected and its text embedded
    whole, then the rank's cut) and a LoRA'd dense smoke model (each
    adapter cut with its layer: B with a column-parallel weight, A with a
    row-parallel one): the first tensor-parallel split step's gradient,
    leaf by leaf, within 1e-4 of the leaf's largest magnitude of the
    unsharded step's."""
    for out in worlds[world]:
        rel = out[f"{name}/grad_rel"]
        assert rel.size and rel.max() <= GRAD_REL, rel


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
def test_encdec_split_is_tensor_parallel(worlds, world):
    """The enc-dec smoke model at model 2 has a tensor plan in both its
    forms: its steps move the model group's activations (``tp_*``) and
    send the gradient's pieces to the ranks that store them
    (``grad_to_shard``), not the whole-layer split's reduces."""
    for out in worlds[world]:
        assert out["encdec_seq/tensor_plan"]
        for prefix in ("encdec/bytes0/", "encdec_seq/bytes/"):
            kinds = {k[len(prefix):] for k in out if k.startswith(prefix)}
            assert {"layer_gather", "grad_to_shard", "tp_gather",
                    "tp_reduce_scatter", "tp_all_to_all",
                    "tp_all_reduce"} <= kinds, (prefix, kinds)
            assert not any(k.startswith("grad_reduce") for k in kinds)


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
def test_encdec_sequence_parallel_step_matches_the_whole_node(worlds,
                                                               world):
    """The enc-dec's sequence-parallel form (one KV head: the encoder's
    unmasked and the decoder's causal self-attention over the whole K/V,
    cross-attention on the rank's query rows; the padding columns of a
    padded vocab on the last model rank): the first split step's gradient
    within 1e-4 of the unsharded one's, leaf by leaf, its loss within
    rtol 1e-5 and its params within rtol 1e-4, atol 1e-4 of the whole
    node's step."""
    for out in worlds[world]:
        rel = out["encdec_seq/grad_rel"]
        assert rel.size and rel.max() <= GRAD_REL, rel
        split, whole = out["encdec_seq/loss"]
        np.testing.assert_allclose(split, whole, rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["encdec_seq/params"],
                                   out["encdec_seq/whole"], **PARAMS_TOL)


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
def test_encdec_bytes_match_the_layout_with_one_encoder_output_gather(
        worlds, world):
    """The sequence-parallel form's step and gate bytes by kind equal the
    layout's count (`chip_smoke._tp_bytes`, which counts one gather of
    the encoder output a forward), and in both forms a step gathers
    frame rows 2 · L_enc + 1 times: each encoder layer's attention and
    MLP, then the encoder output once for every decoder layer (remat's
    recompute of a decoder block gathers none)."""
    n, d, m = W.TP_WORLDS[world]
    arch, changes = W.TP_ENCDEC_SEQ
    cfg = smoke_variant(get_config(arch)).replace(**changes)
    layout = build_model(cfg).layout
    sizes = {"data": d, "model": m}
    specs = param_specs(layout, dict(node=n, **sizes))
    tokens = worlds["inputs"]["encdec_seq/tokens"]
    for out in worlds[world]:
        coords = {"data": int(out["coords"][0]),
                  "model": int(out["coords"][1])}
        sh = ShardLayout(layout, specs, sizes, coords)
        step, gate = W.tp_bytes(sh, cfg, cfg.n_layers, 4,
                                tokens.shape[0] // d, tokens.shape[1], d > 1,
                                val=tokens.shape, frames=W.TP_ENCDEC_FRAMES)
        got = {k[len("encdec_seq/bytes/"):]: int(v) for k, v in out.items()
               if k.startswith("encdec_seq/bytes/")}
        got.pop("step_control", None)
        assert got == step
        got = {k[len("encdec_seq/gate_bytes/"):]: int(v)
               for k, v in out.items()
               if k.startswith("encdec_seq/gate_bytes/")}
        assert got == gate
        want = 2 * cfg.n_enc_layers + 1
        assert out["encdec_seq/frame_gathers"] == want
        for k in range(W.TP_JAX_STEPS):
            assert out[f"encdec/frame_gathers{k}"] == want


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
def test_encdec_split_raises_where_model_does_not_divide_a_sequence(
        worlds, world):
    """An enc-dec split step at model 2 with 23 frames, 15 tokens or both
    (`W.TP_ENCDEC_PAIRS`: the encoder, the decoder or both in the
    whole-residual form, each stack picking its form on its own) no longer
    raises: against the whole node's step on the same batch, every leaf's
    gradient within 1e-4 of its largest magnitude, the loss within rtol
    1e-5, the params within rtol 1e-4, atol 1e-4, the split gate's metric
    within 1e-5; its bytes by kind and the gate's the layout's count
    (`chip_smoke._tp_bytes` with the whole forms)."""
    n, d, m = W.TP_WORLDS[world]
    arch, changes = W.TP_ENCDEC_SEQ
    cfg = smoke_variant(get_config(arch)).replace(**changes)
    layout = build_model(cfg).layout
    sizes = {"data": d, "model": m}
    specs = param_specs(layout, dict(node=n, **sizes))
    inp = worlds["inputs"]
    b = {k: inp[f"encdec_seq/{k}"] for k in ("tokens", "labels", "frames")}
    for what in W.TP_ENCDEC_PAIRS:
        bad = _encdec_pair_batch(b, what)
        tokens, frames = bad["tokens"], bad["frames"].shape[1]
        for out in worlds[world]:
            _hold_against_whole(out, f"encdec_seq/{what}")
            coords = {"data": int(out["coords"][0]),
                      "model": int(out["coords"][1])}
            sh = ShardLayout(layout, specs, sizes, coords)
            _hold_bytes(out, f"encdec_seq/{what}", W.tp_bytes(
                sh, cfg, cfg.n_layers, 4, tokens.shape[0] // d,
                tokens.shape[1], d > 1, val=tokens.shape, frames=frames))


def _hold_against_whole(out, key):
    """A split step's record (`W._split_against_whole`) against the whole
    node's step: gradients, loss, params and the split gate's metric."""
    rel = out[f"{key}/grad_rel"]
    assert rel.size and rel.max() <= GRAD_REL, (key, rel)
    split, whole = out[f"{key}/loss"]
    np.testing.assert_allclose(split, whole, rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(out[f"{key}/params"], out[f"{key}/whole"],
                               err_msg=key, **PARAMS_TOL)
    split, whole = out[f"{key}/gate"]
    assert abs(split - whole) <= 1e-5, (key, split, whole)


def _hold_bytes(out, key, counted):
    """A split step's and its split gate's bytes by kind against the
    layout's count ``(step, gate)``."""
    step, gate = counted
    got = {k[len(f"{key}/bytes/"):]: int(v) for k, v in out.items()
           if k.startswith(f"{key}/bytes/")}
    got.pop("step_control", None)
    assert got == step, (key, got, step)
    got = {k[len(f"{key}/gate_bytes/"):]: int(v) for k, v in out.items()
           if k.startswith(f"{key}/gate_bytes/")}
    assert got == gate, (key, got, gate)


def _hold_jax(out, key, layout, want):
    """A split step's loss within rtol 1e-5 and its node's params within
    rtol 1e-4, atol 1e-4 of the JAX package's step ``want``."""
    np.testing.assert_allclose(out[f"{key}/loss"][0], want["loss"][0],
                               rtol=LOSS_RTOL, err_msg=key)
    g = _leaves(lm_params_to_reference(layout, torch.from_numpy(
        out[f"{key}/params"])))
    w = _leaves(want["params"])
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=f"{key} {path}",
                                   **PARAMS_TOL)


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("what", W.TP_ENCDEC_PAIRS)
def test_encdec_whole_forms_match_the_jax_package(worlds, world, what):
    """The enc-dec split step with its frames, its tokens or both in the
    whole-residual form, from the port's seed-0 init: its loss within rtol
    1e-5 and its node's params within rtol 1e-4, atol 1e-4 of
    `repro.launch.train.make_train_step` on the same batch and params."""
    arch, changes = W.TP_ENCDEC_SEQ
    layout = build_model(smoke_variant(get_config(arch)).replace(
        **changes)).layout
    for out in worlds[world]:
        _hold_jax(out, f"encdec_seq/{what}", layout,
                  worlds["jax"][f"encdec_seq/{what}"])


UNEVEN = [c[0] for c in W.TP_UNEVEN]


def _uneven(name):
    _, arch, changes, seq, frames = next(c for c in W.TP_UNEVEN
                                         if c[0] == name)
    return smoke_variant(get_config(arch)).replace(**changes), seq, frames


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("name", UNEVEN)
def test_uneven_split_step_matches_the_jax_package(worlds, world, name):
    """A split step whose sequence, padded vocab or SSM groups the model
    group does not divide (`W.TP_UNEVEN`: the whole residual, the whole
    logits with their loss counted once, the SSM mixer whole), from the
    JAX package's params: the loss within rtol 1e-5 and the node's params
    within rtol 1e-4, atol 1e-4 of `repro.launch.train.make_train_step` on
    the whole batch; every rank of the node gathers the same node."""
    cfg, _, _ = _uneven(name)
    layout = build_model(cfg).layout
    ranks = worlds[world]
    for out in ranks:
        np.testing.assert_array_equal(out[f"uneven/{name}/params"],
                                      ranks[0][f"uneven/{name}/params"])
        _hold_jax(out, f"uneven/{name}", layout,
                  worlds["jax"][f"uneven/{name}"])


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("name", UNEVEN)
def test_uneven_split_step_matches_the_whole_node(worlds, world, name):
    """The same steps against the whole node's step on the same batch:
    every leaf's gradient within 1e-4 of its largest magnitude (a whole
    block's partial cotangents summed twice, or the whole logits' loss
    counted M times, would be off by its whole size), the loss, the
    params, and the split gate's metric within 1e-5."""
    for out in worlds[world]:
        _hold_against_whole(out, f"uneven/{name}")


@pytest.mark.parametrize("world", list(W.TP_WORLDS))
@pytest.mark.parametrize("name", UNEVEN)
def test_uneven_step_bytes_match_the_layout(worlds, world, name):
    """The steps' and their split gates' bytes by kind equal the layout's
    count (`chip_smoke._tp_bytes`): no gathers in the whole residual, each
    row-parallel output's f32 all_reduce both ways, the embedding's
    gather or all_reduce, no loss all_reduces with the logits whole."""
    n, d, m = W.TP_WORLDS[world]
    cfg, seq, frames = _uneven(name)
    layout = build_model(cfg).layout
    sizes = {"data": d, "model": m}
    specs = param_specs(layout, dict(node=n, **sizes))
    for out in worlds[world]:
        coords = {"data": int(out["coords"][0]),
                  "model": int(out["coords"][1])}
        sh = ShardLayout(layout, specs, sizes, coords)
        _hold_bytes(out, f"uneven/{name}", W.tp_bytes(
            sh, cfg, cfg.n_layers, 4, W.TP_JAX_BATCH // d, seq, d > 1,
            val=(W.TP_JAX_BATCH, seq), frames=frames))


def test_encdec_split_gate_matches_the_whole_node_gate(worlds):
    """A round of the enc-dec smoke session at (2, 1, 2), its TrainStep
    tensor-parallel, its gate's threshold between the two nodes' ratios:
    the split gate's metrics within 1e-5 of the whole-node gate's, the
    gates equal (one open, one shut), and the split gate's bytes those of
    two scores a node (`chip_smoke._tp_bytes`)."""
    model = build_model(smoke_variant(get_config("seamless-m4t-medium")))
    cfg, layout = model.cfg, model.layout
    n, d, m = W.TP_GATE
    sizes = {"data": d, "model": m}
    specs = param_specs(layout, dict(node=n, **sizes))
    val = worlds["inputs"]["encgate/vtokens"].shape[1:]
    for out in worlds["tp_encdec_gate"]:
        assert out["encgate/split/split_gate"]
        assert not out["encgate/whole/split_gate"]
        np.testing.assert_allclose(out["encgate/split/metrics"],
                                   out["encgate/whole/metrics"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(out["encgate/split/gates"],
                                      out["encgate/whole/gates"])
        assert out["encgate/split/gates"].tolist() == [True, False]
        coords = {"data": int(out["coords"][0]),
                  "model": int(out["coords"][1])}
        sh = ShardLayout(layout, specs, sizes, coords)
        _, gate = W.tp_bytes(sh, cfg, cfg.n_layers, 4, 1, 1, False, val=val)
        for kind, nbytes in gate.items():
            assert out[f"encgate/split/bytes/{kind}"] == 2 * nbytes, kind
