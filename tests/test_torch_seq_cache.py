"""The decode cache cut on its sequence over the data group: the
reference's long-context placement (``repro.launch.specs.cache_specs``:
where ``batch → data`` does not divide the batch, the cache's sequence
axis goes over ``data``), served by `repro_torch.launch.serve` on a mesh
whose data group does not divide the batch
(`repro_torch.launch.serve.StepBuffers`, ``seq``).

A gloo world of 4 ranks on the CPU (`tests/torch_gossip_world.py`, task
``seq_cache``): (node, data, model) = (1, 2, 2), one row, a cache of 16
positions cut into 2 × 8; a smoke dense model with a sliding window of 4
(its KV heads cut over model) and the smoke hybrid (its one KV head: the
cache on the head dim, the partial scores all_reduced over model before
the sequence's softmax combines over data). A prompt of 6 tokens and 8
new ones, so the decode crosses from data rank 0's positions into rank
1's. The smoke models in f32, from the JAX package's own init, carried
across by `repro_torch.convert`.

Held: every rank's logits within 1e-5 of the same model rank's on a (2,
1, 2) mesh of the same world, whose caches are whole; within the LM
logits tolerance (2e-4) of the JAX package's prefill and decode steps;
the token streams equal to both and to the JAX package's ``generate``;
the rank's K/V cache ``[1, 8, ...]``; a decode step's combine bytes
(``tp_seq_max``, ``tp_seq_sum``) as counted from the config.
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
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import build_model

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300
LOGIT_TOL = 2e-4
WHOLE_TOL = 1e-5
CASES = [c[0] for c in W.SEQ_CACHE]


def _reference(jm, tree, prompt, new, max_len):
    """The JAX package's logits of the prefill and each greedy decode step
    after it [B, new, V]."""
    decode = jax.jit(jm.decode)
    caches = jm.init_cache(prompt.shape[0], max_len)
    logits, caches = jax.jit(jm.prefill)(tree, {"tokens": prompt}, caches)
    seen = [logits[:, -1]]
    for i in range(new - 1):
        tok = jnp.argmax(seen[-1], axis=-1)[:, None].astype(jnp.int32)
        logits, caches = decode(tree, tok, caches,
                                jnp.int32(prompt.shape[1] + i))
        seen.append(logits[:, -1])
    return np.asarray(jnp.stack(seen, axis=1))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_cache")
    rng = np.random.default_rng(33)
    inputs, want = {}, {}
    for k, (case, arch, changes) in enumerate(W.SEQ_CACHE):
        jcfg = jsmoke(jget_config(arch)).replace(**changes)
        jm = jbuild(jcfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.key(40 + k)))
        layout = build_model(W.tp_serve_cfg(arch, changes)).layout
        inputs[f"seq/{case}/flat"] = lm_params_from_reference(
            layout, tree).numpy()
        prompt = rng.integers(0, jcfg.vocab_size,
                              (W.SEQ_CACHE_B, W.SEQ_CACHE_S)).astype(np.int64)
        inputs[f"seq/{case}/prompt"] = prompt
        want[case] = (jm, tree, jnp.asarray(prompt, jnp.int32))
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    n = W.SEQ_CACHE_WORLD
    procs = [subprocess.Popen(
        [sys.executable, script, "seq_cache", str(r), str(n),
         f"file://{d}/rdv_seq_cache", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    try:
        ref = {}
        for case, (jm, tree, prompt) in want.items():
            ref[case] = (
                np.asarray(jgenerate(jm, tree, prompt, W.SEQ_CACHE_NEW,
                                     W.SEQ_CACHE_LEN)),
                _reference(jm, tree, prompt, W.SEQ_CACHE_NEW,
                           W.SEQ_CACHE_LEN))
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(d / f"seq_cache_rank{r}.npz")) for r in range(n)]
    return ranks, ref


def _cfg(case):
    _, arch, changes = next(c for c in W.SEQ_CACHE if c[0] == case)
    return W.tp_serve_cfg(arch, changes)


@pytest.mark.parametrize("case", CASES)
def test_cut_cache_matches_the_whole_cache_of_the_same_rank(world, case):
    """Each rank's logits with the cache's sequence cut over data within
    1e-5 of the same model rank's with the cache whole, and the streams
    equal."""
    for rank in world[0]:
        np.testing.assert_allclose(rank[f"seq/{case}/cut/logits"],
                                   rank[f"seq/{case}/whole/logits"],
                                   rtol=0, atol=WHOLE_TOL)
        np.testing.assert_array_equal(rank[f"seq/{case}/cut/tokens"],
                                      rank[f"seq/{case}/whole/tokens"])


@pytest.mark.parametrize("case", CASES)
def test_cut_cache_matches_the_reference_decode(world, case):
    """Every rank's logits within 2e-4 of the JAX package's prefill and
    decode steps (the vocab's padding left out), its greedy stream equal
    to the JAX package's ``generate``."""
    tokens, logits = world[1][case]
    v = _cfg(case).vocab_size
    for rank in world[0]:
        np.testing.assert_allclose(rank[f"seq/{case}/cut/logits"][..., :v],
                                   logits[..., :v], rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(rank[f"seq/{case}/cut/tokens"],
                                      tokens)


@pytest.mark.parametrize("case", CASES)
def test_cut_cache_shapes_and_combine_bytes(world, case):
    """A rank's K/V cache holds its 8 of the 16 positions (cut into 2),
    on its KV heads or its slice of the head dim as ``cache_cut`` says;
    a decode step's combine moves, a layer, the row max of each head it
    scores (f32) and their sums and weighted values in one buffer."""
    from repro_torch.sharding.rules import cache_cut, placement
    cfg = _cfg(case)
    m = 2
    place = placement(cfg, m)
    cut = cache_cut(cfg, place)
    heads = cfg.n_heads // m if cut == "kv_heads" else cfg.n_heads
    width = cfg.head_dim // m if cut == "head_dim" else cfg.head_dim
    nkv = cfg.n_kv_heads // m if cut == "kv_heads" else cfg.n_kv_heads
    b = W.SEQ_CACHE_B
    for rank in world[0]:
        assert int(rank[f"seq/{case}/seq"]) == 2
        cache = json.loads(str(rank[f"seq/{case}/cache"]))
        assert cache["k"] == cache["v"] == [b, W.SEQ_CACHE_LEN // 2, nkv,
                                            width]
        got = json.loads(str(rank[f"seq/{case}/bytes"]))
        assert got["tp_seq_max"] == cfg.n_layers * 4 * b * heads
        assert got["tp_seq_sum"] == cfg.n_layers * 4 * b * heads * (1 + width)
