"""The dry run's ``dp`` and ``zero3`` profiles on a real process group:
no tensor parallelism, the params FSDP over ``data`` (``dp``: a block
repeated on every model rank) or over the whole grid (``zero3``), the
rows over the node's every rank (`repro_torch.launch.mesh.use_profile`,
`repro_torch.launch.train.TrainStep.split`, the stored form of
`repro_torch.launch.serve.StepBuffers`, `repro_torch.sharding.stored`).

One world of 4 gloo ranks (`tests/torch_gossip_world.py`, task
``profiles``: one node as (data, model) = (2, 2) under each profile):

  * two split steps of the hymba-1.5b (SSM heads) and granite-moe-3b
    (MoE) smoke models, remat on, from the JAX package's params
    (`repro_torch.convert`), held to the whole node's step on the same
    batches within 1e-4 (f32), to `repro.launch.train.make_train_step` on
    the whole batch within the train-parity tolerances of
    `tests/test_torch_split.py` (loss rtol 1e-5, params rtol 1e-4, atol
    1e-4), and their bytes by kind (``dp``'s replica all_reduce, no
    tensor-parallel kind); two rows, which the batch group does not
    divide (each rank then computes the rows of its input's cut),
    against the whole node's step;
  * ``generate`` (a prefill and 4 decode steps) of three smoke models
    from the rank's stored shard: its rows of 4 (the profile's input
    cut) and one row (the cache's sequence cut over the batch axes),
    tokens equal to the single-process port's and logits within 2e-4;
    the cache at the profile's shard shapes, ``zero3``'s gathered over
    the model group each decode step (``cache_gather``).

About 40 s on one CPU worker.
"""
import json
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
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.sharding import rules

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300
PROFILES = ("dp", "zero3")
#: the train-parity tolerances (tests/test_torch_split.py)
PARAMS_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
#: against the whole node's step in the same process (f32)
WHOLE_TOL = 1e-4
#: served logits against the single-process port's
LOGITS_TOL = 2e-4
WORLD = int(np.prod(W.PROFILE_SHAPE))
SIZES = {"data": W.PROFILE_SHAPE[1], "model": W.PROFILE_SHAPE[2]}


def _jax_steps(arch, rng):
    """The JAX package's smoke ``arch`` from its own init: the flat params
    the port starts from, the batches, and PROFILE_STEPS steps' losses
    and params (lr 1e-4, no warmup, remat off)."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    jm = jbuild(jcfg)
    layout = build_model(smoke_variant(get_config(arch))).layout
    tree = jm.init(jax.random.key(0))
    flat = lm_params_from_reference(layout, jax.tree.map(np.asarray, tree))
    opt = jadamw_init(tree)
    step = jax.jit(jtrain.make_train_step(jm, JTrainConfig(
        lr=1e-4, warmup_steps=0, max_steps=10, remat=False)))
    toks = rng.integers(0, jcfg.vocab_size, (
        W.PROFILE_STEPS, W.PROFILE_BATCH, W.PROFILE_SEQ + 1))
    losses = []
    for k in range(W.PROFILE_STEPS):
        tree, opt, m = step(tree, opt, {
            "tokens": jnp.asarray(toks[k, :, :-1].astype(np.int32)),
            "labels": jnp.asarray(toks[k, :, 1:].astype(np.int32))})
        losses.append(float(m["loss"]))
    return ({"flat": flat.numpy(), "tokens": toks[..., :-1].astype(np.int64),
             "labels": toks[..., 1:].astype(np.int64)},
            {"loss": np.asarray(losses),
             "params": jax.tree.map(np.asarray, tree)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' outputs and the JAX package's steps."""
    d = tmp_path_factory.mktemp("profiles")
    rng = np.random.default_rng(11)
    inputs, want = {}, {}
    for fam, arch in W.PROFILE_TRAIN:
        port, want[fam] = _jax_steps(arch, rng)
        inputs.update({f"jax/{fam}/{k}": v for k, v in port.items()})
    for i, arch in enumerate(W.PROFILE_SERVE):
        model = build_model(smoke_variant(get_config(arch)))
        inputs[f"serve/{arch}/flat"] = model.init(
            torch.Generator().manual_seed(20 + i), "cpu").numpy()
        inputs[f"serve/{arch}/prompt"] = rng.integers(
            0, model.cfg.vocab_size, (max(W.PROFILE_SERVE_ROWS),
                                      W.PROFILE_PROMPT)).astype(np.int64)
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "profiles", str(r), str(WORLD),
         f"file://{d}/rdv_profiles", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(d / f"profiles_rank{r}.npz")) for r in range(WORLD)]
    return {"ranks": ranks, "jax": want}


@pytest.mark.parametrize("fam", [f for f, _ in W.PROFILE_TRAIN])
@pytest.mark.parametrize("profile", PROFILES)
def test_profile_split_step_matches_the_whole_node(world, profile, fam):
    """Each rank's two split steps (its rows of the node's 4 over the
    whole position, the layers gathered whole, the gradient back onto its
    shard) gather to the whole node's two steps within 1e-4, losses
    within rtol 1e-5; every rank gathers the same node."""
    key = f"{profile}/{fam}"
    ranks = world["ranks"]
    for out in ranks:
        split, whole = out[f"{key}/params"]
        np.testing.assert_allclose(split, whole, rtol=0, atol=WHOLE_TOL)
        np.testing.assert_array_equal(split, ranks[0][f"{key}/params"][0])
        np.testing.assert_allclose(out[f"{key}/loss"][:, 0],
                                   out[f"{key}/loss"][:, 1], rtol=LOSS_RTOL)


@pytest.mark.parametrize("fam", [f for f, _ in W.PROFILE_TRAIN])
@pytest.mark.parametrize("profile", PROFILES)
def test_profile_split_step_matches_the_jax_package(world, profile, fam):
    """The same two steps against `repro.launch.train.make_train_step` on
    the whole batch from the same params: the loss within rtol 1e-5, the
    params (carried back by `repro_torch.convert`) within rtol 1e-4, atol
    1e-4."""
    arch = dict(W.PROFILE_TRAIN)[fam]
    layout = build_model(smoke_variant(get_config(arch))).layout
    want = world["jax"][fam]
    out = world["ranks"][0]
    np.testing.assert_allclose(out[f"{profile}/{fam}/loss"][:, 0],
                               want["loss"], rtol=LOSS_RTOL)
    got = lm_params_to_reference(layout, torch.from_numpy(
        out[f"{profile}/{fam}/params"][0]))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in leaves(v, f"{prefix}{k}.").items()}
        return {prefix[:-1]: np.asarray(tree, np.float32)}

    g, w = leaves(got), leaves(want["params"])
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], err_msg=path,
                                   **PARAMS_TOL)


@pytest.mark.parametrize("profile", PROFILES)
def test_profile_rows_the_batch_group_does_not_divide(world, profile):
    """Two rows over 4 ranks: each rank computes its input cut's row
    (``dp``: by its model index, ``zero3``: by its data index), the
    gradient summed over the whole position and divided by its size: the
    whole node's step within 1e-4."""
    for out in world["ranks"]:
        for fam, _ in W.PROFILE_TRAIN:
            split, whole = out[f"{profile}/{fam}/two/params"]
            np.testing.assert_allclose(split, whole, rtol=0, atol=WHOLE_TOL)
            loss = out[f"{profile}/{fam}/two/loss"]
            np.testing.assert_allclose(loss[0], loss[1], rtol=LOSS_RTOL)


@pytest.mark.parametrize("profile", PROFILES)
def test_profile_step_bytes_by_kind(world, profile):
    """No tensor-parallel kind under either profile; ``dp`` gathers over
    the data group and sums its blocks over the model group
    (``grad_replica``), ``zero3`` over the whole position (no replica)."""
    for out in world["ranks"]:
        for fam, _ in W.PROFILE_TRAIN:
            got = json.loads(str(out[f"{profile}/{fam}/bytes"]))
            assert not [k for k in got if k.startswith("tp_")], got
            assert got.get("layer_gather", 0) > 0
            assert ("grad_replica" in got) == (profile == "dp"), got


@pytest.mark.parametrize("arch", W.PROFILE_SERVE)
@pytest.mark.parametrize("profile", PROFILES)
def test_profile_serving_matches_the_single_process_port(world, profile,
                                                         arch):
    """A prefill and 4 decode steps from the rank's stored shard: the
    token stream of its rows equal to the single-process port's, the
    logits within 2e-4; its rows the profile's input cut (``dp``: one of
    4 a rank; ``zero3``: 2 by its data index), one row served whole with
    the cache's sequence cut over the batch axes (``dp``: 4 parts;
    ``zero3``: 2)."""
    for out in world["ranks"]:
        d, m = (int(c) for c in out[f"{profile}/coords"])
        for rows in W.PROFILE_SERVE_ROWS:
            key = f"{profile}/serve/{arch}/{rows}"
            np.testing.assert_array_equal(out[f"{key}/tokens"],
                                          out[f"{key}/single_tokens"])
            np.testing.assert_allclose(out[f"{key}/logits"],
                                       out[f"{key}/single_logits"],
                                       rtol=0, atol=LOGITS_TOL)
            lo, hi, seq = (int(x) for x in out[f"{key}/rows"])
            if rows == 1:
                assert (lo, hi, seq) == (0, 1, WORLD if profile == "dp"
                                         else SIZES["data"])
            elif profile == "dp":
                assert (lo, hi, seq) == (d * 2 + m, d * 2 + m + 1, 1)
            else:
                assert (lo, hi, seq) == (2 * d, 2 * d + 2, 1)


@pytest.mark.parametrize("profile", PROFILES)
def test_profile_serving_cache_and_bytes(world, profile):
    """The served rank's cache at the profile's shard shapes
    (`repro_torch.sharding.rules.stored_cache_shapes`: ``zero3``'s K/V
    cut over the model group on the KV heads or the head dim, the SSM
    state and conv tail on theirs; ``dp``'s whole), its params its shard
    of the node, and a decode step's bytes: the layers gathered, and only
    under ``zero3`` the cut cache (``cache_gather``)."""
    out = world["ranks"][0]
    for arch in W.PROFILE_SERVE:
        cfg = smoke_variant(get_config(arch))
        cut = rules.profile_cache_cut(cfg, profile, SIZES["model"])
        assert cut.cut == (profile == "zero3")
        shard = specs.shard_layout(build_model(cfg), SIZES, {"data": 0,
                                                             "model": 0},
                                   profile)
        for rows in W.PROFILE_SERVE_ROWS:
            key = f"{profile}/serve/{arch}/{rows}"
            lo, hi, seq = (int(x) for x in out[f"{key}/rows"])
            want = rules.stored_cache_shapes(cfg, cut, hi - lo,
                                             W.PROFILE_LEN, seq)
            got = json.loads(str(out[f"{key}/cache"]))
            assert got == {k: list(v) for k, v in want.items()}, key
            assert int(out[f"{key}/params_size"]) == shard.local.size
            counted = json.loads(str(out[f"{key}/bytes"]))
            assert counted.get("layer_gather", 0) > 0
            assert ("cache_gather" in counted) == (profile == "zero3")
