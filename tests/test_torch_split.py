"""Split compute within a node on the gossip backend: a `TrainStep` on a
rank's shard (`repro_torch.launch.train.TrainStep.split`), each layer
gathered just in time (`repro_torch.models.gather`, `repro_torch.core.
flat.LayerCut`), the batch over the node's data group
(`repro_torch.sharding.batch`, `make_swarm_mesh(..., data=)`'s data
groups).

Worlds of `tests/torch_gossip_world.py`, gloo on the CPU:

  * ``split_units``: one node as (node, data, model) = (1, 2, 2): the
    gather Function on a node whose leaves the rules cut on the layer
    axis, an inner axis, both, a conv's kernel axis and none; one node's
    split step from the JAX package's params (converted) against
    `repro.launch.train.make_train_step` on the whole batch; a batch that
    2 data ranks do not divide against the opaque whole-node step; remat
    on against off; the whole layers, gradient and moments a step holds;
  * ``split_d1``: (2, 1, 2), the Mamba2 smoke session split against the
    same session with its step opaque (the whole-node gather) on the f32
    and int8 wires;
  * ``split_twin`` (2 unsharded ranks), ``split_d2`` (2, 2, 1) and
    ``split_d2m2`` (2, 2, 2, tensor-parallel over the model group since
    the model group divides each layer's work): the ssm, hybrid and moe
    smoke sessions
    (remat on: the MoE's batch means average over the data group in the
    recompute too), and on the two split worlds the data group's reduce
    of seeded cotangents of every unit onto the shard against an
    all_reduce of the whole cotangent then cut.

Held: the gather's forward bit for bit, its gradient within 1e-6 of the
data group's cotangents over D; with one data rank (or rows that do not
split) and one model rank the whole node's step bit for bit (with two
model ranks within the train-parity tolerances: the layer's work divides
over them and sums in another order); with two data ranks, the unsharded
session's gates and its params within the train-parity tolerances (rtol
1e-4, atol 1e-4 in f32), the JAX package's loss within rtol 1e-5 and
params within rtol 1e-4, atol 1e-4; no whole node's gradient or moments,
and with remat at most two whole layers alive; at D = 2 the reduce onto
the shard bit for bit, and its bytes by kind as the layout counts them."""
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
from repro_torch.core.flat import LayerCut, ShardLayout
from repro_torch.models import build_model
from repro_torch.sharding.rules import param_specs

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300
#: the train-parity tolerances (tests/test_torch_train.py)
PARAMS_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
#: AdamW's moments under tensor parallelism (the gradient summed in
#: another order), over their largest magnitude
MOMENT_REL = 1e-5


def _world(shape):
    n, d, m = shape
    return n * d * m


def _spawn(d, task, world, env):
    script = os.path.join(HERE, "torch_gossip_world.py")
    return [subprocess.Popen(
        [sys.executable, script, task, str(r), str(world),
         f"file://{d}/rdv_{task}", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs):
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log


def _jax_steps(arch, rng):
    """The JAX package's smoke ``arch`` from its own init: the flat params
    the port starts from, the batches, and SPLIT_JAX_STEPS steps' losses
    and params (test_torch_train's settings: lr 1e-4, no warmup)."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    jm = jbuild(jcfg)
    layout = build_model(smoke_variant(get_config(arch))).layout
    tree = jm.init(jax.random.key(0))
    flat = lm_params_from_reference(layout, jax.tree.map(np.asarray, tree))
    opt = jadamw_init(tree)
    step = jax.jit(jtrain.make_train_step(jm, JTrainConfig(
        lr=1e-4, warmup_steps=0, max_steps=10, remat=False)))
    toks = rng.integers(0, jcfg.vocab_size, (
        W.SPLIT_JAX_STEPS, W.SPLIT_JAX_BATCH, W.SPLIT_JAX_SEQ + 1))
    losses = []
    for k in range(W.SPLIT_JAX_STEPS):
        tree, opt, m = step(tree, opt, {
            "tokens": jnp.asarray(toks[k, :, :-1].astype(np.int32)),
            "labels": jnp.asarray(toks[k, :, 1:].astype(np.int32))})
        losses.append(float(m["loss"]))
    return ({"flat": flat.numpy(), "tokens": toks[..., :-1].astype(np.int64),
             "labels": toks[..., 1:].astype(np.int64)},
            {"loss": np.asarray(losses),
             "params": jax.tree.map(np.asarray, tree)})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every split world's ranks' outputs, and the JAX package's steps."""
    d = tmp_path_factory.mktemp("split")
    rng = np.random.default_rng(7)
    inputs, want = W.split_inputs(), {}
    for fam, arch in W.SPLIT_JAX:
        port, want[fam] = _jax_steps(arch, rng)
        inputs.update({f"jax/{fam}/{k}": v for k, v in port.items()})
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    sizes = {"split_units": _world(W.SPLIT_UNITS),
             "split_d1": _world(W.SPLIT_D1),
             "split_twin": W.SPLIT_NODES,
             "split_d2": _world(W.SPLIT_D2),
             "split_d2m2": _world(W.SPLIT_D2M2)}
    # two waves of at most 10 processes
    for wave in (("split_units", "split_d1", "split_twin"),
                 ("split_d2", "split_d2m2")):
        procs = []
        try:
            for task in wave:
                procs += _spawn(d, task, sizes[task], env)
        finally:
            _join(procs)
    out = {task: [dict(np.load(d / f"{task}_rank{r}.npz"))
                  for r in range(n)] for task, n in sizes.items()}
    out["jax"] = want
    return out


# ---------------------------------------------------------------------------
# the layer cut, without a process group
# ---------------------------------------------------------------------------

def _cut_shards(sizes):
    layout = W.split_layout()
    specs = param_specs(layout, dict(node=1, **sizes))
    g = int(np.prod(list(sizes.values())))
    coords = [ShardLayout(layout, specs, sizes, {}).coords_of(r)
              for r in range(g)]
    return layout, specs, [ShardLayout(layout, specs, sizes, c)
                           for c in coords]


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 2},
                                   {"data": 2, "model": 1},
                                   {"data": 1, "model": 2}])
def test_layer_cut_assembles_each_layer_from_every_ranks_blocks(sizes):
    """Each rank's contribution to layer i (its blocks, zeros where its
    span of the layer axis does not hold i) assembles into the node's
    layer i bit for bit, and every whole layer cuts back to the rank's
    blocks."""
    layout, _, shards = _cut_shards(sizes)
    node = torch.from_numpy(W.split_inputs()["node"])
    whole = layout.unflatten(node)
    stacked = [lf.path for lf in layout.leaves if lf.path.startswith("layers")]
    dtypes = {lf.path: torch.float32 for lf in layout.leaves}
    for i in range(W.SPLIT_L):
        parts = []
        for sh in shards:
            cut = LayerCut(sh, stacked, True, dtypes)
            views = sh.local.unflatten(sh.shard(node[None])[0])
            local = [views[p][cut.local_index(k, i)] if cut.holds(k, i)
                     else None for k, p in enumerate(stacked)]
            parts.append(cut.contribution(local, i, "cpu"))
        own = [views[p][cut.local_index(k, i)] if cut.holds(k, i)
               else None for k, p in enumerate(stacked)]
        got = cut.assemble(torch.stack(parts), i, own)
        for k, p in enumerate(stacked):
            assert torch.equal(got[k], whole[p][i]), (p, i)
        for sh in shards:
            cut = LayerCut(sh, stacked, True, dtypes)
            views = sh.local.unflatten(sh.shard(node[None])[0])
            for k, p in enumerate(stacked):
                if cut.holds(k, i):
                    assert torch.equal(cut.shard_of(k, got[k]),
                                       views[p][cut.local_index(k, i)])


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 2},
                                   {"data": 2, "model": 1}])
def test_owned_blocks_count_every_value_once(sizes):
    """The blocks the shard group's ranks own (the clipping norm's sum)
    cover the node's values exactly once."""
    layout, _, shards = _cut_shards(sizes)
    total = 0
    for sh in shards:
        total += sum(lf.size for lf in sh.local.leaves if sh.owns(lf.path))
    assert total == layout.n_values


# ---------------------------------------------------------------------------
# the gather Function
# ---------------------------------------------------------------------------

def test_gather_forward_equals_the_shard_layouts_gather(worlds):
    for r, out in enumerate(worlds["split_units"]):
        eq = out["gather/forward_equal"]
        assert eq.all() and eq.size == 2 + 3 * W.SPLIT_L, (r, eq)


def test_gather_gradient_is_the_data_groups_cotangents(worlds):
    """Each rank's gradient of Σ whole · cotangent: its block of the data
    group's cotangents summed and divided by D, within 1e-6."""
    ranks = worlds["split_units"]
    layout = W.split_layout()
    _, n_data, n_model = W.SPLIT_UNITS
    sizes = {"data": n_data, "model": n_model}
    specs = param_specs(layout, dict(node=1, **sizes))
    cots = [W.split_cotangents(r) for r in range(len(ranks))]
    for r, out in enumerate(ranks):
        d, m = out["gather/coords"]
        group = [dd * n_model + m for dd in range(n_data)]
        mean = {p: torch.from_numpy(sum(cots[g][p] for g in group) / n_data)
                for p, _ in W.SPLIT_LEAVES}
        want = ShardLayout(layout, specs, sizes,
                           {"data": int(d), "model": int(m)}).shard(
            layout.flatten(mean)[None])[0]
        np.testing.assert_allclose(out["gather/grad"], want.numpy(),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# one node's split step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", [f for f, _ in W.SPLIT_JAX])
def test_split_step_matches_the_jax_package(worlds, fam):
    """Two steps of one node as (data, model) = (2, 2), remat on, from the
    JAX package's params: the loss within rtol 1e-5, the params within
    rtol 1e-4, atol 1e-4 of `repro.launch.train.make_train_step` on the
    whole batch; every rank gathers the same node."""
    arch = dict(W.SPLIT_JAX)[fam]
    layout = build_model(smoke_variant(get_config(arch))).layout
    want = worlds["jax"][fam]
    ranks = worlds["split_units"]
    for out in ranks:
        np.testing.assert_allclose(out[f"jax/{fam}/loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(out[f"jax/{fam}/params"],
                                      ranks[0][f"jax/{fam}/params"])
    got = lm_params_to_reference(layout, torch.from_numpy(
        ranks[0][f"jax/{fam}/params"]))

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


def test_indivisible_batch_is_replicated_bit_for_bit(worlds):
    """3 rows over 2 data ranks stay whole on each: two split steps equal
    the whole node's (the opaque step). On this (1, 2, 2) world the model
    group divides each layer's work (tensor parallelism), which sums in
    another order: the params within the train-parity tolerances, the
    moments within 1e-5 of their largest magnitude, the loss within rtol
    1e-5 (bit for bit with one model rank: ``split_d2``'s sessions)."""
    for out in worlds["split_units"]:
        whole, split = out["odd/params"]
        np.testing.assert_allclose(split, whole, **PARAMS_TOL)
        for whole, split in out["odd/moments"]:
            np.testing.assert_allclose(
                split, whole, rtol=0, atol=MOMENT_REL * np.abs(whole).max())
        np.testing.assert_allclose(out["odd/loss"][1], out["odd/loss"][0],
                                   rtol=LOSS_RTOL)


def test_split_accumulation(worlds):
    """accum_steps = 2: 4 rows split over 2 data ranks (a microbatch of
    one row each) give the whole node's step (two microbatches of two) in
    its loss within rtol 1e-5 and its clipped gradient within 1e-6; 6 rows,
    which D · A = 4 does not divide, stay whole on each data rank and give
    it bit for bit."""
    for out in worlds["split_units"]:
        np.testing.assert_allclose(out["accum/4/loss"][1],
                                   out["accum/4/loss"][0], rtol=LOSS_RTOL)
        assert out["accum/4/grad_diff"] <= 1e-6
        whole, split = out["accum/6/params"]
        np.testing.assert_allclose(split, whole, **PARAMS_TOL)
        assert out["accum/6/grad_diff"] <= 1e-6
        np.testing.assert_allclose(out["accum/6/loss"][1],
                                   out["accum/6/loss"][0], rtol=LOSS_RTOL)


def test_split_remat_matches_remat_off(worlds):
    """One split step with remat (the layer gathered inside the checkpoint,
    again for the recompute) against one without: the loss bit for bit,
    the clipped gradient within 1e-6."""
    for out in worlds["split_units"]:
        assert out["remat/loss"][1] == out["remat/loss"][0]
        assert out["remat/grad_diff"] <= 1e-6


def test_a_split_step_holds_no_whole_node(worlds):
    """The gradient and moments a split step updates are the shard's; the
    largest whole cotangent a reduce takes is below a node's; with remat
    at most two whole layers are alive at once, without it every layer
    (the graph keeps them for the backward)."""
    for out in worlds["split_units"]:
        local, node = out["memory/local_values"], out["memory/node_values"]
        assert local < node
        for tag in ("remat", "plain"):
            assert out[f"memory/{tag}/grads"] == local
            assert out[f"memory/{tag}/mu"] == local
            assert 0 < out[f"memory/{tag}/largest_cotangent"] < node
        assert 1 <= out["memory/remat/peak_layers"] <= 2
        assert out["memory/plain/peak_layers"] == out["memory/n_layers"]


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", W.SPLIT_WIRES)
def test_one_data_rank_split_equals_the_whole_node_gather(worlds, wire):
    """(2, 1, 2), remat on: the TrainStep split, tensor-parallel over the
    model group, against the same session with the step in a lambda (the
    whole-node gather), after every round: the gates equal, the params
    within the train-parity tolerances, both moments within 1e-5 of their
    largest magnitude, the losses within rtol 1e-5."""
    for out in worlds["split_d1"]:
        for r in range(W.SPLIT_ROUNDS):
            split, whole = out[f"d1/{wire}/{r}/gates"]
            np.testing.assert_array_equal(split, whole)
            split, whole = out[f"d1/{wire}/{r}/params"]
            np.testing.assert_allclose(split, whole, **PARAMS_TOL)
            for name in ("mu", "nu"):
                split, whole = out[f"d1/{wire}/{r}/{name}"]
                np.testing.assert_allclose(
                    split, whole, rtol=0,
                    atol=MOMENT_REL * np.abs(whole).max(), err_msg=name)
            split, whole = out[f"d1/{wire}/{r}/loss"]
            np.testing.assert_allclose(split, whole, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", ["split_d2", "split_d2m2"])
@pytest.mark.parametrize("fam", [f for f, _ in W.SPLIT_ARCHS])
def test_two_data_ranks_match_the_unsharded_session(worlds, shape, fam):
    """Two nodes split over two data ranks (model 1 and 2) against two
    unsharded ranks: the gates equal every round, the node losses within
    rtol 1e-5, the params within the train-parity tolerances; every rank
    of a node gathers the same node."""
    twin, ranks = worlds["split_twin"], worlds[shape]
    assert not twin[0][f"{fam}/splits"]
    for out in ranks:
        assert out[f"{fam}/splits"]
        node = int(out["rows"][0])
        ref = twin[node]
        for r in range(W.SPLIT_ROUNDS):
            np.testing.assert_array_equal(out[f"{fam}/gates{r}"],
                                          ref[f"{fam}/gates{r}"])
            np.testing.assert_allclose(out[f"{fam}/loss{r}"],
                                       ref[f"{fam}/loss{r}"],
                                       rtol=LOSS_RTOL)
        np.testing.assert_allclose(out[f"{fam}/params"], ref[f"{fam}/params"],
                                   **PARAMS_TOL)
        first = next(o for o in ranks if int(o["rows"][0]) == node)
        np.testing.assert_array_equal(out[f"{fam}/params"],
                                      first[f"{fam}/params"])


def reduce_bytes(layout, specs, sizes, coords):
    """The bytes a rank at ``coords`` counts for one reduce of every unit
    (one split step's backward), by kind, from the specs and the shard's
    block shapes alone (:func:`torch_gossip_world.split_bytes`)."""
    sh = ShardLayout(layout, specs, sizes, coords)
    n_layers = next(lf.shape[0] for lf in layout.leaves
                    if lf.path.split(".")[0] == "layers")
    step, _ = W.split_bytes(sh, n_layers)
    return {k: v for k, v in step.items() if k.startswith("grad_")}


@pytest.mark.parametrize("shape", ["split_d2", "split_d2m2"])
def test_step_bytes_match_the_layout(worlds, shape):
    """A split step's counted bytes (remat on: each layer gathered for the
    forward and again for the recompute) against the layout. With one
    model rank (``split_d2``) the all_gathers hand each rank's
    contribution of the unit once and of every layer twice; the
    gradient's reduces over the data group hand over only the f32 blocks
    the group keeps (:func:`reduce_bytes`), less than the f32 whole of
    every unit that an all_reduce of each unit's whole cotangent hands.
    With two (``split_d2m2``, tensor parallelism) every kind equals
    `chip_smoke._tp_bytes`: the compute blocks' exchange, the gradient's
    way back to the stored blocks and the model group's activations, and
    no whole-layer gather or data-group reduce runs."""
    n, d, m = getattr(W, {"split_d2": "SPLIT_D2",
                          "split_d2m2": "SPLIT_D2M2"}[shape])
    sizes = {"data": d, "model": m}
    for fam, arch in W.SPLIT_ARCHS:
        layout = build_model(smoke_variant(get_config(arch))).layout
        specs = param_specs(layout, dict(node=n, **sizes))
        if m > 1:
            cfg = smoke_variant(get_config(arch))
            for out in worlds[shape]:
                coords = {"data": int(out["coords"][0]),
                          "model": int(out["coords"][1])}
                want, _ = W.tp_bytes(ShardLayout(layout, specs, sizes,
                                                 coords), cfg, cfg.n_layers,
                                     4, W.SPLIT_BATCH // d, W.SPLIT_SEQ,
                                     True)
                for kind, nbytes in want.items():
                    assert out.get(f"{fam}/step_bytes/{kind}", 0) == \
                        nbytes, (fam, kind)
                for kind in ("grad_reduce", "grad_reduce_scatter",
                             "grad_reduce_owner"):
                    assert f"{fam}/step_bytes/{kind}" not in out, kind
            continue
        sh = ShardLayout(layout, specs, sizes, {"data": 0, "model": 0})
        dtypes = {lf.path: torch.float32 for lf in layout.leaves}
        stacked = [lf.path for lf in layout.leaves
                   if lf.path.split(".")[0] == "layers"]
        unit = [lf.path for lf in layout.leaves if lf.path not in stacked]
        lc, uc = (LayerCut(sh, stacked, True, dtypes),
                  LayerCut(sh, unit, False, dtypes))
        n_layers = smoke_variant(get_config(arch)).n_layers
        gathered = uc.nbytes + 2 * n_layers * lc.nbytes
        for out in worlds[shape]:
            assert out[f"{fam}/step_bytes/layer_gather"] == gathered, fam
            coords = {"data": int(out["coords"][0]),
                      "model": int(out["coords"][1])}
            want = reduce_bytes(layout, specs, sizes, coords)
            for kind, nbytes in want.items():
                assert out.get(f"{fam}/step_bytes/{kind}", 0) == nbytes, \
                    (fam, kind)
            assert sum(want.values()) < 4 * layout.n_values, fam


@pytest.mark.parametrize("shape", ["split_d2", "split_d2m2"])
@pytest.mark.parametrize("fam", [f for f, _ in W.SPLIT_ARCHS])
def test_reduce_equals_all_reduce_then_cut(worlds, shape, fam):
    """D = 2: the data group's reduce of each unit's seeded cotangents
    (bf16, the wide leaves f32) gives each rank's blocks equal, bit for
    bit, to the whole-cotangent form on the same cotangents (the whole
    f32 cotangent all_reduced, divided by D, cut, rounded once); its
    bytes by kind are the layout's (:func:`reduce_bytes`)."""
    n, d, m = getattr(W, {"split_d2": "SPLIT_D2",
                          "split_d2m2": "SPLIT_D2M2"}[shape])
    sizes = {"data": d, "model": m}
    layout = build_model(smoke_variant(get_config(dict(W.SPLIT_ARCHS)[fam]))
                         ).layout
    specs = param_specs(layout, dict(node=n, **sizes))
    for out in worlds[shape]:
        eq = out[f"{fam}/reduce/equal"]
        assert eq.all() and eq.size > 1, eq
        coords = {"data": int(out["coords"][0]),
                  "model": int(out["coords"][1])}
        for kind, nbytes in reduce_bytes(layout, specs, sizes,
                                         coords).items():
            assert out.get(f"{fam}/reduce/bytes/{kind}", 0) == nbytes, kind


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 2},
                                   {"data": 2, "model": 1}])
def test_layer_cut_routes_each_leaf_by_its_data_cut(sizes):
    """Each leaf of :data:`SPLIT_LEAVES` goes the way the data axis cuts
    it: Mamba2's in_proj (``data`` on the layer axis) to the one data rank
    that holds the layer, the leaves ``data`` does not cut to an
    all_reduce of the rank's block, and within a data group every rank
    sorts every layer alike."""
    layout, _, shards = _cut_shards(sizes)
    stacked = [lf.path for lf in layout.leaves if lf.path.startswith("layers")]
    dtypes = {lf.path: torch.float32 for lf in layout.leaves}
    k_in = stacked.index("layers.ssm.in_proj.w")
    for sh in shards:
        cut = LayerCut(sh, stacked, True, dtypes)
        for i in range(W.SPLIT_L):
            scatter, owners, whole = cut.routes(i)
            assert not scatter
            owner = i // (W.SPLIT_L // sizes["data"])
            assert owners == {owner: [k_in]}, (i, owners)
            assert sorted(whole) == [k for k in range(len(stacked))
                                     if k != k_in]
            assert cut.holds(k_in, i) == (sh.coords["data"] == owner)
