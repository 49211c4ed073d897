"""The swarm gate through the split forward on the gossip backend: a
`SwarmEval` (`repro_torch.launch.train.make_swarm_eval`) passed as the
session's eval scores each node on a rank's shard, a layer gathered at a
time (`SwarmEval.split`, `core/engine.py::SwarmEngine._gate_scores`);
any other eval scores the node gathered whole.

One world of `tests/torch_gossip_world.py`, gloo on the CPU:
``split_gate``, (node, data, model) = (2, 2, 2), the Mamba2 smoke session
with its TrainStep split (tensor-parallel over the model group, as the
split gate), run once with the split gate and once with the eval in a
lambda, on each wire; then with every stacked leaf cut over
``data`` on its layer axis only (each layer held by one data rank: half of
a node's ranks hold no block of it), the step opaque.

Held: the gate bits, the committed params and both moments bit for bit
after every round; the metrics within 1e-6 relative (the split forward
divides each layer's work over the model group and sums in another
order than the whole node's); the
split gate's gathers counted as ``gate_gather`` and equal to the layout's
count, no ``shard_gather``; the opaque eval's whole-node gathers, no
``gate_gather``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_gossip_world as W
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.flat import ShardLayout
from repro_torch.launch.train import SwarmEval, make_swarm_eval
from repro_torch.models import build_model
from repro_torch.sharding.rules import param_specs

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 300
#: the metrics' relative tolerance where vmap over one node and the
#: plain call differ in their last bit
METRIC_RTOL = 1e-6


def _world():
    n, d, m = W.SPLIT_GATE
    return n * d * m


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's outputs of the ``split_gate`` world."""
    d = tmp_path_factory.mktemp("split_gate")
    np.savez(d / "inputs.npz", **W.split_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    world = _world()
    procs = [subprocess.Popen(
        [sys.executable, script, "split_gate", str(r), str(world),
         f"file://{d}/rdv_split_gate", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(d / f"split_gate_rank{r}.npz"))
            for r in range(world)]


def _layout():
    return build_model(smoke_variant(get_config("mamba2-370m"))).layout


def _shard(coords, specs=None):
    layout = _layout()
    n, d, m = W.SPLIT_GATE
    sizes = {"data": d, "model": m}
    if specs is None:
        specs = param_specs(layout, dict(node=n, **sizes))
    return ShardLayout(layout, specs, sizes,
                       {"data": int(coords[0]), "model": int(coords[1])})


@pytest.mark.spmd
@pytest.mark.parametrize("wire", W.SPLIT_WIRES)
def test_split_gate_equals_the_whole_node_gate(ranks, wire):
    """The split gate against the eval in a lambda (the whole-node
    gather), the step split: gates, params and both moments bit for bit
    after every round; the local and merged metrics within 1e-6
    relative."""
    for out in ranks:
        assert out[f"gate/{wire}/split_gate/1"]
        assert not out[f"gate/{wire}/split_gate/0"]
        for r in range(W.SPLIT_ROUNDS):
            eq = out[f"gate/{wire}/{r}/equal"]
            assert eq.all(), (wire, r, eq)
            split, whole = out[f"gate/{wire}/{r}/metrics"]
            np.testing.assert_allclose(split, whole, rtol=METRIC_RTOL,
                                       atol=0)


@pytest.mark.spmd
def test_split_gate_metrics_are_the_nodes_on_every_rank(ranks):
    """Every rank of a node reaches the same metrics through the split
    gate (the node's, gathered from the same bytes), and every rank of
    the swarm the same gate bits."""
    for wire in W.SPLIT_WIRES:
        for r in range(W.SPLIT_ROUNDS):
            first = ranks[0][f"gate/{wire}/{r}/metrics"][0]
            for out in ranks:
                np.testing.assert_array_equal(
                    out[f"gate/{wire}/{r}/metrics"][0], first)
                np.testing.assert_array_equal(
                    out[f"gate/{wire}/{r}/gates"],
                    ranks[0][f"gate/{wire}/{r}/gates"])


@pytest.mark.spmd
def test_split_gate_counts_its_layer_gathers(ranks):
    """A sync's split gate, tensor-parallel over the model group, sends
    the shard group the pieces of the other ranks' compute blocks of the
    unit and of every layer that this rank stores, twice (params,
    candidate), counted as ``gate_gather`` and equal to the layout's
    count (`chip_smoke._tp_bytes`); it gathers no node whole (no
    ``shard_gather``)."""
    cfg = smoke_variant(get_config("mamba2-370m"))
    for out in ranks:
        _, gate = W.tp_bytes(_shard(out["coords"]), cfg, cfg.n_layers, 4,
                             W.SPLIT_BATCH, W.SPLIT_SEQ, False,
                             val=(W.SPLIT_BATCH, W.SPLIT_SEQ))
        want = 2 * gate["gate_gather"]
        for wire in W.SPLIT_WIRES:
            for r in range(W.SPLIT_ROUNDS):
                assert out[f"gate/{wire}/{r}/split/gate_gather"] == want
                assert out[f"gate/{wire}/{r}/split/shard_gather"] == -1


@pytest.mark.spmd
def test_an_opaque_eval_still_gathers_the_node_whole(ranks):
    """The eval in a lambda has no split form: the session scores the
    node gathered whole, two all_gathers of the rank's slot shard a sync
    (``shard_gather``), and no ``gate_gather``."""
    for out in ranks:
        local = _shard(out["coords"]).local
        for wire in W.SPLIT_WIRES:
            for r in range(W.SPLIT_ROUNDS):
                assert out[f"gate/{wire}/{r}/whole/gate_gather"] == -1
                assert out[f"gate/{wire}/{r}/whole/shard_gather"] == \
                    2 * local.size * 4


@pytest.mark.spmd
def test_a_rank_without_a_layer_gets_through_the_split_gate(ranks):
    """Every stacked leaf cut over ``data`` on its layer axis only: the
    ranks of data index 0 hold no block of the last layer, those of 1
    none of the first. The split gate assembles those layers without
    autograd all the same; its gates, commits and moments equal the
    whole-node gate's bit for bit, its metrics within 1e-6."""
    empty = {int(out["coords"][0]): out["empty/layers"].tolist()
             for out in ranks}
    assert empty[0] and empty[1] and not set(empty[0]) & set(empty[1])
    for out in ranks:
        assert out["empty/split_gate/1"] and not out["empty/split_gate/0"]
        assert out["empty/0/equal"].all(), out["empty/0/equal"]
        split, whole = out["empty/0/metrics"]
        np.testing.assert_allclose(split, whole, rtol=METRIC_RTOL, atol=0)


def test_swarm_eval_is_the_vmapped_metric():
    """`make_swarm_eval(model)` on stacked nodes equals the closure the
    trainer used before it (vmap of 1 / (1 + loss)) bit for bit, and has
    a split form."""
    model = build_model(smoke_variant(get_config("mamba2-370m")))
    layout = model.layout
    ev = make_swarm_eval(model)
    assert isinstance(ev, SwarmEval) and callable(ev.split)
    gen = torch.Generator().manual_seed(0)
    params = torch.stack([model.init(gen, "cpu") for _ in range(2)])
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 2, 17)))
    val = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    want = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
        layout.unflatten(p), v, remat=False)[0]))(params, val)
    assert torch.equal(ev(params, val), want)
