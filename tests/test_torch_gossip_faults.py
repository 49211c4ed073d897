"""Checkpoints of a gossip session and the fault plane on the gossip
backend, on a world of 4 gloo ranks on the CPU (`tests/torch_gossip_world.py`
``faults``: a flat mesh and a 2 × 2 two-level mesh over the same ranks).

Checkpoints, for the f32, ring q8, gathered q8, psum q8 and both
hierarchical q8 wires: a save → load round trip is bit-identical, a resume
equals never stopping bit for bit, the file loads through the reference's
``repro.checkpointing.io.load_pytree`` into a template built from its own
``init_mesh_wire(..., mesh_shape=...)`` with the values the ranks held, and
``load_checkpoint_params`` of it gives the swarm's params.

The fault plane: the reference's gossip fault checks
(`tests/test_faults_spmd.py`, red on its forced devices) on the port,
against `repro.faults.oracle` — crash → whole-wire quarantine → rejoin
settling within 1e-5, the quarantine zeroing the whole mesh wire, a preempt
mid-plan bit-identical (flat and hierarchical), the quorum holding and
recovering, and an 8-round plan (crash, straggle, drop, corrupt lowered to
a drop) calling the train step once per local step: the port's
counterpart of the reference's zero retraces."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.faults.oracle as oracle
import torch_gossip_world as W
from repro.checkpointing.io import load_pytree as ref_load_pytree
from repro.core import gossip as ref_gossip
from repro.core.session import SwarmState as RefState
from repro_torch.convert import chunks_to_reference_tree, to_reference_tree
from repro_torch.core import gossip
from repro_torch.core.session import load_checkpoint_params

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 600
TOL = 1e-5

#: each case's schedule, as the cost model picks it
SCHEDULES = {"f32": "ring_ppermute", "ring_q8": "ring_topo_ppermute",
             "gathered_q8": "gathered_rows", "psum_q8": "fisher_psum_q8",
             "hier_fedavg_q8": "hier_fedavg_ring_q8",
             "hier_fisher_q8": "hier_fisher_ring_q8"}
_REPLICATED = ("/table", "/cons")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ``faults`` task on 4 gloo ranks; every rank's outputs, the
    replicated ones checked equal and taken once, the rest concatenated
    in rank order."""
    d = tmp_path_factory.mktemp("gossip_faults")
    np.savez(d / "inputs.npz", **W.faults_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "faults", str(r), str(W.N),
         f"file://{d}/rdv", str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(W.N)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [dict(np.load(d / f"faults_rank{r}.npz")) for r in range(W.N)]
    out = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        if (vals[0].ndim == 0 or key.endswith(("/gates", "/active", "/ok"))
                or key.startswith("plan/") or "/preempted" in key
                or any(r in key for r in _REPLICATED)):
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            out[key] = vals[0]
        else:
            out[key] = np.concatenate(vals)
    return out


@pytest.fixture(scope="module")
def inp():
    return W.faults_inputs()


# ---------------------------------------------------------------------------
# checkpoints of a gossip session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(W.CKPT))
def test_checkpoint_round_trip_and_resume(world, case):
    """save → load into a fresh session is bit-identical (params, AdamW
    moments, statistics, every mesh wire leaf, membership, rng,
    counters), and two more rounds from it equal two more rounds of the
    session never stopped, bit for bit."""
    pre = f"ckpt/{case}"
    assert str(world[f"{pre}/schedule"]) == SCHEDULES[case]
    assert bool(world[f"{pre}/roundtrip"])
    assert bool(world[f"{pre}/resume"])


def _ref_template(case, layout):
    """The reference's global ``SwarmState`` of a case, as a template: the
    params tree [N, ...] and its AdamW state and statistics, the mesh wire
    from the reference's own ``init_mesh_wire``."""
    topo, merge, wire, two = W.CKPT[case]
    zeros = to_reference_tree(layout, torch.zeros((W.N, layout.size)))
    wire_tree = None
    if wire == "int8":
        wire_tree = ref_gossip.init_mesh_wire(
            SCHEDULES[case], zeros, n_shards=W.N, wire_block=W.WB,
            mesh_shape=(2, 2) if two else None)
        wire_tree = jax.tree.map(np.asarray, wire_tree)
    return RefState(
        params=zeros,
        opt_state={"mu": zeros, "nu": zeros,
                   "count": np.zeros(W.N, np.int32)},
        stats=zeros if merge == "fisher" else None, wire=wire_tree,
        active=np.zeros(W.N, bool), rng=np.zeros(2, np.uint32),
        round=np.int32(0), step=np.int32(0))


def _wire_want(world, case, layout):
    """The wire the ranks held at the save, in the reference's layout:
    {keystr-like path: array}."""
    pre = f"ckpt/{case}/wire/"
    chunks = gossip.padded_grid(
        layout, W.WB, 2 if case.startswith("hier") else
        W.N if case == "psum_q8" else 1).leaf_chunks
    out = {}
    for key in [k for k in world if k.startswith(pre)]:
        rows = torch.from_numpy(world[key])
        path = tuple(key[len(pre):].split("/"))
        if path[0] == "cres" or case.startswith("hier"):
            tree = chunks_to_reference_tree(chunks, rows)
        else:
            tree = to_reference_tree(layout, rows)
        for leaf, a in tree.items():
            out[path + (leaf,)] = a
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("case", sorted(W.CKPT))
def test_checkpoint_is_the_reference_layout(world, case):
    """The file loads through the reference's ``load_pytree`` into a
    template of the reference's global state, its mesh wire from the
    reference's ``init_mesh_wire`` (the ring's [N, leaf] references, the
    gathered table once, the psum's [n_shards, leaf] references, its
    consensus once and its [n_shards, chunk] residuals, the hierarchical
    [N, chunk] delegate references): every value as the ranks held it at
    the save, and ``load_checkpoint_params`` of it is the swarm's params."""
    layout = W.session_layout()
    path = str(world[f"ckpt/{case}/path"])
    got = ref_load_pytree(path, _ref_template(case, layout))
    params = to_reference_tree(layout, torch.from_numpy(
        world[f"ckpt/{case}/params"]))
    for leaf, a in params.items():
        np.testing.assert_array_equal(np.asarray(got.params[leaf]), a)
    if W.CKPT[case][1] == "fisher":
        stats = to_reference_tree(layout, torch.from_numpy(
            world[f"ckpt/{case}/stats"]))
        for leaf, a in stats.items():
            np.testing.assert_array_equal(np.asarray(got.stats[leaf]), a)
    want = _wire_want(world, case, layout)
    assert (got.wire is None) == (not want)
    for p, a in want.items():
        np.testing.assert_array_equal(_get(got.wire, p), a, err_msg=str(p))
    n_leaves = len(jax.tree.leaves(got.wire))
    assert n_leaves == len(want)
    rows = load_checkpoint_params(path, torch.zeros((W.N, layout.size)),
                                  layout=layout, expect_nodes=W.N)
    np.testing.assert_array_equal(rows.numpy(), world[f"ckpt/{case}/params"])


# ---------------------------------------------------------------------------
# the fault plane on the gossip backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo,merge", [("ring", "fisher"), ("full",
                                                             "fedavg")])
def test_crash_rejoin_settles_to_oracle(world, inp, topo, merge):
    """Gates held closed through a 9-round plan with a crash of node 1 at
    round 1 and its rejoin at 3 (the whole mesh wire quarantined): the
    params stay w0 and node 1 is back; then one accepting round from that
    state commits the fault-free merge of `repro.faults.oracle` within
    1e-5."""
    pre = f"crash/{topo}/{merge}"
    assert str(world[f"{pre}/schedule"]) == (
        "ring_topo_ppermute" if topo == "ring" else "fedavg_psum_q8")
    assert not bool(world[f"{pre}/gates_any"])
    np.testing.assert_array_equal(world[f"{pre}/held"], inp["fw0"])
    assert world[f"{pre}/active"].all()
    assert world[f"{pre}/gates"].all()
    want = oracle.merge_candidate(inp["fw0"], np.ones(W.N, bool),
                                  merge=merge, topology=topo,
                                  data_sizes=[1.0] * W.N)
    np.testing.assert_allclose(world[f"{pre}/committed"], want, rtol=TOL,
                               atol=TOL)


def test_quarantine_resets_the_whole_mesh_wire(world):
    """On the mesh wire a quarantine is total: neighbour replicas must stay
    bit-identical to their senders' references, so every rank zeroes every
    leaf."""
    assert bool(world["quarantine/before"])
    assert not bool(world["quarantine/after"])


@pytest.mark.parametrize("tag,schedule", [
    ("flat", "ring_topo_ppermute"), ("hier_fedavg", "hier_fedavg_ring_q8"),
    ("hier_fisher", "hier_fisher_ring_q8")])
def test_preempt_mid_plan_is_bit_identical(world, tag, schedule):
    """A 6-round plan (node 2 crashed at round 1, back at 4) with a preempt
    at round 3 (save → ``make_session()`` → load, collectively) against
    the same plan without it: params, moments, statistics, every mesh
    wire leaf, rng and counters bit for bit, and the same gates."""
    pre = f"preempt/{tag}"
    assert str(world[f"{pre}/schedule"]) == schedule
    assert world[f"{pre}/preempted"].tolist() == [False] * 3 + [True] + \
        [False] * 2
    assert bool(world[f"{pre}/equal"])
    assert bool(world[f"{pre}/gates_equal"])
    assert np.isfinite(world[f"{pre}/params"]).all()


def test_quorum_holds_and_recovers(world, inp):
    """Two sites alive against a quorum of 3: every gate closes and the
    round holds the locals exactly; with three back the gates open for
    the active sites."""
    assert not world["quorum/low/gates"].any()
    assert not bool(world["quorum/low/ok"])
    np.testing.assert_array_equal(world["quorum/low/params"], inp["fw0"])
    assert bool(world["quorum/back/ok"])
    assert world["quorum/back/gates"].tolist() == [True, True, False, True]


def test_plan_calls_the_train_step_once_per_step(world):
    """crash / straggle / drop / corrupt over 8 rounds: the vmapped step
    runs once a local step (the eager counterpart of the reference's one
    compiled round), and the corrupt event lowers to a drop (no in-graph
    wire on the gossip backend): node 2 is out of round 6."""
    assert int(world["plan/calls"]) == int(world["plan/warm_calls"]) + 8
    active = world["plan/active"]
    assert not active[6, 2] and not active[5, 0] and not active[4, 3]
    assert not active[1, 1] and not active[2, 1] and active[3, 1]
    assert not world["plan/gates"][~active].any()
