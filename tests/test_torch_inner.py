"""Inner (model) sharding within a node on the gossip backend
(`repro_torch.launch.mesh.make_swarm_mesh(n, data=, model=)`,
`repro_torch.core.flat.ShardLayout`, ``SwarmSession(..., backend="gossip",
param_specs=...)``) against the reference's sharded schedules and against
the unsharded session.

Four worlds of `tests/torch_gossip_world.py`, run side by side:

  * ``inner``: 8 gloo ranks as 4 nodes × model 2, every flat schedule on
    the rank's shard of a payload of three leaves (a conv cut on its output
    axis, a plain leaf replicated, a scan-stacked ``[L, d, f]`` leaf with
    Mamba2's in_proj spec), the engine's picks with the specs and the
    refusals;
  * ``inner_reference``: the reference's schedule functions with
    ``inner_specs`` on 8 forced host devices as a ``("node", "model")`` =
    (4, 2) mesh (the first q8 sync op by op: compiled, XLA may contract
    the EF advance into one rounding), its psum-q8 refusals and its cost
    model's picks with ``model_sharded=True``;
  * ``inner_twin``: 2 gloo ranks, one whole node each, and then
  * ``inner_sessions``: 4 gloo ranks as 2 nodes × model 2, the same
    sessions with param specs (the TINY CNN with explicit specs, the
    Mamba2 smoke model with the rules' specs), the CNN's first int8 sync,
    checkpoints loaded across, and `run_plan` on a sharded session.

Held: merged values within 1e-6 of the reference's after the first sync
and the third, the first sync's EF references bit for bit (within 1e-6
after the third), every rank's bytes against the cost model at the shard's
width; f32 sessions, their gates (alike on both ranks of a node) and the
checkpoint file bit for bit against the unsharded twin; the int8 commit
within 1e-5 of an f64 oracle of the per-shard block grid (the blocks
quantized in f32 as the reference's core does); the crash → rejoin
settling within 1e-5 of `repro.faults.oracle`; a preempt bit-identical."""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.faults.oracle as oracle
import torch_gossip_world as W
from repro_torch.configs.base import SwarmConfig
from repro_torch.convert import to_reference_tree
from repro_torch.core import comms, gossip
from repro_torch.core.flat import FlatLayout
from repro_torch.experiments import histo

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 600
MERGE_TOL = 1e-6
TOL = 1e-5
WORLD = W.INNER_NODES * W.INNER_MODEL

F32 = ["fedavg_gossip", "fisher_gossip", "ring_gossip",
       "topo_fisher_gossip_f32", "topo_fisher_gossip_bf16",
       "matrix_gossip_f32", "matrix_gossip_bf16", "ring_rows_gossip_f32",
       "ring_rows_gossip_bf16", "ring_topo_fisher_gossip_f32",
       "ring_topo_fisher_gossip_bf16"]
Q8 = ["ring_rows_gossip_q8", "ring_topo_fisher_gossip_q8",
      "matrix_gossip_q8", "topo_fisher_gossip_q8"]
#: each function's schedule and the config that prices it
SCHEDULES = {
    "fedavg_gossip": ("fedavg_psum", "full", "fedavg", "f32"),
    "fisher_gossip": ("fisher_psum", "full", "fisher", "f32"),
    "ring_gossip": ("ring_ppermute", "ring", "fedavg", "f32"),
    "ring_rows_gossip_f32": ("ring_ppermute", "ring", "fedavg", "f32"),
    "ring_rows_gossip_bf16": ("ring_ppermute", "ring", "fedavg", "bf16"),
    "ring_topo_fisher_gossip_f32": ("ring_topo_ppermute", "ring", "fisher",
                                    "f32"),
    "ring_topo_fisher_gossip_bf16": ("ring_topo_ppermute", "ring", "fisher",
                                     "bf16"),
    "matrix_gossip_f32": ("gathered_rows", "dynamic", "fedavg", "f32"),
    "matrix_gossip_bf16": ("gathered_rows", "dynamic", "fedavg", "bf16"),
    "topo_fisher_gossip_f32": ("gathered_topo_stack", "ring", "fisher",
                               "f32"),
    "topo_fisher_gossip_bf16": ("gathered_topo_stack", "ring", "fisher",
                                "bf16"),
    "ring_rows_gossip_q8": ("ring_ppermute", "ring", "fedavg", "int8"),
    "ring_topo_fisher_gossip_q8": ("ring_topo_ppermute", "ring", "fisher",
                                   "int8"),
    "matrix_gossip_q8": ("gathered_rows", "dynamic", "fedavg", "int8"),
    "topo_fisher_gossip_q8": ("gathered_topo_stack", "ring", "fisher",
                              "int8"),
}


def _spawn(d, task, world, env):
    script = os.path.join(HERE, "torch_gossip_world.py")
    init = "-" if task.endswith("reference") else f"file://{d}/rdv_{task}"
    ranks = [0] if task.endswith("reference") else range(world)
    return [subprocess.Popen(
        [sys.executable, script, task, str(r), str(world), init, str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in ranks]


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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The four worlds (the sharded sessions after their twin, whose
    checkpoint they load); each rank's outputs as a list."""
    d = tmp_path_factory.mktemp("inner")
    np.savez(d / "inputs.npz",
             **W.schedule_inputs(W.INNER_NODES, shapes=W.INNER_REF),
             **W.inner_session_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    renv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={WORLD}").strip())
    sched = (_spawn(d, "inner", WORLD, env)
             + _spawn(d, "inner_reference", WORLD, renv))
    try:
        _join(_spawn(d, "inner_twin", W.INNER_SESSION_NODES, env))
        _join(_spawn(d, "inner_sessions", 2 * W.INNER_SESSION_NODES, env))
    finally:
        _join(sched)

    def load(task, n):
        return [dict(np.load(d / f"{task}_rank{r}.npz")) for r in range(n)]

    return {"inner": load("inner", WORLD),
            "reference": load("inner_reference", 1)[0],
            "twin": load("inner_twin", W.INNER_SESSION_NODES),
            "sessions": load("inner_sessions", 2 * W.INNER_SESSION_NODES),
            "dir": d}


def _node_rows(ranks, key):
    """A key's whole-node rows from the model-0 rank of every node, after
    checking the node's other rank holds the same bits (a replicated
    table once)."""
    for a, b in zip(ranks[0::2], ranks[1::2]):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    if "/table" in key:
        for r in ranks[2::2]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
        return ranks[0][key]
    return np.concatenate([r[key] for r in ranks[0::2]])


def _against(worlds, key, tol, exact=False):
    lay = W.inner_layout()
    tree = to_reference_tree(lay, torch.from_numpy(
        _node_rows(worlds["inner"], key)))
    for leaf in W.INNER_REF:
        want = worlds["reference"][f"{key}/{leaf}"]
        if exact:
            np.testing.assert_array_equal(tree[leaf], want,
                                          err_msg=f"{key}/{leaf}")
        else:
            np.testing.assert_allclose(tree[leaf], want, rtol=tol, atol=tol,
                                       err_msg=f"{key}/{leaf}")


def test_mesh_rows_coords_and_shard(worlds):
    """Rank (i·D + d)·M + m holds block (d, m) of node i; the shard holds
    the conv's half (its output axis cut), the plain leaf whole and the
    [L, d, f] leaf's half (d over model)."""
    for r, out in enumerate(worlds["inner"]):
        assert out["mesh/coords"].tolist() == [0, r % W.INNER_MODEL]
        assert out["mesh/rows"].tolist() == [r // 2, r // 2 + 1]
        assert int(out["mesh/local_size"]) == 54 + 200 + 240


@pytest.mark.parametrize("case", F32)
def test_merged_matches_reference(worlds, case):
    """The f32 / bf16 schedules on the rank's shard against the
    reference's with ``inner_specs``: within 1e-6."""
    _against(worlds, f"{case}/merged", MERGE_TOL)


@pytest.mark.parametrize("case", Q8)
def test_q8_on_the_per_shard_grid(worlds, case):
    """The int8 EF forms on the shard's own block grid: merged within 1e-6
    after the first and the third sync; the EF references (own,
    neighbour replicas, the gathered table) bit for bit after the first
    sync and within 1e-6 after the third."""
    port = worlds["inner"][0]
    for k, tag in ((1, ""), (3, "3")):
        _against(worlds, f"{case}/merged{tag}", MERGE_TOL)
        keys = [key for key in port if key.startswith(f"{case}/wire{k}/")]
        assert keys
        for key in keys:
            _against(worlds, key, MERGE_TOL, exact=k == 1)


def test_ring_q8_telescopes_on_shards(worlds):
    """On constant inputs the sharded ring q8's reference residual shrinks
    sync over sync, and every neighbour replica equals its sender's
    reference."""
    res = np.stack([r["telescope/residual"] for r in worlds["inner"]])
    assert (np.diff(res, axis=1) <= 0).all() and res[:, -1].max() < 1e-2
    ref = _node_rows(worlds["inner"], "telescope/wire/ref")
    left = _node_rows(worlds["inner"], "telescope/wire/left")
    right = _node_rows(worlds["inner"], "telescope/wire/right")
    np.testing.assert_array_equal(left, np.roll(ref, 1, axis=0))
    np.testing.assert_array_equal(right, np.roll(ref, -1, axis=0))


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_counted_bytes_are_the_shards(worlds, case):
    """What each rank hands to the collectives in one sync: the cost
    model's bytes at the shard's width (its values; for int8 its per-leaf
    padded grid), priced as `tests/test_torch_gossip.py` prices them."""
    name, topo, merge, wd = SCHEDULES[case]
    n = W.INNER_NODES
    cfg = SwarmConfig(n_nodes=n, topology=topo, merge=merge, lora_only=False,
                      wire_dtype=wd, wire_block=W.WB)
    sched = next(s for s in comms.candidate_schedules(
        cfg, model_sharded=True) if s.name == name)
    local = FlatLayout([("a", (2, 3, 3, 3)), ("b", (200,)), ("c", (3, 8, 10))],
                       convs=["a"])
    width = (gossip.padded_grid(local, W.WB).padded if wd == "int8"
             else local.size)
    factor = {"ring": 1.0, "all_to_all": 1.0, "all_gather": float(n),
              "all_reduce": 2.0 * (n - 1) / n}
    want = sched.bytes_by_link_class(width)
    for r, port in enumerate(worlds["inner"]):
        counted = sum(f * port[f"{case}/bytes/{kind}"]
                      for kind, f in factor.items()
                      if f"{case}/bytes/{kind}" in port)
        assert counted == pytest.approx(want["intra"], rel=1e-12), (
            case, r, counted, want)


@pytest.mark.parametrize("name", ["fedavg_psum_q8", "fisher_psum_q8"])
def test_psum_q8_refuse_inner_specs_in_the_references_words(worlds, name):
    key = f"refuse/{name}"
    assert "does not support model-sharded payloads" in str(
        worlds["inner"][0][key])
    assert str(worlds["inner"][0][key]) == str(worlds["reference"][key])


@pytest.mark.parametrize("merge,topo,wire", W.INNER_PICKS)
def test_picks_match_reference_model_sharded(worlds, merge, topo, wire):
    """The engine with the specs picks what the reference's cost model
    picks with ``model_sharded=True``: never a q8 psum."""
    key = f"pick/{merge}/{topo}/{wire}"
    got = {str(r[key]) for r in worlds["inner"]}
    assert got == {str(worlds["reference"][key])}
    assert not got.pop().endswith("psum_q8")


def test_swarm_sync_step_with_specs(worlds):
    """``make_swarm_sync_step(..., param_specs=)``: propose on the rank's
    shard (mean on the ring) equals the reference's sharded ring rows
    within 1e-6."""
    lay = W.inner_layout()
    tree = to_reference_tree(lay, torch.from_numpy(
        _node_rows(worlds["inner"], "sync_step/candidate")))
    for leaf in W.INNER_REF:
        np.testing.assert_allclose(
            tree[leaf], worlds["reference"][f"ring_rows_gossip_f32/merged/"
                                            f"{leaf}"],
            rtol=MERGE_TOL, atol=MERGE_TOL, err_msg=leaf)


def test_engine_refusals(worlds):
    """An inner spec names the data and model axes, and needs the
    params' layout."""
    out = worlds["inner"][0]
    assert "param_specs name ['pod']" in str(out["refuse/engine_axis"])
    assert "need the params' layout" in str(out["refuse/engine_layout"])


# ---------------------------------------------------------------------------
# sessions: 2 nodes × model 2 against 2 unsharded ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["cnn", "lm"])
def test_f32_session_equals_unsharded_bit_for_bit(worlds, model):
    """INNER_ROUNDS rounds of real steps on the f32 wire (fedavg, full:
    ``fedavg_psum``): the whole node's params after each sharded rank
    gathers them equal the unsharded twin's bit for bit (the Mamba2 smoke
    model's bf16 slots compared as int16), each round's gates and merged
    metrics too, alike on both ranks of a node; a rank holds about half
    the slots, and hands over about half the bytes."""
    sh, tw = worlds["sessions"], worlds["twin"]
    for out in sh + tw:
        assert str(out[f"{model}/schedule"]) == "fedavg_psum"
    np.testing.assert_array_equal(_node_rows(sh, f"{model}/params"),
                                  np.concatenate([t[f"{model}/params"]
                                                  for t in tw]))
    for r in range(W.INNER_ROUNDS):
        for key in (f"{model}/gates{r}", f"{model}/metric{r}"):
            for out in sh:
                np.testing.assert_array_equal(out[key], tw[0][key],
                                              err_msg=key)
    full = int(tw[0][f"{model}/slots"])
    local = int(sh[0][f"{model}/slots"])
    assert all(int(o[f"{model}/slots"]) == local for o in sh)
    assert 0.5 <= local / full < 0.52
    ratio = int(sh[0][f"{model}/sync_bytes"]) / int(
        tw[0][f"{model}/sync_bytes"])
    assert 0.5 <= ratio < 0.52, ratio


def _ref_leaves(lay, rows):
    """``{path: [N, *reference shape]}`` of stored rows [N, P] (a conv
    HWIO)."""
    views = lay.unflatten(torch.from_numpy(rows))
    return {lf.path: np.transpose(views[lf.path].numpy(),
                                  (0,) + tuple(1 + a for a in lf.ref_axes))
            for lf in lay.leaves}


def _q8_oracle(pre, lay, specs, weights):
    """The first int8 fedavg sync of ``pre`` [N, P] (zero wire tables) on
    the per-shard block grid, in f64: each node's leaves cut into the
    (model 2) blocks of ``specs`` along the reference's axes, each block
    flattened, zero-padded to whole wire blocks and quantized in f32 as
    the reference's core does (scale max|v|/127, round half to even);
    the merge Σ_j w_j deq_j of the blocks in f64. Returns ``{path: [N,
    *reference shape]}``."""
    out = {}
    for path, a in _ref_leaves(lay, pre).items():
        spec = specs.get(path) or ()
        cut = [k for k, ax in enumerate(spec) if ax == "model"
               and a.shape[1 + k] % 2 == 0]
        merged = np.zeros(a.shape, np.float64)
        for m in range(2 if cut else 1):
            idx = [slice(None)] * a.ndim
            for k in cut:
                half = a.shape[1 + k] // 2
                idx[1 + k] = slice(m * half, (m + 1) * half)
            block = a[tuple(idx)].reshape(a.shape[0], -1).astype(np.float32)
            d = block.shape[1]
            pad = (-d) % W.WB
            v = np.pad(block, ((0, 0), (0, pad))).reshape(
                a.shape[0], -1, W.WB)
            scale = (np.abs(v).max(-1, keepdims=True)
                     / np.float32(127.0)).astype(np.float32)
            q = np.clip(np.round(v / np.where(scale > 0, scale,
                                              np.float32(1.0))),
                        -127, 127).astype(np.float32)
            deq = (q * scale).reshape(a.shape[0], -1)[:, :d]
            mix = np.asarray(weights, np.float64) @ deq.astype(np.float64)
            merged[tuple(idx)] = np.broadcast_to(
                mix, (a.shape[0],) + mix.shape).reshape(
                merged[tuple(idx)].shape)
        out[path] = merged
    return out


def test_int8_first_sync_on_the_per_shard_grid(worlds):
    """The CNN's first int8 sync (the q8 psums drop out: ``gathered_rows``)
    from its local steps' params: every accepted node within 1e-5 of the
    f64 oracle of the per-shard grid, a rejected one its own params bit
    for bit."""
    sh = worlds["sessions"]
    assert {str(o["int8/schedule"]) for o in sh} == {"gathered_rows"}
    model = histo._model(histo.HistoExperimentConfig(**W.INNER_CNN))
    lay = FlatLayout.of_module(model)
    pre = _node_rows(sh, "int8/pre")
    post = _node_rows(sh, "int8/post")
    gates = sh[0]["int8/gates"]
    for out in sh:
        np.testing.assert_array_equal(out["int8/gates"], gates)
    w = np.asarray(W.INNER_SIZES) / np.sum(W.INNER_SIZES)
    want = _q8_oracle(pre, lay, W.cnn_specs(lay), w)
    got, have = _ref_leaves(lay, post), _ref_leaves(lay, pre)
    assert gates.any()
    for path in want:
        for i, g in enumerate(gates):
            if g:
                np.testing.assert_allclose(got[path][i], want[path][i],
                                           rtol=TOL, atol=TOL,
                                           err_msg=path)
            else:
                np.testing.assert_array_equal(got[path][i], have[path][i])


def test_checkpoint_equals_unsharded_file_and_loads_across(worlds):
    """The sharded CNN session's file equals the unsharded twin's byte for
    byte; the twin's file loaded into a fresh sharded session gives the
    sharded session's state bit for bit, and the sharded file loaded into
    a whole-node session on the same ranks its gathered params."""
    d = worlds["dir"]
    assert filecmp.cmp(d / "inner_ckpt_twin.msgpack",
                       d / "inner_ckpt_sharded.msgpack", shallow=False)
    for out in worlds["sessions"]:
        assert bool(out["load/twin_into_sharded"])
        assert bool(out["load/sharded_into_whole"])
    np.testing.assert_array_equal(
        _node_rows(worlds["sessions"], "load/whole_params"),
        np.concatenate([t["cnn/params"] for t in worlds["twin"]]))


@pytest.mark.parametrize("topo,merge", [("ring", "fisher"),
                                        ("full", "fedavg")])
def test_fault_plane_crash_rejoin_settles_to_oracle(worlds, topo, merge):
    """`run_plan` on an inner-sharded session on the int8 wire: gates held
    closed through a crash of node 1 at round 1 and its rejoin at 3 (the
    whole mesh wire quarantined), then one accepting round commits the
    fault-free merge of `repro.faults.oracle` within 1e-5."""
    pre = f"fault/crash/{topo}/{merge}"
    sh = worlds["sessions"]
    assert {str(o[f"{pre}/schedule"]) for o in sh} == {
        "gathered_topo_stack" if merge == "fisher" else "gathered_rows"}
    assert not any(bool(o[f"{pre}/gates_any"]) for o in sh)
    assert all(o[f"{pre}/gates"].all() for o in sh)
    w0 = W.inner_session_inputs()["fw0"]
    want = oracle.merge_candidate(w0, np.ones(len(w0), bool), merge=merge,
                                  topology=topo, data_sizes=[1.0] * len(w0))
    np.testing.assert_allclose(_node_rows(sh, f"{pre}/committed"), want,
                               rtol=TOL, atol=TOL)


def test_fault_plane_preempt_is_bit_identical(worlds):
    """A preempt mid-plan (collective save → fresh sharded session → load)
    replays bit for bit the same plan without it: state and gates."""
    for out in worlds["sessions"]:
        assert bool(out["fault/preempt/equal"])
        assert bool(out["fault/preempt/gates_equal"])
        assert out["fault/preempt/preempted"].tolist() == [
            i == 3 for i in range(6)]
