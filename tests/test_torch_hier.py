"""The gossip backend's two-level ``("pod", "node")`` mesh
(`repro_torch.launch.mesh.make_two_level_swarm_mesh`) and its hierarchical
schedules (`repro_torch.core.gossip.hier_fedavg_ring_q8` /
``hier_fisher_ring_q8``) against the reference's.

One module-scoped world each, run side by side (`tests/torch_gossip_world.py`):

  * 4 gloo ranks as a 2 × 2 mesh: the schedules, the cost model's picks,
    gated sessions, the bytes each rank hands over by link class, the flat
    ring q8 over the joint axis, the refusals;
  * 6 gloo ranks as a 3 × 2 mesh (the two-sided pod ring): the schedules;
  * the reference on 4 and on 6 forced host devices (a process each): its
    schedules (the first sync op by op, as the port's runs: compiled, XLA
    rewrites some of its arithmetic and the references differ in the last
    bit) and, on 2 × 2, its engine's picks.

Held: merged values within 1e-6 after the first sync (rtol 1e-6 beside it)
and within 1e-5 after the sixth; the EF references (own pod and neighbour
pods) bit for bit after the first sync and within 1e-5 after the sixth;
the wire's keys; the settled merges
within 1e-5 of the numpy oracle of the pod-ring mix of pod aggregates
(the reference's ``pod_mix``). The reference's gossip sessions fail on its
forced devices, so the port's sessions are held against numpy oracles
(`repro.faults.oracle` for the flat forms)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.faults.oracle as oracle
import torch_gossip_world as W
from repro_torch.convert import to_reference_tree
from repro_torch.core import comms, gossip

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 600
TOL = 1e-5


def _spawn(d, task, world, env, init=True):
    script = os.path.join(HERE, "torch_gossip_world.py")
    ranks = range(world) if init else [0]
    return [subprocess.Popen(
        [sys.executable, script, task, str(r), str(world),
         f"file://{d}/rdv" if init else "-", str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in ranks]


def _assemble(outs):
    """Rank outputs → one: a rank's rows concatenated in rank order; what
    every rank holds alike (strings, picks, gates, flags) taken once
    after checking it is equal everywhere."""
    out = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        if "/counted/" in key:
            out[key] = np.stack(vals)
        elif vals[0].dtype.kind in "US" or vals[0].ndim == 0 \
                or key.endswith(("/gates", "/active")) \
                or "/predicted/" in key:
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            out[key] = vals[0]
        else:
            out[key] = np.concatenate(vals)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 2 × 2 and 3 × 2 gloo worlds and the reference, side by side;
    each process has its own timeout."""
    d4, d6, r4, r6 = (tmp_path_factory.mktemp(f"hier_{t}")
                      for t in ("world4", "world6", "ref4", "ref6"))
    inp = W.hier_inputs()
    for d in (d4, d6, r4, r6):
        np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")

    def renv(n):
        return dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}").strip())

    procs = (_spawn(d4, "hier", 4, env) + _spawn(d6, "hier", 6, env)
             + _spawn(r4, "hier_reference", 4, renv(4), init=False)
             + _spawn(r6, "hier_reference", 6, renv(6), init=False))
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    load = lambda d, r: dict(np.load(d / f"hier_rank{r}.npz"))
    return {"2x2": _assemble([load(d4, r) for r in range(4)]),
            "3x2": _assemble([load(d6, r) for r in range(6)]),
            "ref": {**np.load(r4 / "hier_reference_rank0.npz"),
                    **np.load(r6 / "hier_reference_rank0.npz")},
            "inp": inp}


def _pod_oracle(name, inp, k, per=2, sw=W.HIER_SW):
    """The settled hierarchical merge in float64: each pod's aggregate
    (fedavg: the weighted average; fisher: Σ (F+eps)⊙θ and Σ (F+eps)),
    mixed over the pod ring, one row a node (reference tree)."""
    n = k * per
    Wp = W.ring_matrix(k, sw)
    w = W.hier_weights(n).astype(np.float64)
    out = {}
    for leaf in W.HIER_REF:
        x = inp[f"x/{leaf}"][:n].astype(np.float64).reshape(n, -1)
        f = inp[f"f/{leaf}"][:n].astype(np.float64).reshape(n, -1) + 1e-8
        pods = [slice(q * per, (q + 1) * per) for q in range(k)]
        if name == "hier_fedavg_ring_q8":
            agg = np.stack([w[p] @ x[p] / w[p].sum() for p in pods])
            mix = Wp @ agg
        else:
            num = np.stack([(f[p] * x[p]).sum(0) for p in pods])
            den = np.stack([f[p].sum(0) for p in pods])
            mix = (Wp @ num) / (Wp @ den)
        out[leaf] = np.repeat(mix, per, 0).reshape(
            (n,) + W.HIER_REF[leaf])
    return out


def _chunk_tree(rows, k, per=2):
    """Assembled wire rows [N, C] → {leaf: [N, chunk]} by the grid's
    leaf chunks."""
    grid = gossip.padded_grid(W.hier_layout(), W.WB, per)
    return {path: rows[:, b:b + c] for path, b, c in grid.leaf_chunks}


MESHES = ["2x2", "3x2"]


@pytest.mark.parametrize("name", W.HIER)
@pytest.mark.parametrize("mesh", MESHES)
def test_hier_schedule_matches_reference(worlds, mesh, name):
    """Merged values after the first sync within 1e-6 of the reference's
    (rtol 1e-6), after the sixth within 1e-5; the wire's keys ({"ref",
    "left"} at two pods, "right" added at three); every EF reference bit
    for bit after the first sync and within 1e-5 after the sixth."""
    port, ref = worlds[mesh], worlds["ref"]
    k = int(mesh[0])
    pre = f"{mesh}/{name}"
    for sync, tol in ((1, 1e-6), (W.HIER_SYNCS, TOL)):
        tree = to_reference_tree(W.hier_layout(), torch.from_numpy(
            port[f"{name}/merged{sync}"]))
        for leaf in W.HIER_REF:
            np.testing.assert_allclose(tree[leaf],
                                       ref[f"{pre}/merged{sync}/{leaf}"],
                                       rtol=tol, atol=tol,
                                       err_msg=f"{pre} {sync} {leaf}")
        keys = sorted({key.split("/")[2] for key in port
                       if key.startswith(f"{name}/wire{sync}/")})
        want = ["left", "ref"] + (["right"] if k > 2 else [])
        assert keys == want, keys
        for key in [q for q in port if q.startswith(f"{name}/wire{sync}/")]:
            got = _chunk_tree(port[key], k)
            for leaf in W.HIER_REF:
                expect = ref[f"{mesh}/{key}/{leaf}"]
                if sync == 1:
                    np.testing.assert_array_equal(got[leaf], expect,
                                                  err_msg=f"{key}/{leaf}")
                else:
                    np.testing.assert_allclose(got[leaf], expect, rtol=TOL,
                                               atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", W.HIER)
@pytest.mark.parametrize("mesh", MESHES)
def test_hier_schedule_settles_to_pod_mix(worlds, mesh, name):
    """After six syncs on constant inputs (the pad path: neither leaf is a
    multiple of per_pod·wire_block) every node holds the pod-ring mix of
    the pod aggregates within 1e-5."""
    k = int(mesh[0])
    want = _pod_oracle(name, worlds["inp"], k)
    tree = to_reference_tree(W.hier_layout(), torch.from_numpy(
        worlds[mesh][f"{name}/merged{W.HIER_SYNCS}"]))
    for leaf in W.HIER_REF:
        np.testing.assert_allclose(tree[leaf], want[leaf], rtol=TOL,
                                   atol=TOL, err_msg=leaf)


@pytest.mark.parametrize("merge", ["fedavg", "fisher"])
@pytest.mark.parametrize("cross", W.CROSS)
def test_pick_matches_reference(worlds, merge, cross):
    """The cost model's pick on 2 × 2 equals the reference engine's: the
    flat ring forms at cross_pod_cost 1 and 5, the hierarchical ones at 6
    and 10."""
    got = str(worlds["2x2"][f"pick/{merge}/{cross:g}"])
    assert got == str(worlds["ref"][f"pick/{merge}/{cross:g}"])
    hier = f"hier_{merge}_ring_q8"
    flat = "ring_ppermute" if merge == "fedavg" else "ring_topo_ppermute"
    assert got == (hier if cross >= 6 else flat)


def test_flat_mesh_never_offers_hier(worlds):
    """A flat mesh never offers the hierarchical forms, however dear the
    cross-pod bytes: the cost model's candidates, and a gossip engine on
    the same four ranks as a flat mesh at cross_pod_cost 100."""
    cfg = W.hier_cfg("fedavg", cross=100.0)
    names = {s.name for s in comms.candidate_schedules(cfg, per=1)}
    assert not any(n.startswith("hier_") for n in names)
    assert comms.pick_schedule(cfg, per=1).name == "ring_ppermute"
    assert str(worlds["2x2"]["pick/flat_mesh"]) == "ring_ppermute"


def _w0():
    return W.hier_inputs()["w0"].astype(np.float64)


def _session_oracle(merge, cross):
    """The settled session commit in float64: the hierarchical forms'
    pod-ring mix of the pod aggregates (fedavg: the size-weighted pod
    averages; fisher with zero mass: the eps floor makes each a plain
    mean), or the flat ring merge (`repro.faults.oracle`)."""
    w0 = _w0()
    if cross < 6:
        return oracle.merge_candidate(w0, np.ones(W.N, bool), merge=merge,
                                      topology="ring", data_sizes=W.SIZES,
                                      self_weight=W.HIER_SW)
    sizes = np.asarray(W.SIZES) if merge == "fedavg" else np.ones(W.N)
    agg = np.stack([sizes[p] @ w0[p] / sizes[p].sum()
                    for p in (slice(0, 2), slice(2, 4))])
    return np.repeat(W.ring_matrix(2, W.HIER_SW) @ agg, 2, 0)


@pytest.mark.parametrize("merge", ["fedavg", "fisher"])
@pytest.mark.parametrize("cross", [10.0, 5.0])
def test_session_commit_matches_oracle(worlds, merge, cross):
    """A gossip session on 2 × 2 (sizes 1:2:3:4, self weight 0.7, D =
    1024, wire_block 128) through the settled regime: at cross_pod_cost
    10 it runs the hierarchical schedule and commits the pod-ring mix of
    the pod aggregates; at 5 the flat ring form over the joint axis and
    commits the ring merge; within 1e-5 either way, every gate open."""
    key = f"session/{merge}/{cross:g}"
    got = worlds["2x2"]
    want_sched = (f"hier_{merge}_ring_q8" if cross > 5 else
                  "ring_ppermute" if merge == "fedavg"
                  else "ring_topo_ppermute")
    assert str(got[f"{key}/schedule"]) == want_sched
    assert got[f"{key}/gates"].all()
    np.testing.assert_allclose(got[f"{key}/committed"],
                               _session_oracle(merge, cross), rtol=TOL,
                               atol=TOL)


def test_predicted_link_bytes(worlds):
    """``predicted_link_bytes`` of the hierarchical fedavg session on 2 ×
    2 at D = 1024, wire_block 128: intra 8·D (the pod reduce and gather in
    f32), cross 0.5·D·(1 + 4/WB) (half the payload in int8 with its
    scales)."""
    d = W.HIER_D
    got = {k: float(worlds["2x2"][f"session/fedavg/10/predicted/{k}"])
           for k in ("intra", "cross")}
    assert got == {"intra": 8 * d, "cross": 0.5 * d * (1 + 4 / W.WB)}


def _priced(world, key, link, per):
    """What a rank handed over on one link class in one sync, priced as
    the model prices a rank's traffic: a gathered tensor arrives from
    every rank of the group, a ring all_reduce moves 2(n−1)/n of its
    input (`tests/test_torch_gossip.py`)."""
    factor = {"ring": 1.0, "all_to_all": 1.0, "all_gather": float(per),
              "all_reduce": 2.0 * (per - 1) / per}
    out = []
    for r in range(W.N):
        out.append(sum(f * world[f"{key}/counted/{link}/{kind}"][r]
                       for kind, f in factor.items()
                       if f"{key}/counted/{link}/{kind}" in world))
    return np.asarray(out)


@pytest.mark.parametrize("merge", ["fedavg", "fisher"])
def test_counted_bytes_by_link_class(worlds, merge):
    """The bytes each rank hands over in a hierarchical sync against the
    cost model at the payload's width: cross (the pod ring) exactly;
    intra (the node group's all_reduce and all_gather) within the one
    scalar pod-mass all_reduce for fedavg. For fisher the model prices the
    all_gather of both streams and the schedule gathers their ratio (as
    the reference's does): intra is the model less one payload in f32.
    The flat ring q8 over the joint axis counts wholly cross, as the
    model prices it, and the hierarchical cross bytes are at most 0.35× its
    own."""
    world, d = worlds["2x2"], W.HIER_D
    key = f"session/{merge}/10"
    want = {k: float(world[f"{key}/predicted/{k}"]) for k in ("intra",
                                                              "cross")}
    np.testing.assert_array_equal(_priced(world, key, "cross", 2),
                                  want["cross"])
    scalar = 2.0 * (2 - 1) / 2 * 4
    intra = want["intra"] + scalar if merge == "fedavg" else \
        want["intra"] - 4 * d
    np.testing.assert_array_equal(_priced(world, key, "intra", 2), intra)
    flat = f"session/{merge}/5"
    assert (world[f"{flat}/counted/link/intra"] == 0).all()
    fcross = _priced(world, flat, "cross", W.N)
    np.testing.assert_array_equal(
        fcross, float(world[f"{flat}/predicted/cross"]))
    ratio = world[f"{key}/counted/link/cross"] / \
        world[f"{flat}/counted/link/cross"]
    assert (ratio <= 0.35).all(), ratio


def test_flat_ring_q8_on_the_joint_axis(worlds):
    """The flat ring q8 schedule over the two-level mesh's joint axis:
    after six syncs on constant inputs, ``W4 @ w0`` within 1e-5 (the
    reference's own check of this is red on its forced devices)."""
    want = W.ring_matrix(W.N) @ _w0()
    np.testing.assert_allclose(worlds["2x2"]["flat_ring_q8/merged"], want,
                               rtol=TOL, atol=TOL)


REFUSALS = {
    "refuse/world": "need 6 devices, have 4",
    "refuse/pods": "≥2 pods and ≥2 nodes per pod; got 1×4",
    "refuse/nodes": "≥2 pods and ≥2 nodes per pod; got 4×1",
    "refuse/rows": "one node per device",
    "refuse/inner": "does not support model-sharded payloads",
    "refuse/mesh_shape": "needs mesh_shape=(n_pods, per_pod)",
    "refuse/absent_pod": "fully-absent pod",
    "refuse/engine_inner": "two-level ('pod', 'node') mesh does not "
                           "support model-sharded payloads",
    "refuse/session_absent_pod/hier_fedavg_ring_q8": "pod(s) [0] have no "
                                                     "active node",
    "refuse/session_absent_pod/hier_fisher_ring_q8": "pod(s) [0] have no "
                                                     "active node",
}


@pytest.mark.parametrize("key", sorted(REFUSALS))
def test_refusals(worlds, key):
    """The reference's refusals (a world of the wrong size, fewer than 2
    pods or 2 nodes a pod, more than one node a rank, an inner spec, no
    mesh_shape for the wire), and the case it leaves out of scope, a pod
    with no active node, which raises here on every rank."""
    assert REFUSALS[key] in str(worlds["2x2"][key])
