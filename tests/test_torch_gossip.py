"""The port's gossip schedules (`repro_torch.core.gossip`, torch.distributed
on gloo) against the reference's (`repro.core.gossip`, shard_map), one
schedule at a time, on the same seeded inputs: a payload of two leaves (a
conv, stored OIHW, HWIO in the reference, and a plain leaf; neither a
multiple of ``wire_block`` = 128).

  * a world of 1 (an in-process gloo group, 4 nodes a rank) against the
    reference on a 1-device mesh;
  * a world of 4 (4 gloo processes on the CPU, one node each) against the
    reference on 4 forced host devices (one subprocess; its psum forms run
    inside ``jax.set_mesh``).

Held: merged values within the reference's tolerance (rtol 1e-5, atol
1e-6, `tests/test_gossip_spmd.py`); the int8 EF references (``ref``,
``left``, ``right``, ``table``) bit for bit after the first sync (the shared
quant core's output on equal inputs; the reference's first sync runs op by
op, as the port's wire tests compare it, because XLA's fusion under jit
may contract the advance θ̂ + q·s into one rounding), and within the
tolerance after the third (its later syncs are compiled); the psum-q8
consensus ``cons`` and chunk residual ``cres`` within the same tolerance
(their chunk sums add in another order); the EF residual telescoping over
5 syncs with neighbour replicas equal to their senders' references; and the
bytes each rank hands to the collectives against the cost model
(`SyncSchedule.bytes_by_link_class`)."""
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_gossip_world as W
from repro_torch.configs.base import SwarmConfig
from repro_torch.convert import to_reference_tree
from repro_torch.core import comms, gossip
from repro_torch.launch.mesh import (make_production_mesh, make_swarm_mesh)

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
TIMEOUT = 600
RTOL, ATOL = 1e-5, 1e-6

F32_ALL = ["fedavg_gossip", "fisher_gossip", "topo_fisher_gossip_f32",
           "topo_fisher_gossip_bf16", "matrix_gossip_f32",
           "matrix_gossip_bf16"]
F32_RING = ["ring_gossip", "ring_rows_gossip_f32", "ring_rows_gossip_bf16",
            "ring_topo_fisher_gossip_f32", "ring_topo_fisher_gossip_bf16"]
Q8_ALL = ["matrix_gossip_q8", "topo_fisher_gossip_q8", "fedavg_psum_q8",
          "fisher_psum_q8"]
Q8_RING = ["ring_rows_gossip_q8", "ring_topo_fisher_gossip_q8"]


def _replicated(key):
    return "/table" in key or "/cons" in key


def _assemble(ranks):
    """The ranks' outputs as one: rows concatenated in rank order, a
    replicated tensor (a table, the consensus) taken once after checking
    every rank holds the same bits."""
    out = {}
    for key in ranks[0]:
        vals = [r[key] for r in ranks]
        if _replicated(key):
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            out[key] = vals[0]
        elif "/bytes/" in key or key.startswith(("telescope/residual",
                                                  "mesh/")):
            out[key] = np.stack(vals)
        else:
            out[key] = np.concatenate(vals)
    return out


@pytest.fixture(scope="module")
def world1():
    """The port in an in-process gloo group of one rank (4 nodes), the
    reference on a 1-device mesh, same inputs."""
    inp = W.schedule_inputs(W.N)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh, _ = make_swarm_mesh(W.N)
            port = W.port_schedules(mesh, inp)
        finally:
            dist.destroy_process_group()
    ref = W.reference_schedules(jax.make_mesh((1,), ("node",)), inp)
    return port, ref, 1


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """4 gloo ranks on the CPU (one node each) and the reference on 4 forced
    host devices, run side by side; each process has its own timeout."""
    d = tmp_path_factory.mktemp("gossip_world4")
    np.savez(d / "inputs.npz", **W.schedule_inputs(W.N))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    init = f"file://{d}/rdv"
    procs = [subprocess.Popen(
        [sys.executable, script, "schedules", str(r), str(WORLD), init,
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    renv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={WORLD}").strip())
    procs.append(subprocess.Popen(
        [sys.executable, script, "reference", "0", str(WORLD), "-", str(d)],
        env=renv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(d / f"schedules_rank{r}.npz"))
             for r in range(WORLD)]
    ref = dict(np.load(d / "reference_rank0.npz"))
    return _assemble(ranks), ref, WORLD


@pytest.fixture(params=[1, WORLD], ids=["world1", "world4"])
def world(request, world1, world4):
    return world1 if request.param == 1 else world4


def _tree(port_rows):
    return to_reference_tree(W.layout(), torch.from_numpy(port_rows))


def _close(port_rows, ref, key):
    tree = _tree(port_rows)
    for leaf in W.REF_SHAPES:
        np.testing.assert_allclose(tree[leaf], ref[f"{key}/{leaf}"],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{key}/{leaf}")


def _cases(ring_too):
    return F32_ALL + (F32_RING if ring_too else [])


@pytest.mark.parametrize("case", F32_ALL + F32_RING)
def test_merged_matches_reference(world, case):
    """f32 / bf16 schedules: each rank's merged rows against the
    reference's within rtol 1e-5, atol 1e-6."""
    port, ref, n = world
    if case not in _cases(n >= 3):
        with pytest.raises(KeyError):
            port[f"{case}/merged"]
        return
    _close(port[f"{case}/merged"], ref, f"{case}/merged")


def _wire_keys(port, case, k):
    pre = f"{case}/wire{k}/"
    return [key for key in port if key.startswith(pre)]


@pytest.mark.parametrize("case", Q8_ALL + Q8_RING)
def test_q8_wire_matches_reference(world, case):
    """The int8 EF forms after the first and the third sync on the same
    inputs: merged within tolerance, the EF references bit for bit after
    the first (within tolerance after the third), the psum consensus and
    chunk residual within tolerance."""
    port, ref, n = world
    if case in Q8_RING and n < 3:
        assert f"{case}/merged" not in port
        return
    lay = W.layout()
    chunks = gossip.padded_grid(lay, W.WB, n).leaf_chunks
    for k, tag in ((1, ""), (3, "3")):
        _close(port[f"{case}/merged{tag}"], ref, f"{case}/merged{tag}")
        keys = _wire_keys(port, case, k)
        assert keys
        for key in keys:
            if "/cres" in key:
                for path, base, chunk in chunks:
                    np.testing.assert_allclose(
                        port[key][:, base:base + chunk], ref[f"{key}/{path}"],
                        rtol=RTOL, atol=ATOL, err_msg=key)
            elif "/cons" in key or k == 3:
                _close(port[key], ref, key)
            else:
                tree = _tree(port[key])
                for leaf in W.REF_SHAPES:
                    np.testing.assert_array_equal(
                        tree[leaf], ref[f"{key}/{leaf}"],
                        err_msg=f"{key}/{leaf}")


def test_ef_residual_telescopes(world4):
    """On constant inputs the mesh EF reference contracts geometrically
    toward the payload (the reference's `test_mesh_wire_spmd` check), and
    each neighbour replica equals its sender's own reference bit for
    bit."""
    port, _, n = world4
    res = port["telescope/residual"].max(0)
    for r in range(1, len(res)):
        assert res[r] <= res[r - 1] / 32 + 1e-9, res
    assert res[-1] < 1e-6, res
    ref = port["telescope/wire/ref"]
    np.testing.assert_array_equal(port["telescope/wire/left"],
                                  ref[np.roll(np.arange(n), 1)])
    np.testing.assert_array_equal(port["telescope/wire/right"],
                                  ref[np.roll(np.arange(n), -1)])


# the cost model's schedule of each case: (topology, merge, wire)
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
    "fedavg_psum_q8": ("fedavg_psum_q8", "full", "fedavg", "int8"),
    "fisher_psum_q8": ("fisher_psum_q8", "full", "fisher", "int8"),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_counted_bytes_match_cost_model(world4, case):
    """What a rank hands to the collectives in one sync, against
    ``SyncSchedule.bytes_by_link_class`` of the schedule. The model counts
    a rank's link traffic; the counts are the tensors handed over, so

        model = ring + all_to_all + N·all_gather + 2(N−1)/N·all_reduce

    (a gathered tensor arrives from every rank; a ring all_reduce moves
    2(N−1)/N of its input), each at the payload's width: A values for the
    f32 / bf16 forms, the padded int8 width (each leaf padded to whole
    wire blocks, to N·wire_block for the psum forms) for the q8 forms."""
    port, _, n = world4
    name, topo, merge, wd = SCHEDULES[case]
    cfg = SwarmConfig(n_nodes=n, topology=topo, merge=merge, lora_only=False,
                      wire_dtype=wd, wire_block=W.WB)
    sched = next(s for s in comms.candidate_schedules(cfg)
                 if s.name == name)
    lay = W.layout()
    width = lay.size
    if wd == "int8":
        width = gossip.padded_grid(lay, W.WB,
                                   n if "psum" in name else 1).padded
    factor = {"ring": 1.0, "all_to_all": 1.0, "all_gather": float(n),
              "all_reduce": 2.0 * (n - 1) / n}
    for r in range(n):
        counted = sum(f * port[f"{case}/bytes/{kind}"][r]
                      for kind, f in factor.items()
                      if f"{case}/bytes/{kind}" in port)
        want = sched.bytes_by_link_class(width)
        assert want["cross"] == 0.0
        assert counted == pytest.approx(want["intra"], rel=1e-12), (
            case, r, counted, want)


def test_mesh_construction_and_refusals(world4):
    """``make_swarm_mesh`` over the world, the ring's one-node-a-rank rule,
    the production mesh's size check, and the mesh wire's shapes, reset and
    refusals (an unknown schedule; a hierarchical one without its
    ``mesh_shape``)."""
    port = world4[0]
    assert "must divide over the 4 ranks" in str(port["mesh/indivisible"][0])
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh, axis = make_swarm_mesh(W.N)
            assert (axis, mesh.per, mesh.rows, mesh.shape) == (
                "node", W.N, slice(0, W.N), {"node": 1})
            with pytest.raises(RuntimeError, match="need 256 devices"):
                make_production_mesh()
            x = torch.zeros((W.N, W.layout().size))
            with pytest.raises(ValueError, match="one node per mesh shard"):
                gossip.ring_rows_gossip(x, np.eye(W.N), mesh)
            with pytest.raises(ValueError, match="stateless mesh cast"):
                gossip.matrix_gossip(x, np.eye(W.N), mesh, wire_dtype="int8")
            lay = W.layout()
            wire = gossip.init_mesh_wire("fisher_psum_q8", x, n_shards=1,
                                         wire_block=W.WB, layout=lay)
            assert wire["cres"]["num"].shape == (
                1, gossip.padded_grid(lay, W.WB).padded)
            assert wire["ref"]["mass"].shape == (1, lay.size)
            table = gossip.init_mesh_wire("gathered_rows", x, n_shards=1)
            assert table["table"].shape == x.shape
            wire["cons"]["num"] += 1.0
            reset = gossip.reset_mesh_wire(wire)
            assert all(not t.any() for p in reset.values()
                       for t in p.values())
            with pytest.raises(ValueError, match="no mesh wire state"):
                gossip.init_mesh_wire("ring_psum_q8", x, n_shards=1)
            with pytest.raises(ValueError, match="needs mesh_shape"):
                gossip.init_mesh_wire("hier_fedavg_ring_q8", x, n_shards=1)
        finally:
            dist.destroy_process_group()
