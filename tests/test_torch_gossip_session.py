"""``SwarmSession(backend="gossip")`` on a world of 4 gloo ranks on the CPU
(one node a rank, `tests/torch_gossip_world.py`), session by session
against the port's engine backend from the same state and against numpy
oracles.

The int8 comparisons run in the reference's settled regime
(`tests/test_mesh_wire_spmd.py::settled_commit`): six syncs whose gates
reject, so the error-feedback wires settle on unchanged params, then one
accepted commit from that state. The gossip schedules keep the self term
exact and error-feed only what crosses the wire, while the engine backend
error-feeds every node's whole payload; settled, both equal the
uncompressed merge. With zero importance mass (an identity step) the
engine's stateless round trip of the mass is exact too.

The bf16 wire is a stateless cast on the gossip backend (the reference's
``_wire_cast``) and error-fed on the engine backend. Those agree where the
cast loses nothing: the bf16 cases start from bf16-representable params,
and fedavg/full rides the f32 psum. The fisher side channel ``(F⊙θ ⊕ F)``
is cast as products, which bf16 cannot hold: that case is held against a
numpy oracle of the cast side channel within 1e-5, and against the engine
within bf16 rounding (2⁻⁸ of the largest value)."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_gossip_world as W
from repro_torch.configs.base import SwarmConfig
from repro_torch.core.engine import SwarmEngine
from repro_torch.core.session import SwarmSession
from repro_torch.core.topology import build_matrix
from repro_torch.launch.mesh import make_swarm_mesh
from repro_torch.core import comms, gossip

pytestmark = pytest.mark.spmd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
TIMEOUT = 600
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The session scenarios on 4 gloo ranks, each with its own timeout;
    the ranks' rows concatenated in rank order."""
    d = tmp_path_factory.mktemp("gossip_sessions")
    np.savez(d / "inputs.npz", **W.session_inputs(W.N))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    script = os.path.join(HERE, "torch_gossip_world.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "sessions", str(r), str(WORLD),
         f"file://{d}/rdv", str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [dict(np.load(d / f"sessions_rank{r}.npz")) for r in range(WORLD)]
    rows = {}
    for key in outs[0]:
        vals = [o[key] for o in outs]
        if vals[0].ndim == 0 or key.endswith("/gates") \
                or key.startswith("node_params"):
            # replicated on every rank
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0], err_msg=key)
            rows[key] = vals[0]
        else:
            rows[key] = np.concatenate(vals)
    return rows


@pytest.fixture(scope="module")
def inp():
    return W.session_inputs(W.N)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _oracle(topo, merge, wire, w0):
    """The settled commit's numpy oracle (zero mass: the eps floor makes
    every fisher mass equal)."""
    if (topo, merge, wire) == ("ring", "fisher", "bf16"):
        # the cast side channel: neighbours' (eps·θ, eps) arrive in bf16
        R = build_matrix("ring", W.N)
        eps = np.float32(1e-8)
        y = (eps * w0).astype(np.float32)
        num, den = np.zeros_like(w0), np.zeros_like(w0)
        for i in range(W.N):
            for j in range(W.N):
                if R[i, j]:
                    yj = y[j] if i == j else _bf16(y[j])
                    ej = eps if i == j else _bf16(eps)
                    num[i] += np.float32(R[i, j]) * yj
                    den[i] += np.float32(R[i, j]) * ej
        return num / den
    return build_matrix(topo, W.N) @ w0


SETTLED = [(t, m, w) for t, m in W.SETTLED for w in ("f32", "bf16", "int8")]


@pytest.mark.parametrize("topo,merge,wire", SETTLED)
def test_settled_commit_matches_engine_and_oracle(ranks, inp, topo, merge,
                                                  wire):
    """The committed params of the gossip session against the port's
    engine backend's, from the same params through the same settled
    regime, within 1e-5, and against the numpy oracle within 1e-5."""
    w0 = inp["w0_bf16"] if wire == "bf16" else inp["w0"]
    got = ranks[f"settled/{topo}/{merge}/{wire}"]
    assert ranks[f"settled/{topo}/{merge}/{wire}/gates"].all()
    want, log = W.settled_commit(topo, merge, wire, w0)
    assert log["gates"].all()
    want = want.numpy()
    np.testing.assert_allclose(got, _oracle(topo, merge, wire, w0),
                               rtol=TOL, atol=TOL)
    if (topo, merge, wire) == ("ring", "fisher", "bf16"):
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(w0).max()
        return
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("topo,merge", W.REAL)
@pytest.mark.parametrize("kind", ["real", "member"])
def test_rounds_match_engine(ranks, inp, topo, merge, kind):
    """Rounds of a real step (the pull toward each node's target; fisher and
    gradmatch accumulate Δθ² mass; fedavg sizes 1:2:3:4) on the f32 wire:
    two rounds, or (``member``) three with node 2 leaving for the second
    and joining for the third; params within 1e-5 of the engine backend's
    and the gates equal."""
    want, gates = W.real_rounds(topo, merge, inp,
                                membership=kind == "member")
    np.testing.assert_allclose(ranks[f"{kind}/{topo}/{merge}"],
                               want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ranks[f"{kind}/{topo}/{merge}/gates"],
                                  gates.numpy())
    if kind == "member":
        assert not gates[1, 2] and gates[2].all()


def test_quorum_and_fairness_floor(ranks, inp):
    """A quorum of 4 and a fairness floor (the least merged metric over
    the active sites, an all_reduce MIN on the gossip backend): with node
    2 away every gate closes for that round; params and gates as the
    engine backend's."""
    want, gates = W.real_rounds("dynamic", "mean", inp, membership=True,
                                policy=True)
    np.testing.assert_allclose(ranks["policy"], want.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(ranks["policy/gates"], gates.numpy())
    assert not gates[1].any() and gates[0].all() and gates[2].all()


def test_overlap_sync_under_run_rounds(ranks, inp):
    """``overlap_sync`` (the commit lands one round late) under
    ``run_rounds``: on the f32 wire the engine's params within 1e-5; on the
    int8 mesh wire every gate opens and the params stay finite (the
    reference's overlap check)."""
    want, gates = W.real_rounds("ring", "fisher", inp, overlap=True)
    np.testing.assert_allclose(ranks["overlap/f32"], want.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ranks["overlap/f32/gates"], gates.numpy())
    assert ranks["overlap/int8/gates"].shape == (4, W.N)
    assert ranks["overlap/int8/gates"].all()
    assert np.isfinite(ranks["overlap/int8"]).all()


def test_lora_only_payload(ranks, inp):
    """Adapter-only sync: on the f32 wire the engine's params within 1e-5;
    on the int8 wire the mesh wire covers the adapters only and the base
    leaf is the local step's, bit for bit."""
    from repro_torch.core.flat import FlatLayout
    llay = FlatLayout(list(W.LORA_LEAVES))
    cfg = SwarmConfig(n_nodes=W.N, sync_every=1, topology="full",
                      merge="fedavg", lora_only=True, val_threshold=0.0,
                      wire_dtype="f32", wire_block=W.WB)
    s = W.make_session(cfg, W.lora_step, inp["lora0"], llay)
    s.round(torch.zeros((1, W.N, 4)), torch.zeros((W.N, 1)))
    np.testing.assert_allclose(ranks["lora/f32"], s.state.params.numpy(),
                               rtol=TOL, atol=TOL)
    n_adapters = 8 * 2 + 2 * 6
    assert int(ranks["lora/int8/wire_width"]) == n_adapters
    base = next(lf for lf in llay.leaves if lf.path == "attn.w")
    sl = slice(base.offset, base.offset + base.size)
    local = (torch.from_numpy(inp["lora0"]) + 0.01).numpy()
    np.testing.assert_array_equal(ranks["lora/int8"][:, sl], local[:, sl])
    assert not np.array_equal(ranks["lora/int8"], local)


def test_bitwise_determinism_bytes_and_node_params(ranks):
    """Two int8 runs agree bit for bit (params and the mesh wire); the
    ring's counted bytes equal the cost model's at the padded int8 width;
    ``node_params`` gathers the whole swarm on every rank."""
    np.testing.assert_array_equal(ranks["determinism/0/params"],
                                  ranks["determinism/1/params"])
    np.testing.assert_array_equal(ranks["determinism/0/wire"],
                                  ranks["determinism/1/wire"])
    cfg = W.session_cfg("ring", "fisher", "int8")
    sched = comms.pick_schedule(cfg, per=1)
    assert sched.name == "ring_topo_ppermute"
    width = gossip.padded_grid(W.session_layout(), W.WB).padded
    assert float(ranks["bytes/ring_topo_int8/counted"]) == \
        sched.bytes_by_link_class(width)["intra"]
    assert float(ranks["bytes/ring_topo_int8/control"]) > 0
    from repro_torch.convert import to_reference_tree
    tree = to_reference_tree(W.session_layout(),
                             torch.from_numpy(ranks["determinism/0/params"]))
    for path, _ in W.SESSION_LEAVES:
        np.testing.assert_array_equal(ranks[f"node_params/{path}"],
                                      tree[path])


def test_make_swarm_sync_step(ranks, inp):
    """``launch.train.make_swarm_sync_step``'s propose (ring fedavg, one node
    a rank: the ring's neighbour exchange) against the engine backend's
    candidate, and its commit: the odd ranks' gates close (merged 0.5 <
    0.8 · local 1.0) and keep their rows bit for bit."""
    cfg = W.session_cfg("ring", "fedavg", thr=0.8)
    eng = SwarmEngine(cfg, None, None, data_sizes=W.SIZES,
                      layout=W.session_layout())
    want = eng.propose(torch.from_numpy(inp["w0"]))[0].numpy()
    cand = ranks["sync_step/candidate"]
    np.testing.assert_allclose(cand, want, rtol=TOL, atol=TOL)
    got = ranks["sync_step/committed"]
    np.testing.assert_array_equal(got[1::2], inp["w0"][1::2])
    np.testing.assert_array_equal(got[0::2], cand[0::2])


def test_gossip_refusals():
    """The reference's ValueErrors: no mesh; a model-zoo closure list; an
    inner param spec without the params' layout (with it, a mesh without
    a model axis shards nothing); the in-graph corrupt wire.
    A gossip session's checkpoint, refused until its port, now round-trips
    on a world of one rank (its psum-q8 wire included)."""
    cfg = W.session_cfg("ring", "fedavg")
    flat = torch.zeros(W.session_layout().size)
    with pytest.raises(ValueError, match="gossip backend needs mesh and axis"):
        SwarmSession(cfg, None, None, params=flat, backend="gossip",
                     device="cpu")
    with pytest.raises(ValueError, match="engine-backend only"):
        SwarmSession(cfg, [None] * W.N, None, params=flat, backend="gossip",
                     device="cpu")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh, axis = make_swarm_mesh(W.N)
            with pytest.raises(ValueError, match="need the params' layout"):
                SwarmSession(cfg, None, None, params=flat, backend="gossip",
                             mesh=mesh, axis=axis, device="cpu",
                             param_specs={"c": (None, "model")})
            # with the layout an inner spec is taken; a mesh without a
            # model axis shards nothing
            inner = SwarmSession(cfg, None, None, params=flat,
                                 backend="gossip", mesh=mesh, axis=axis,
                                 device="cpu", layout=W.session_layout(),
                                 param_specs={"c": (None, "model")})
            assert inner.engine.shard is None
            assert inner.state.params.shape == (W.N, flat.numel())
            with pytest.raises(ValueError, match="swarm axis"):
                SwarmSession(cfg, None, None, params=flat, backend="gossip",
                             mesh=mesh, axis="pod", device="cpu")
            s = SwarmSession(cfg, W.id_step, W.const_eval, params=flat,
                             backend="gossip", mesh=mesh, axis=axis,
                             layout=W.session_layout(), device="cpu",
                             param_specs={"c": None})
            # one node a rank is needed for the ring: at 4 nodes a rank the
            # cost model falls back to the gathered rows
            assert s.sync_schedule.name == "gathered_rows"
            assert not s.sync_schedule.simulated
            assert s.predicted_sync_bytes == s.sync_schedule.bytes_per_sync(
                s.payload_params)
            path = os.path.join(d, "s.msgpack")
            w0 = [torch.from_numpy(r) for r in W.session_inputs(W.N)["w0"]]
            q8 = SwarmSession(W.session_cfg("full", "fedavg", "int8"),
                              W.id_step, W.const_eval, params=w0,
                              backend="gossip", mesh=mesh, axis=axis,
                              layout=W.session_layout(), device="cpu")
            q8.round(torch.zeros((1, W.N, 1)), torch.zeros((W.N, 1)))
            assert q8.sync_schedule.name == "fedavg_psum_q8"
            q8.save(path)
            back = SwarmSession(W.session_cfg("full", "fedavg", "int8"),
                                W.id_step, W.const_eval, params=flat,
                                backend="gossip", mesh=mesh, axis=axis,
                                layout=W.session_layout(),
                                device="cpu").load(path)
            assert torch.equal(back.state.params, q8.state.params)
            # on one rank the second stage re-quantizes a decoded payload:
            # its residual is zero
            assert q8.state.wire["ref"].any() and q8.state.wire["cons"].any()
            for key in ("ref", "cons", "cres"):
                assert torch.equal(back.state.wire[key], q8.state.wire[key])
            with pytest.raises(ValueError, match="engine backend"):
                s.round(torch.zeros((1, W.N, 1)), torch.zeros((W.N, 1)),
                        faults=object())
        finally:
            dist.destroy_process_group()
