"""The port's host backend (`repro_torch.core.swarm.SwarmLearner`, the
session's ``backend="host"``) against the reference's host loop
(`repro.core.swarm`, `repro.core.session` with ``backend="host"``), from the
same carried-across state: the reference's host tests on the pull-to-target
toy (weighted mean, membership, the gate, weighted merges with a departed
node, explicit and mixed Fisher sources, the true-Fisher hook, fisher on a
ring, quorum, checkpoints that cross between the packages, the limits),
the TINY CNN through both packages' host loops and the port's engine
backend (params within 1e-4, gate bits equal outside the 1e-4 margin), a
fault plan lowered to drops, and a CPU smoke run of each example twin."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.core.swarm import NodeState as JNode  # noqa: E402
from repro.core.swarm import SwarmLearner as JLearner  # noqa: E402
from repro.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.faults import run_plan as jrun_plan  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.core.session import SwarmSession  # noqa: E402
from repro_torch.core.swarm import NodeState, SwarmLearner  # noqa: E402
from repro_torch.faults import FaultPlan, run_plan  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

tp.torch_cpu()
N = 4
ROOT = Path(__file__).resolve().parent.parent
TARGETS = np.stack([np.full(4, float(i), np.float32) for i in range(N)])
SIZES = [100 * (i + 1) for i in range(N)]


def _kw(**kw):
    base = dict(n_nodes=N, sync_every=2, merge="fedavg", topology="full",
                lora_only=False, val_threshold=0.0)
    return dict(base, **kw)


def _jstep(p, o, b, s):
    g = p["x"] - b
    return {"x": p["x"] - 0.1 * g}, o, {"loss": jnp.sum(g * g)}


def _tstep(p, o, b, s):
    g = p - b
    return p - 0.1 * g, o, {"loss": torch.sum(g * g)}


def _jtargets():
    return [jnp.asarray(t) for t in TARGETS]


def _ttargets():
    return [torch.from_numpy(t.copy()) for t in TARGETS]


def _learners(kw, x0=None, sizes=SIZES, jstep=_jstep, tstep=_tstep,
              jeval=None, teval=None):
    """A reference and a port SwarmLearner over the toy, from the same
    per-node params ``x0`` [N, 4]."""
    x0 = np.zeros((N, 4), np.float32) if x0 is None else x0
    jn = [JNode(params={"x": jnp.asarray(x0[i])}, opt_state=None,
                data_size=sizes[i]) for i in range(N)]
    tn = [NodeState(params=torch.from_numpy(x0[i].copy()), opt_state=None,
                    data_size=sizes[i]) for i in range(N)]
    return (JLearner(JSwarmConfig(**kw), jstep,
                     jeval or (lambda p, v: 1.0), jn),
            SwarmLearner(SwarmConfig(**kw), tstep,
                         teval or (lambda p, v: 1.0), tn))


def _params(learner):
    return np.stack([np.asarray(nd.params["x"]) if isinstance(nd.params, dict)
                     else nd.params.numpy() for nd in learner.nodes])


def _same(jl, tl, jlog=None, tlog=None, atol=1e-6):
    np.testing.assert_allclose(_params(tl), _params(jl), rtol=1e-5,
                               atol=atol)
    if jlog is not None:
        assert list(map(bool, tlog["gates"])) == list(map(bool,
                                                         jlog["gates"]))


# ---------------------------------------------------------------------------
# the SwarmLearner toy (tests/test_swarm_core.py)
# ---------------------------------------------------------------------------

def test_learner_syncs_to_weighted_mean():
    jl, tl = _learners(_kw(val_threshold=0.8))
    for _ in range(2):
        jl.local_steps(_jtargets())
        tl.local_steps(_ttargets())
    jlog, tlog = jl.sync([1] * N), tl.sync([1] * N)
    assert all(tlog["gates"])
    xs = _params(tl)
    for x in xs[1:]:
        np.testing.assert_allclose(x, xs[0], rtol=1e-5, atol=1e-6)
    _same(jl, tl, jlog, tlog)
    assert tlog["spectral_gap"] == pytest.approx(jlog["spectral_gap"])
    assert tl.nodes[0].history[0]["loss"] == pytest.approx(
        jl.nodes[0].history[0]["loss"])


def test_learner_dynamic_membership():
    jl, tl = _learners(_kw(val_threshold=0.8))
    for lr in (jl, tl):
        lr.set_active(2, False)
    for _ in range(2):
        jl.local_steps([t if i != 2 else None
                        for i, t in enumerate(_jtargets())])
        tl.local_steps([t if i != 2 else None
                        for i, t in enumerate(_ttargets())])
    x2 = tl.nodes[2].params.clone()
    jlog, tlog = jl.sync([1, 1, None, 1]), tl.sync([1, 1, None, 1])
    assert not tlog["gates"][2]
    assert torch.equal(tl.nodes[2].params, x2)
    _same(jl, tl, jlog, tlog)


@pytest.mark.parametrize("merge", ["fisher", "gradmatch"])
def test_inactive_node_excluded_from_weighted_merges(merge):
    """A departed node's huge explicit Fisher mass and its dataset weight
    stay out of the fisher/gradmatch merge."""
    x0 = np.stack([np.full(8, float(i), np.float32) for i in range(N)])
    jl, tl = _learners(_kw(merge=merge, sync_every=1), x0=x0,
                       sizes=[100] * N)
    for i in range(N):
        f = np.full(8, 1e6 if i == 2 else 1.0, np.float32)
        jl.nodes[i].fisher = {"x": jnp.asarray(f)}
        tl.nodes[i].fisher = torch.from_numpy(f)
    for lr in (jl, tl):
        lr.set_active(2, False)
        lr.step = 1
    jlog, tlog = jl.sync([1, 1, None, 1]), tl.sync([1, 1, None, 1])
    assert not tlog["gates"][2]
    for i in (0, 1, 3):
        np.testing.assert_allclose(tl.nodes[i].params.numpy(),
                                   np.full(8, 4.0 / 3), rtol=1e-4)
    np.testing.assert_array_equal(tl.nodes[2].params.numpy(), np.full(8, 2.0))
    _same(jl, tl, jlog, tlog)


def test_learner_gate_rejects_bad_merges():
    """The merged candidate is scored second: a lower metric for it rejects
    the merge everywhere, and every node keeps its locals."""
    def alternating():
        calls = {"n": 0}

        def eval_fn(params, val):
            calls["n"] += 1
            return 0.1 if calls["n"] % 2 == 0 else 1.0

        return eval_fn

    jl, tl = _learners(_kw(val_threshold=0.8), jeval=alternating(),
                       teval=alternating())
    for _ in range(2):
        jl.local_steps(_jtargets())
        tl.local_steps(_ttargets())
    before = _params(tl)
    jlog, tlog = jl.sync([1] * N), tl.sync([1] * N)
    assert not any(tlog["gates"])
    np.testing.assert_array_equal(_params(tl), before)
    _same(jl, tl, jlog, tlog)


# ---------------------------------------------------------------------------
# Fisher sources (tests/test_merge_strategy.py, tests/test_session.py)
# ---------------------------------------------------------------------------

def test_untrained_active_node_gets_zero_mass():
    """Node 3 is active but never gets a batch: zero mass, so it cannot
    take over the fisher merge."""
    x0 = np.stack([np.full(4, 100.0 if i == 3 else -1.0, np.float32)
                   for i in range(N)])
    jl, tl = _learners(_kw(merge="fisher"), x0=x0, sizes=[100] * N)
    for _ in range(2):
        jl.local_steps(_jtargets()[:3] + [None])
        tl.local_steps(_ttargets()[:3] + [None])
    jlog, tlog = jl.sync([1] * N), tl.sync([1] * N)
    assert all(tlog["gates"])
    assert np.abs(_params(tl)[:3]).max() < 5.0
    _same(jl, tl, jlog, tlog)


def test_explicit_fisher_survives_local_steps():
    jl, tl = _learners(_kw(merge="fisher"), sizes=[100] * N)
    explicit = torch.full((4,), 7.0)
    tl.nodes[1].fisher = explicit
    jl.nodes[1].fisher = {"x": jnp.full((4,), 7.0, jnp.float32)}
    for _ in range(3):
        jl.local_steps(_jtargets())
        tl.local_steps(_ttargets())
    assert tl.nodes[1].fisher is explicit
    assert tl.nodes[1].fisher_stats is not None
    assert float(tl.nodes[2].fisher_stats.abs().sum()) > 0
    for i in range(N):
        np.testing.assert_allclose(tl.nodes[i].fisher_stats.numpy(),
                                   np.asarray(jl.nodes[i].fisher_stats["x"]),
                                   rtol=1e-5, atol=1e-9)
    jlog, tlog = jl.sync([1] * N), tl.sync([1] * N)
    _same(jl, tl, jlog, tlog)


def test_mixed_explicit_and_proxy_fishers_do_not_collapse():
    """One explicit O(1) Fisher among Δθ²-proxy peers: each node's mass is
    normalized first, and the merge is a genuine blend."""
    x0 = np.stack([np.full(4, float(i), np.float32) for i in range(N)])
    jl, tl = _learners(_kw(merge="fisher"), x0=x0, sizes=[100] * N)
    tl.nodes[0].fisher = torch.ones(4)
    jl.nodes[0].fisher = {"x": jnp.ones((4,), jnp.float32)}
    offset = [np.full(4, i + 0.5, np.float32) for i in range(N)]
    for _ in range(2):
        jl.local_steps([jnp.asarray(o) for o in offset])
        tl.local_steps([torch.from_numpy(o) for o in offset])
    x_0 = tl.nodes[0].params.clone().numpy()
    jlog, tlog = jl.sync([1] * N), tl.sync([1] * N)
    assert all(tlog["gates"])
    merged = tl.nodes[1].params.numpy()
    assert np.abs(merged - x_0).min() > 0.3
    assert merged.max() <= 3.2 and merged.min() >= 0.0
    _same(jl, tl, jlog, tlog)


@pytest.mark.parametrize("merge,topology", [("fisher", "ring"),
                                            ("gradmatch", "ring"),
                                            ("fisher", "full"),
                                            ("gradmatch", "dynamic")])
def test_weighted_host_loop_matches_reference_and_engine(merge, topology):
    """Three rounds of the weighted merges (graph-neighbour rows on the
    ring and the dynamic topology) through the host loop: the reference's
    host loop and the port's engine backend land on the same params."""
    kw = _kw(merge=merge, topology=topology)
    jl, tl = _learners(kw)
    for _ in range(3):
        for _ in range(2):
            jl.local_steps(_jtargets())
            tl.local_steps(_ttargets())
        jlog, tlog = jl.maybe_sync([1] * N), tl.maybe_sync([1] * N)
        assert tlog is not None
        _same(jl, tl, jlog, tlog)
    eng = SwarmSession(SwarmConfig(**kw), _tstep,
                       lambda p, v: torch.ones(p.shape[0]),
                       params=torch.zeros(4), data_sizes=SIZES,
                       device="cpu")
    eng.run_rounds(torch.from_numpy(np.broadcast_to(
        TARGETS, (3, 2, N, 4)).copy()), torch.zeros(N, 1))
    np.testing.assert_allclose(eng.state.params.numpy(), _params(tl),
                               rtol=1e-5, atol=1e-6)


def test_four_tuple_train_step_host_path():
    """The true-Fisher hook on the host loop: the step's grads feed
    F ← γF + g²."""
    decay = 0.5

    def jgrad(p, o, b, s):
        g = p["x"] - b
        return {"x": p["x"] - 0.1 * g}, o, {"loss": jnp.sum(g * g)}, {"x": g}

    def tgrad(p, o, b, s):
        g = p - b
        return p - 0.1 * g, o, {"loss": torch.sum(g * g)}, g

    jl, tl = _learners(_kw(merge="fisher", fisher_decay=decay),
                       sizes=[100] * N, jstep=jgrad, tstep=tgrad)
    for _ in range(2):
        jl.local_steps(_jtargets())
        tl.local_steps(_ttargets())
    t = np.full(4, 3.0, np.float32)
    want = decay * t ** 2 + (0.9 * t) ** 2
    np.testing.assert_allclose(tl.nodes[3].fisher_stats.numpy(), want,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.nodes[3].fisher_stats.numpy(),
                               np.asarray(jl.nodes[3].fisher_stats["x"]),
                               rtol=1e-6)


def test_mixed_step_forms_with_in_place_updates():
    """A step that updates its params in place and returns the 4-tuple on
    even steps, the 3-tuple on odd ones: the even steps' grads and the odd
    steps' Δθ² proxy (from the copy of the old params) feed fisher as in
    the reference, whose steps return fresh arrays."""
    def jmixed(p, o, b, s):
        g = p["x"] - b
        out = {"x": p["x"] - 0.1 * g}, o, {"loss": jnp.sum(g * g)}
        return out + ({"x": g},) if s % 2 == 0 else out

    def tmixed(p, o, b, s):
        g = p - b
        p.sub_(0.1 * g)
        out = p, o, {"loss": torch.sum(g * g)}
        return out + (g,) if s % 2 == 0 else out

    jl, tl = _learners(_kw(merge="fisher", fisher_decay=0.5),
                       sizes=[100] * N, jstep=jmixed, tstep=tmixed)
    held = [nd.params for nd in tl.nodes]
    for _ in range(3):
        jl.local_steps(_jtargets())
        tl.local_steps(_ttargets())
    assert all(nd.params is p for nd, p in zip(tl.nodes, held))
    _same(jl, tl)
    for jn, tn in zip(jl.nodes, tl.nodes):
        np.testing.assert_allclose(tn.fisher_stats.numpy(),
                                   np.asarray(jn.fisher_stats["x"]),
                                   rtol=1e-5, atol=1e-7)
    assert float(tl.nodes[3].fisher_stats.min()) > 0
    # the engine backend's vmapped steps, the same mixed in-place step
    eng = SwarmSession(SwarmConfig(**_kw(merge="fisher", fisher_decay=0.5)),
                       tmixed, lambda p, v: torch.ones(p.shape[0]),
                       params=torch.zeros(4), data_sizes=[100] * N,
                       device="cpu")
    buf = eng.state.params
    eng.run_local(torch.from_numpy(np.broadcast_to(
        TARGETS, (3, N, 4)).copy()))
    assert eng.state.params is buf
    np.testing.assert_allclose(eng.state.params.numpy(), _params(tl),
                               rtol=1e-6)
    np.testing.assert_allclose(
        eng.state.stats.numpy(),
        np.stack([nd.fisher_stats.numpy() for nd in tl.nodes]), rtol=1e-6)


# ---------------------------------------------------------------------------
# the session's host backend (tests/test_session.py, tests/test_faults.py)
# ---------------------------------------------------------------------------

def _jsession(cfg_kw, **kw):
    kw.setdefault("params", {"x": jnp.zeros((4,))})
    kw.setdefault("data_sizes", SIZES)
    return JSession(JSwarmConfig(**cfg_kw), _jstep, lambda p, v: 1.0,
                    backend="host", **kw)


def _tsession(cfg_kw, **kw):
    kw.setdefault("params", torch.zeros(4))
    kw.setdefault("data_sizes", SIZES)
    return SwarmSession(SwarmConfig(**cfg_kw), _tstep, lambda p, v: 1.0,
                        backend="host", device="cpu", **kw)


def test_host_backend_matches_engine_backend_and_reference():
    """The same toy schedule through the port's host loop, the port's
    engine backend and the reference's host loop, with a leave and a join:
    a departed node that still receives batches keeps training locally and
    is only excluded from merges. Params, round counters and the rng fold
    agree."""
    kw = _kw(topology="dynamic")
    host, js = _tsession(kw), _jsession(kw)
    eng = SwarmSession(SwarmConfig(**kw), _tstep,
                       lambda p, v: torch.ones(p.shape[0]),
                       params=torch.zeros(4), data_sizes=SIZES, device="cpu")
    eb = torch.from_numpy(np.broadcast_to(TARGETS, (2, N, 4)).copy())
    for r in range(3):
        for sess in (host, js, eng):
            if r == 1:
                sess.leave(3)
            if r == 2:
                sess.join(3)
        tlog = host.round([_ttargets()] * 2, [1] * N)
        jlog = js.round([_jtargets()] * 2, [1] * N)
        eng.round(eb, torch.zeros(N, 1))
        assert tlog["gates"] == [bool(g) for g in jlog["gates"]]
        assert tlog["step"] == jlog["step"] == 2 * (r + 1)
    want = np.asarray(js.state.params["x"])
    np.testing.assert_allclose(host.state.params.numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(eng.state.params.numpy(),
                               host.state.params.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert host.state.round == int(js.state.round) == 3
    np.testing.assert_array_equal(host.state.rng, np.asarray(js.state.rng))
    np.testing.assert_array_equal(host.state.rng, eng.state.rng)
    assert host.active.tolist() == [True] * N
    assert len(host.node_params) == N


def test_host_checkpoint_roundtrip_crosses_packages(tmp_path):
    """A fisher host session with a departed node: saved, restored into a
    fresh port host session (params, statistics, membership, counters bit
    for bit), loaded by the reference's host session, and the reference's
    own host checkpoint loaded by the port."""
    kw = _kw(merge="fisher")
    layout = FlatLayout([("x", (4,))])     # the reference's {"x": ...}
    sess, js = _tsession(kw, layout=layout), _jsession(kw)
    for s, b in ((sess, _ttargets()), (js, _jtargets())):
        s.round([b, b], [1] * N)
        s.leave(1)
    path = str(tmp_path / "host.msgpack")
    sess.save(path)
    restored = SwarmSession.restore(
        path, SwarmConfig(**kw), _tstep, lambda p, v: 1.0, backend="host",
        params=torch.zeros(4), data_sizes=SIZES, layout=layout,
        device="cpu")
    np.testing.assert_array_equal(restored.active, [True, False, True, True])
    for f in ("params", "stats"):
        assert torch.equal(getattr(restored.state, f), getattr(sess.state, f))
    assert (restored.state.round, restored.state.step) == (1, 2)
    np.testing.assert_array_equal(restored.state.rng, sess.state.rng)
    # the port's file in the reference's host session
    jr = JSession.restore(path, JSwarmConfig(**kw), _jstep, lambda p, v: 1.0,
                          backend="host", params={"x": jnp.zeros((4,))},
                          data_sizes=SIZES)
    np.testing.assert_array_equal(np.asarray(jr.state.params["x"]),
                                  sess.state.params.numpy())
    np.testing.assert_array_equal(np.asarray(jr.state.stats["x"]),
                                  sess.state.stats.numpy())
    np.testing.assert_array_equal(jr.active, [True, False, True, True])
    # the reference's file in the port's host session
    jpath = str(tmp_path / "jhost.msgpack")
    js.save(jpath)
    back = _tsession(kw, layout=layout).load(jpath)
    np.testing.assert_allclose(back.state.params.numpy(),
                               np.asarray(js.state.params["x"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(back.active, js.active)
    assert back.state.step == int(js.state.step)
    # the resumed sessions go on together
    for s in (restored, back):
        s.round([_ttargets()] * 2, [1] * N)
    np.testing.assert_allclose(restored.state.params.numpy(),
                               back.state.params.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_quorum_holds_locals_host_backend():
    def step(p, o, b, s):
        return p, o, {"loss": 0.0}

    kw = _kw(quorum=3, sync_every=1)
    sess = SwarmSession(SwarmConfig(**kw), step, lambda p, v: 1.0,
                        params=[torch.full((4,), float(i)) for i in range(N)],
                        data_sizes=[1.0] * N, backend="host", device="cpu")
    sess.set_active([True, True, False, False])
    batches = [[torch.zeros(4)] * N]
    log = sess.round(batches, [torch.zeros(1)] * N)
    assert log["quorum_ok"] is False
    assert not any(log["gates"])
    for i, p in enumerate(sess.node_params):          # everyone kept locals
        np.testing.assert_array_equal(p.numpy(), np.full(4, float(i)))
    sess.join(2)
    log = sess.round(batches, [torch.zeros(1)] * N)
    assert log["quorum_ok"] is True
    assert log["gates"][:3] == [True, True, True]


def test_host_backend_limits():
    """The reference's host-loop limits, with its messages: f32 wire only,
    no adapter-only payload state, one callable for every node; and fault
    signals are refused before any step runs."""
    with pytest.raises(ValueError, match="host loop is uncompressed"):
        _tsession(_kw(wire_dtype="int8"))
    with pytest.raises(ValueError, match='payload="lora"'):
        _tsession(_kw(payload="lora"))
    fns = [_tstep] * N
    with pytest.raises(ValueError, match="engine-backend"):
        SwarmSession(SwarmConfig(**_kw()), fns, lambda p, v: 1.0,
                     params=torch.zeros(4), backend="host", device="cpu")
    sess = _tsession(_kw())
    with pytest.raises(ValueError, match="compiled backend"):
        sess.round([_ttargets()], [1] * N, faults=object())
    assert sess.state.step == 0


def test_run_plan_on_host_lowers_corrupt_to_drops():
    """A corrupt event on the host loop is a drop for its round, as the
    reference's runner lowers it off the engine backend's wire."""
    kw = _kw(sync_every=1, topology="dynamic")
    sess, js = _tsession(kw), _jsession(kw)
    tlogs = run_plan(sess, FaultPlan(N, 3, seed=2).corrupt(1, at=1),
                     [_ttargets()], [1] * N)[1]
    jlogs = jrun_plan(js, JFaultPlan(N, 3, seed=2).corrupt(1, at=1),
                      [_jtargets()], [1] * N)[1]
    for t, j in zip(tlogs, jlogs):
        np.testing.assert_array_equal(t["active"], j["active"])
        np.testing.assert_array_equal(t["gates"], np.asarray(j["gates"]))
        assert "wire_ok" not in t
    assert not tlogs[1]["active"][1] and not tlogs[1]["gates"][1]
    np.testing.assert_allclose(sess.state.params.numpy(),
                               np.asarray(js.state.params["x"]), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the paper's CNN through both packages' host loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge,topology", [("fedavg", "full"),
                                            ("fisher", "ring")])
def test_tiny_cnn_host_loop_matches_reference_and_engine(merge, topology):
    """The TINY CNN (`torch_parity`) through the reference's host loop, the
    port's host loop and the port's engine backend, from the reference's
    init carried across: three rounds with a ``leave(3)`` / ``join(3)``;
    params within 1e-4 (the FC biases at 2e-3, `torch_parity.check_flat`)
    and gate bits equal where the reference's margin clears 1e-4."""
    kw = dict(n_nodes=N, sync_every=2, topology=topology, merge=merge,
              lora_only=False, val_threshold=tp.THR)
    jtrain, jeval, ttrain, teval_for, layout = tp.session_fns()
    cfg = SwarmConfig(**kw)
    teval = teval_for(cfg)
    tree = tp.jax_params(3, tp.WIDTHS)
    flat = tp.from_reference(layout, tree)
    from repro.optim import adamw_init as jadamw_init
    js = JSession(JSwarmConfig(**kw), jax.jit(jtrain),
                  lambda p, v: float(jeval(p, v)), params=tree,
                  opt_state=jadamw_init(tree), data_sizes=tp.SIZES,
                  backend="host")

    def teval_one(p, v):
        return float(teval(p[None], tuple(torch.as_tensor(t)[None]
                                          for t in v))[0])

    def tstep(p, o, b, s):
        return ttrain(p, o, tuple(torch.as_tensor(t) for t in b), s)

    host = SwarmSession(cfg, tstep, teval_one, params=flat,
                        opt_state=adamw_init(flat), data_sizes=tp.SIZES,
                        layout=layout, backend="host", device="cpu")
    eng = SwarmSession(cfg, ttrain, teval, params=flat,
                       opt_state=adamw_init(flat), data_sizes=tp.SIZES,
                       layout=layout, device="cpu")
    xs, ys, val = tp.round_data(9, t=2, r=3)
    vlist = [tuple(v[i] for v in val) for i in range(N)]
    for r in range(3):
        for s in (js, host, eng):
            if r == 1:
                s.leave(3)
            if r == 2:
                s.join(3)
        hb = [[(xs[r, k, i], ys[r, k, i]) for i in range(N)]
              for k in range(2)]
        jlog = js.round(hb, vlist)
        tlog = host.round(hb, vlist)
        elog = eng.round((xs[r], ys[r]), val)
        ml = np.asarray(jlog["metric_local"], np.float32)
        mm = np.asarray(jlog["metric_merged"], np.float32)
        clear = np.abs(mm - tp.THR * ml) >= 1e-4
        assert clear.any()
        np.testing.assert_array_equal(np.asarray(tlog["gates"])[clear],
                                      np.asarray(jlog["gates"])[clear])
        np.testing.assert_array_equal(np.asarray(tlog["gates"]),
                                      elog["gates"].numpy())
        want = tp.from_reference(layout, jax.tree.map(
            np.asarray, js.state.params), lead=1).numpy()
        tp.check_flat(host.state.params.numpy(), want, layout)
        tp.check_flat(eng.state.params.numpy(), host.state.params.numpy(),
                      layout)


# ---------------------------------------------------------------------------
# the example twins, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", ["--rounds", "2", "--steps", "2"]),
    ("torch_imbalanced_nodes.py", ["--steps", "3"]),
    ("torch_engine_swarm.py", []),
    ("torch_histopathology_swarm.py", ["--steps", "20", "--n-train", "160"]),
    ("torch_serve_demo.py", [])])
def test_example_twin_runs_on_cpu(script, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], capture_output=True, text=True, env=env, timeout=300,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    if script == "torch_quickstart.py":
        assert "OK" in out.stdout and out.stdout.count("gates=") == 2
    elif script == "torch_imbalanced_nodes.py":
        assert "dynamic membership" in out.stdout
    elif script == "torch_engine_swarm.py":
        # 3 rounds, then the rounds after leave(3)
        assert out.stdout.count("gates=") == 4 and "OK" in out.stdout
        assert "node 3 left: gates=[True, True, True, False]" in out.stdout
    elif script == "torch_histopathology_swarm.py":
        assert out.stdout.count("recovery of centralized AUC") == 3
        written = sorted(p.name for p in
                         (tmp_path / "experiments" / "histo_torch").iterdir())
        assert written == ["scarcity25.json", "scarcity5.json",
                           "unbalanced.json"]
    else:
        assert out.stdout.count("generated (4, 16)") == 4
        assert "6 reqs" in out.stdout and "OK" in out.stdout
