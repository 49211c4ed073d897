"""The port's fault plane (`repro_torch.faults`) against the reference's.

* the plan copy lowers every plan to the reference's matrices and rejects
  what the reference rejects;
* the corrupt-wire flip pattern is the reference's bit for bit (the
  partitionable threefry layout pinned), on a layout with a conv leaf
  (stored OIHW, flattened HWIO by the reference), a bias and an odd-sized
  leaf, and on the small CNN; every flip is caught by the checksum;
* the reference's fault tests on the pull-to-target toy, against the
  float64 oracle (`repro.faults.oracle`): trajectories ≤ 2e-5, the int8
  crash → rejoin settled parity ≤ 1e-5, the corrupt sender quarantined
  with its locals kept bit for bit, preempt/restore bit-identical;
* paired small-CNN sessions in both packages through one armed and one
  idle round on the int8 wire;
* the true-Fisher 4-tuple train step in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.faults.oracle as oracle  # noqa: E402
import torch_parity as tp  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.faults import plan as jplan  # noqa: E402
from repro.faults import signals as jsig  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.convert import from_reference, to_reference_tree  # noqa: E402
from repro_torch.core import comms  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.core.session import SwarmSession  # noqa: E402
from repro_torch.faults import (FaultEvent, FaultPlan, FaultSignals,  # noqa: E402
                                flip_payload_bits, idle_signals, run_plan)
from repro_torch.faults import plan as tplan  # noqa: E402
from repro_torch.faults.signals import plan_key  # noqa: E402

tp.torch_cpu()
N = 4
SIZES = [1.0, 2.0, 3.0, 4.0]


@pytest.fixture
def partitionable():
    """The threefry counter layout the port implements, pinned."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


# ---------------------------------------------------------------------------
# the plan copy
# ---------------------------------------------------------------------------

def _plans(mod):
    """The plans of tests/test_faults.py, and seeded random ones."""
    P = mod.FaultPlan
    plans = [
        P(N, 6, seed=5).crash(1, at=1, rejoin=3).straggle(3, at=2, rounds=2)
        .drop(0, at=4).corrupt(2, at=5).preempt(at=3),
        P(N, 5).crash(2, at=1),
        P(N, 7).crash(1, at=1, rejoin=3).straggle(3, at=4, rounds=1)
        .drop(0, at=5),
        P(N, 8).crash(1, at=1, rejoin=2),
        P(N, 8, seed=1).crash(1, at=1, rejoin=3).straggle(3, at=2, rounds=2)
        .drop(0, at=5).corrupt(2, at=6),
        P(N, 6).crash(2, at=1, rejoin=4).preempt(at=3),
    ]
    rng = np.random.default_rng(3)
    for seed in range(6):
        r = int(rng.integers(2, 10))
        plan = P(N, r, seed=seed)
        for _ in range(int(rng.integers(1, 7))):
            kind = str(rng.choice(["crash", "straggle", "drop", "corrupt",
                                   "preempt"]))
            node, at = int(rng.integers(0, N)), int(rng.integers(0, r))
            if kind == "crash":
                rejoin = (None if rng.random() < 0.3
                          else at + int(rng.integers(1, 4)))
                plan = plan.crash(node, at=at, rejoin=rejoin)
            elif kind == "straggle":
                plan = plan.straggle(node, at=at,
                                     rounds=int(rng.integers(1, 4)))
            elif kind == "preempt":
                plan = plan.preempt(at=at)
            else:
                plan = getattr(plan, kind)(node, at=at)
        plans.append(plan)
    return plans


@pytest.mark.parametrize("i", range(12))
@pytest.mark.parametrize("in_graph", [True, False])
def test_plan_lowering_equals_reference(i, in_graph):
    want = _plans(jplan)[i].lower(corrupt_in_graph=in_graph)
    got = _plans(tplan)[i].lower(corrupt_in_graph=in_graph)
    for field in ("active", "corrupt", "rejoin", "preempt"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("build", [
    lambda P, E: P(N, 6).crash(7, at=0),
    lambda P, E: P(N, 6).crash(0, at=6),
    lambda P, E: P(N, 6).crash(0, at=3, rejoin=3),
    lambda P, E: P(N, 6).straggle(0, at=1, rounds=0),
    lambda P, E: P(0, 6),
    lambda P, E: P(N, 6, events=(E("meteor", 0, 0),)),
    lambda P, E: P(N, 6).preempt(at=-1),
])
def test_plan_validation_matches_reference(build):
    with pytest.raises(ValueError) as want:
        build(jplan.FaultPlan, jplan.FaultEvent)
    with pytest.raises(ValueError) as got:
        build(FaultPlan, FaultEvent)
    assert str(got.value) == str(want.value)


def test_plan_builders_are_pure():
    base = FaultPlan(N, 6)
    assert base.crash(1, at=2).events and base.events == ()


# ---------------------------------------------------------------------------
# threefry, the bernoulli draw, the flip pattern
# ---------------------------------------------------------------------------

def test_installed_jax_defaults_to_the_partitionable_layout():
    """The port implements the counter layout of the installed JAX."""
    assert jax.config.jax_threefry_partitionable is True


def test_random_bits_counter_layout_of_installed_jax(partitionable):
    """jax.random.bits of a (4, 1) and an odd-sized shape are y0 ^ y1 of the
    counter pairs (0, flat index): the partitionable layout."""
    key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    k = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    for shape in ((4, 1), (3, 37)):
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        c = torch.arange(int(np.prod(shape)))
        y0, y1 = prng.threefry2x32(k[0], k[1], torch.zeros_like(c), c)
        np.testing.assert_array_equal((y0 ^ y1).numpy().reshape(shape),
                                      want.astype(np.int64))


@pytest.mark.parametrize("rate", [1.0 / 16, 0.3])
def test_bernoulli_is_a_threshold_on_the_word(partitionable, rate):
    """bernoulli(rate) on JAX's float32 uniform is (w >> 9) < ceil(rate·2²³)
    (w < 2²⁸ at 1/16)."""
    key = jax.random.PRNGKey(5)
    shape = (4, 777)
    words = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    draw = np.asarray(jax.random.bernoulli(key, rate, shape))
    thr = int(np.ceil(float(np.float32(rate)) * 2 ** 23))
    np.testing.assert_array_equal(draw, (words >> 9) < thr)
    if rate == 1.0 / 16:
        np.testing.assert_array_equal(draw, words < 2 ** 28)


def test_fold_in_matches_jax():
    key = np.asarray(jax.random.PRNGKey(123), np.uint32)
    data = torch.arange(70)
    y0, y1 = prng.fold_in(torch.from_numpy(key.astype(np.int64)), data)
    for i in (0, 1, 37, 69):
        want = np.asarray(jax.random.fold_in(jnp.asarray(key), i))
        assert [int(y0[i]), int(y1[i])] == want.tolist()


def _small_layout():
    return FlatLayout([("c.w", (5, 3, 3, 3)), ("c.b", (5,)),
                       ("odd", (37,))], convs=["c.w"])


def _zoo_layout():
    return FlatLayout.of_payload({"head/out/b": torch.zeros(3),
                                  "head/proj/lora_A": torch.zeros(16, 4),
                                  "head/proj/lora_B": torch.zeros(4, 16)})


def _layouts():
    return {"small": _small_layout(), "cnn": tp.tiny_model()[1],
            "zoo": _zoo_layout()}


def _ref_tree(layout, flat):
    return jax.tree.map(jnp.asarray, to_reference_tree(layout, flat))


@pytest.mark.parametrize("name", ["small", "cnn", "zoo"])
@pytest.mark.parametrize("mask", [[0, 0, 0, 0], [0, 1, 0, 0], [1, 1, 1, 1]])
def test_flip_pattern_bit_equal_to_reference(partitionable, name, mask):
    layout = _layouts()[name]
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(
        rng.normal(0, 1, (N, layout.size)).astype(np.float32))
    corrupt = np.asarray(mask, bool)
    want = jsig.flip_payload_bits(_ref_tree(layout, flat),
                                  jnp.asarray(corrupt), jsig.plan_key(9, 4))
    got = flip_payload_bits(flat, torch.from_numpy(corrupt), plan_key(9, 4),
                            layout)
    want_flat = from_reference(layout, jax.tree.map(np.asarray, want),
                               lead=1)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want_flat.numpy().view(np.uint32))
    changed = (got != flat).any(1).numpy()
    np.testing.assert_array_equal(changed, corrupt)
    assert torch.isfinite(got).all()
    # every injected flip is caught, in both packages, with equal sums
    ok = (comms.payload_checksum(got, layout)
          == comms.payload_checksum(flat, layout)).numpy()
    np.testing.assert_array_equal(ok, ~corrupt)
    np.testing.assert_array_equal(
        comms.payload_checksum(got, layout).numpy(),
        np.asarray(jcomms.payload_checksum(want)).astype(np.int64))


def test_flip_is_deterministic_and_keyed():
    layout = _small_layout()
    flat = torch.randn(N, layout.size, generator=torch.Generator()
                       .manual_seed(0))
    corrupt = torch.tensor([False, True, False, True])
    a = flip_payload_bits(flat, corrupt, plan_key(9, 4), layout)
    b = flip_payload_bits(flat, corrupt, plan_key(9, 4), layout)
    c = flip_payload_bits(flat, corrupt, plan_key(9, 5), layout)
    assert torch.equal(a, b) and not torch.equal(a, c)
    ref = comms.ref_index(layout)
    assert torch.equal(flip_payload_bits(flat, corrupt, plan_key(9, 4), ref),
                       a)


def test_idle_signals_flip_nothing():
    layout = _small_layout()
    flat = torch.randn(N, layout.size)
    sig = idle_signals(N)
    assert flip_payload_bits(flat, sig.corrupt, sig.key, layout) is flat


# ---------------------------------------------------------------------------
# the reference's fault tests on the pull-to-target toy
# ---------------------------------------------------------------------------

def _pull_step(p, o, b, s):
    """x ← x + 0.1·(target − x): the oracle's linear local step."""
    g = p - b
    return p - 0.1 * g, o, {"loss": (g * g).sum()}


def _id_step(p, o, b, s):
    return p, o, {"loss": 0.0 * p.sum()}


def _accept_eval(p, v):
    return 1.0 - 0.0 * p.sum(1)


def _cfg(**kw):
    kw.setdefault("n_nodes", N)
    kw.setdefault("sync_every", 2)
    kw.setdefault("merge", "fedavg")
    kw.setdefault("topology", "full")
    kw.setdefault("lora_only", False)
    kw.setdefault("val_threshold", 0.0)
    return SwarmConfig(**kw)


def _targets(d=8):
    return np.stack([np.full((d,), t, np.float32) for t in range(N)])


def _session(cfg, train_step=_pull_step, eval_fn=_accept_eval, *,
             params=None):
    """A toy session; ``params`` [N, D] numpy rows, or zeros [8] shared."""
    params = (torch.zeros(8) if params is None
              else [torch.from_numpy(np.asarray(r, np.float32))
                    for r in params])
    return SwarmSession(cfg, train_step, eval_fn, params=params,
                        data_sizes=SIZES, device="cpu")


VAL = np.zeros((N, 1), np.float32)


@pytest.mark.parametrize("merge,topology", [
    ("fedavg", "full"), ("fedavg", "ring"),
    ("fisher", "full"), ("fisher", "ring"),
    ("gradmatch", "full"),
])
def test_fault_trajectory_matches_oracle(merge, topology):
    """crash+rejoin / straggle / drop against the float64 oracle: the full
    committed-params trajectory, every round, ≤2e-5."""
    plan = (FaultPlan(N, 7)
            .crash(1, at=1, rejoin=3)
            .straggle(3, at=4, rounds=1)
            .drop(0, at=5))
    cfg = _cfg(merge=merge, topology=topology)
    sess = _session(cfg)
    targets = _targets()
    batches = np.broadcast_to(targets, (cfg.sync_every, N, 8)).copy()
    traj = []
    _, logs = run_plan(sess, plan, batches, VAL,
                       on_round=lambda r, lg: traj.append(
                           sess.state.params.numpy().copy()))
    assert all(not lg["gates"][~lg["active"]].any() for lg in logs)
    want = oracle.simulate(
        np.zeros((N, 8)), targets, plan.lower().active,
        merge=merge, topology=topology, lr=0.1,
        steps_per_round=cfg.sync_every, data_sizes=SIZES,
        fisher_decay=cfg.fisher_decay)
    assert len(traj) == plan.n_rounds
    for r, (got, exp) in enumerate(zip(traj, want)):
        np.testing.assert_allclose(got, exp, atol=2e-5,
                                   err_msg=f"round {r} diverged from oracle")


def _settled_int8_state(merge, topology, path, *, plan=None, rounds=6):
    """Reject-gate rounds (val_threshold 1.5 > any relative metric) freeze
    the params while the EF wire telescopes onto them — optionally under a
    fault plan; the state is saved to ``path``."""
    cfg = _cfg(merge=merge, topology=topology, sync_every=1,
               val_threshold=1.5, wire_dtype="int8", wire_block=128)
    x0 = np.random.default_rng(11).normal(0, 1, (N, 128)).astype(np.float32)
    sess = _session(cfg, train_step=_id_step, params=x0)
    batches = np.zeros((1, N, 8), np.float32)
    if plan is not None:
        sess, logs = run_plan(sess, plan, batches, VAL)
        assert not any(lg["gates"].any() for lg in logs)
    else:
        for _ in range(rounds):
            out = sess.round(batches, VAL)
            assert not out["gates"].any()
    np.testing.assert_array_equal(sess.state.params.numpy(), x0)
    sess.save(path)
    accept = _session(dataclasses.replace(cfg, val_threshold=0.0),
                      train_step=_id_step, params=np.zeros((N, 128)))
    return accept.load(path), x0


@pytest.mark.parametrize("merge,topology", [("fedavg", "full"),
                                            ("fisher", "ring")])
def test_int8_crash_rejoin_settled_parity(tmp_path, merge, topology):
    """crash → rejoin (EF quarantine) on the quantized wire: after the
    residual re-settles, one accepting round commits ≤1e-5 of the oracle."""
    plan = FaultPlan(N, 8).crash(1, at=1, rejoin=2)
    accept, x0 = _settled_int8_state(merge, topology,
                                     str(tmp_path / "s.msgpack"), plan=plan)
    out = accept.round(np.zeros((1, N, 8), np.float32), VAL)
    assert out["gates"].all()
    want = oracle.commit(x0, oracle.merge_candidate(
        x0, np.ones(N, bool), merge=merge, topology=topology,
        data_sizes=SIZES), np.ones(N, bool))
    np.testing.assert_allclose(accept.state.params.numpy(), want, atol=1e-5)


def test_corrupt_wire_quarantines_sender_and_matches_oracle(tmp_path):
    """An injected bit flip is detected (wire_ok), the sender is excluded
    from the merge AND keeps its own locals bit for bit, and the survivors'
    commit matches the oracle merge over the clean membership ≤1e-5."""
    accept, x0 = _settled_int8_state("fedavg", "full",
                                     str(tmp_path / "s.msgpack"))
    faults = FaultSignals(corrupt=torch.tensor([False, False, True, False]),
                          key=plan_key(7, 0))
    out = accept.round(np.zeros((1, N, 8), np.float32), VAL, faults=faults)
    clean = np.asarray([True, True, False, True])
    np.testing.assert_array_equal(out["wire_ok"].numpy(), clean)
    np.testing.assert_array_equal(out["gates"].numpy(), clean)
    got = accept.state.params.numpy()
    want = oracle.commit(x0, oracle.merge_candidate(
        x0, clean, merge="fedavg", topology="full", data_sizes=SIZES), clean)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[2].view(np.uint32),
                                  x0[2].view(np.uint32))


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_corrupt_wire_on_the_zoo_payload_and_bf16(wire):
    """The adapter payload's layout (flat path-keyed leaves) on either
    quantized wire: the flagged sender is caught and keeps its row."""
    layout = _zoo_layout()
    cfg = _cfg(sync_every=1, wire_dtype=wire, wire_block=128,
               payload="lora")
    rows = np.random.default_rng(2).normal(0, 1, (N, layout.size))
    sess = SwarmSession(cfg, _id_step, _accept_eval,
                        params=[torch.from_numpy(r.astype(np.float32))
                                for r in rows],
                        data_sizes=SIZES, layout=layout, device="cpu")
    before = sess.state.params.clone()
    out = sess.round(np.zeros((1, N, 8), np.float32), VAL,
                     faults=FaultSignals(torch.tensor([1, 0, 0, 0], dtype=
                                                      torch.bool),
                                         plan_key(3, 2)))
    np.testing.assert_array_equal(out["wire_ok"].numpy(), [0, 1, 1, 1])
    np.testing.assert_array_equal(out["gates"].numpy(), [0, 1, 1, 1])
    assert torch.equal(sess.state.params[0], before[0])


def test_faults_rejected_off_the_wire_path():
    sess = _session(_cfg())                          # f32: no wire state
    before = sess.state.params.clone()
    with pytest.raises(ValueError, match="corrupt-wire injection"):
        sess.round(np.zeros((2, N, 8), np.float32), VAL,
                   faults=idle_signals(N))
    # refused before any local step ran
    assert sess.state.step == 0 and sess.state.round == 0
    assert torch.equal(sess.state.params, before)


def test_whole_plan_runs_the_train_step_once_per_step():
    """crash, straggle, drop AND corrupt across 8 rounds: the vmapped step
    runs exactly rounds × T times (the eager counterpart of the reference's
    one compiled round), and each round's wire_ok flags only its corrupt
    sender."""
    calls = []

    def counting_step(p, o, b, s):
        calls.append(1)
        return _id_step(p, o, b, s)

    cfg = _cfg(sync_every=2, val_threshold=1.5, wire_dtype="int8",
               wire_block=128, quorum=2)
    sess = _session(cfg, train_step=counting_step,
                    params=np.stack([_targets(128)[i] for i in range(N)]))
    plan = (FaultPlan(N, 8, seed=1)
            .crash(1, at=1, rejoin=3)
            .straggle(3, at=2, rounds=2)
            .drop(0, at=5)
            .corrupt(2, at=6))
    _, logs = run_plan(sess, plan, np.zeros((2, N, 8), np.float32), VAL)
    assert len(calls) == plan.n_rounds * cfg.sync_every
    for lg in logs:
        np.testing.assert_array_equal(lg["wire_ok"], ~lg["corrupt"])
        assert not lg["gates"][~lg["active"]].any()
    assert logs[6]["corrupt"][2] and not logs[6]["wire_ok"][2]


def test_preempt_restore_is_bit_identical(tmp_path):
    """preempt-and-restore mid-plan (save → fresh session → load) == the
    uninterrupted twin, bit for bit — params, EF wire, rng, counters."""
    def make(cfg):
        return lambda: _session(cfg, params=np.zeros((N, 128)))

    def run(with_preempt):
        cfg = _cfg(sync_every=1, wire_dtype="int8", wire_block=128)
        plan = FaultPlan(N, 6).crash(2, at=1, rejoin=4)
        if with_preempt:
            plan = plan.preempt(at=3)
        sess = make(cfg)()
        batches = np.broadcast_to(_targets(128), (1, N, 128)).copy()
        sess, logs = run_plan(sess, plan, batches, VAL,
                              make_session=make(cfg),
                              checkpoint_path=str(tmp_path / "p.msgpack"))
        return sess.state, logs

    a, logs_a = run(with_preempt=True)
    b, logs_b = run(with_preempt=False)
    assert any(lg["preempted"] for lg in logs_a)
    assert torch.equal(a.params, b.params) and torch.equal(a.wire, b.wire)
    np.testing.assert_array_equal(a.rng, b.rng)
    assert (a.round, a.step) == (b.round, b.step)
    for la, lb in zip(logs_a, logs_b):
        np.testing.assert_array_equal(la["gates"], lb["gates"])


def test_run_plan_requires_preempt_plumbing():
    sess = _session(_cfg())
    with pytest.raises(ValueError, match="preempt"):
        run_plan(sess, FaultPlan(N, 3).preempt(at=1),
                 np.zeros((2, N, 8), np.float32), VAL)


def test_run_plan_checks_node_count():
    sess = _session(_cfg())
    with pytest.raises(ValueError, match="nodes"):
        run_plan(sess, FaultPlan(N + 1, 3), np.zeros((2, N, 8), np.float32),
                 VAL)


# ---------------------------------------------------------------------------
# paired small-CNN sessions: an armed and an idle round on the int8 wire
# ---------------------------------------------------------------------------

def test_armed_and_idle_rounds_match_reference(partitionable):
    kw = dict(n_nodes=N, sync_every=2, topology="full", merge="fedavg",
              lora_only=False, val_threshold=tp.THR, wire_dtype="int8",
              wire_block=128)
    js, ts, layout = tp.sessions(kw, seed=3)
    xs, ys, val = tp.round_data(6, t=2, r=2)
    jval = tuple(jnp.asarray(v) for v in val)
    corrupt = np.asarray([False, True, False, False])
    signals = [(jsig.FaultSignals(jnp.asarray(corrupt), jsig.plan_key(7, 0)),
                FaultSignals(torch.from_numpy(corrupt), plan_key(7, 0))),
               (jsig.idle_signals(N), idle_signals(N))]
    wire_ok = []
    for r, (jf, tf) in enumerate(signals):
        jlog = js.round((jnp.asarray(xs[r]), jnp.asarray(ys[r])), jval,
                        faults=jf)
        tlog = ts.round((xs[r], ys[r]), val, faults=tf)
        tp.check_round(js, ts, layout, jlog, tlog)
        np.testing.assert_array_equal(tlog["wire_ok"].numpy(),
                                      np.asarray(jlog["wire_ok"]))
        np.testing.assert_array_equal(tlog["gates"].numpy(),
                                      np.asarray(jlog["gates"]))
        wire_ok.append(tlog["wire_ok"].numpy())
    np.testing.assert_array_equal(wire_ok, [~corrupt, np.ones(N, bool)])
    np.testing.assert_array_equal(np.asarray(js.state.rng), ts.state.rng)


# ---------------------------------------------------------------------------
# the true-Fisher hook: a 4-tuple train step feeds F ← γF + g²
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_four_tuple_train_step_matches_reference(wire):
    decay = 0.5

    def jstep(p, o, b, s):
        g = p["x"] - b
        return {"x": p["x"] - 0.1 * g}, o, {"loss": jnp.sum(g * g)}, {"x": g}

    def tstep(p, o, b, s):
        g = p - b
        return p - 0.1 * g, o, {"loss": (g * g).sum()}, g

    kw = dict(n_nodes=N, sync_every=2, merge="fisher", topology="ring",
              lora_only=False, val_threshold=0.0, fisher_decay=decay,
              wire_dtype=wire, wire_block=128)
    x0 = np.random.default_rng(4).normal(0, 1, (N, 256)).astype(np.float32)
    js = JSession(JSwarmConfig(**kw), jstep,
                  lambda p, v: 1.0 - 0.0 * jnp.sum(p["x"]),
                  params={"x": jnp.asarray(x0)}, stacked=True,
                  data_sizes=SIZES)
    ts = _session(SwarmConfig(**kw), train_step=tstep, params=x0)
    targets = np.stack([np.linspace(-1, 1, 256, dtype=np.float32) * (i + 1)
                        for i in range(N)])
    batches = np.broadcast_to(targets, (2, N, 256)).copy()
    for _ in range(2):
        jlog = js.round(jnp.asarray(batches), jnp.asarray(VAL))
        tlog = ts.round(batches, VAL)
        np.testing.assert_array_equal(tlog["gates"].numpy(),
                                      np.asarray(jlog["gates"]))
        np.testing.assert_allclose(ts.state.stats.numpy(),
                                   np.asarray(js.state.stats["x"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.state.params.numpy(),
                                   np.asarray(js.state.params["x"]),
                                   atol=1e-5)
    # the exact squared gradients, not the Δθ² proxy: γ·g0² + g1² per node
    # over the first two steps from θ0 = x0 (the step's own f32 arithmetic)
    one = _session(SwarmConfig(**kw), train_step=tstep, params=x0)
    _, _, stats, _ = one.engine.local_steps(
        torch.from_numpy(x0), None, torch.from_numpy(batches), 0,
        one.engine.init_stats(torch.from_numpy(x0)))
    g0 = x0 - targets
    g1 = (x0 - np.float32(0.1) * g0) - targets
    np.testing.assert_allclose(stats.numpy(),
                               np.float32(decay) * g0 ** 2 + g1 ** 2,
                               rtol=1e-6)
