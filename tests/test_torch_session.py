"""The port's SwarmSession (engine backend) against the reference, from the
same carried-across state and batches: params at 1e-4 after whole rounds,
gate bits equal (a node whose reference gate margin |merged − 0.8·local| is
below 1e-4 is left out of the bit comparison), membership masks, the
stale-by-one ``overlap_sync`` schedule, the int8/bf16 error-feedback wire
(params and wire reference), and the options this slice does not port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.core.session import SwarmSession  # noqa: E402

tp.torch_cpu()
SIZES = tp.SIZES
THR = tp.THR
_check_flat, _check = tp.check_flat, tp.check_round


@pytest.mark.parametrize("merge,topology", [("fedavg", "full"),
                                            ("fisher", "ring")])
def test_round_then_leave_round_matches_reference(merge, topology):
    kw = dict(n_nodes=4, sync_every=3, topology=topology, merge=merge,
              lora_only=False, val_threshold=THR)
    js, ts, layout = tp.sessions(kw)
    xs, ys, val = tp.round_data(1, r=2)
    jval = tuple(jnp.asarray(v) for v in val)
    for r in range(2):
        if r == 1:            # membership is runtime data on both sides
            js.leave(2)
            ts.leave(2)
        batch = (xs[r], ys[r])
        jlog = js.round(tuple(jnp.asarray(b) for b in batch), jval)
        tlog = ts.round(batch, val)
        _check(js, ts, layout, jlog, tlog)
    assert not tlog["gates"][2]             # a departed node never commits
    assert ts.state.round == 2 and ts.state.step == 6
    ts.join(2)
    assert ts.active.tolist() == [True] * 4
    ts.set_active([True, False, True, False])
    assert ts.active.tolist() == [True, False, True, False]


def test_overlap_sync_run_rounds_matches_reference():
    kw = dict(n_nodes=4, sync_every=2, topology="full", merge="fedavg",
              lora_only=False, val_threshold=THR, overlap_sync=True)
    js, ts, layout = tp.sessions(kw, seed=2)
    xs, ys, val = tp.round_data(3, t=2, r=2)
    jlog = js.run_rounds((jnp.asarray(xs), jnp.asarray(ys)),
                         tuple(jnp.asarray(v) for v in val))
    tlog = ts.run_rounds((xs, ys), val)
    assert tlog["gates"].shape == (2, 4) and tlog["train"]["loss"].shape == (2, 2, 4)
    _check(js, ts, layout, jlog, tlog)
    node = ts.node_params
    assert len(node) == 4 and set(node[0]) == {"stem", "blocks", "head"}
    assert node[0]["stem"]["w"].shape == (7, 7, 3, 8)   # HWIO, as the reference


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(lora_only=True), None, id="kw0-lora_only"),
    pytest.param(dict(payload="lora", lora_only=False), None,
                 id="kw1-payload"),
])
def test_unported_sync_options_raise_when_sync_runs(kw, match):
    """The session builds and trains locally with these options (the
    reference's local baseline keeps lora_only=True and never syncs), and
    both are ported now: ``lora_only`` with ``payload="full"`` carves the
    adapters out of the state at sync (the CNN has none, so nothing crosses
    the wire and the sync commits nothing, as the reference's); with
    ``payload="lora"`` the state is the payload, nothing is carved. The
    round matches the reference's."""
    base = dict(n_nodes=4, sync_every=2, topology="full", merge="fedavg",
                lora_only=False)
    js, ts, layout = tp.sessions(dict(base, **kw))
    xs, ys, val = tp.round_data(4, t=2)
    ts.run_local((xs[0], ys[0]))
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            ts.round((xs[0], ys[0]), val)
        return
    js.run_local((jnp.asarray(xs[0]), jnp.asarray(ys[0])))
    jlog = js.round((jnp.asarray(xs[0]), jnp.asarray(ys[0])),
                    tuple(jnp.asarray(v) for v in val))
    tlog = ts.round((xs[0], ys[0]), val)
    if not kw.get("lora_only"):
        _check(js, ts, layout, jlog, tlog)
        assert ts.payload_params == js.payload_params == layout.size
        return
    # no adapter to carve: the committed params are the local steps' own,
    # bit for bit (a twin that only trains), and the reference's; with no
    # merge to average it, AdamW's ±lr step on a gradient at the rounding
    # floor is held to the summed lr of the 4 warm-up steps (5e-4), as
    # check_flat holds the FC biases
    twin = tp.sessions(dict(base, **kw))[1]
    for _ in range(2):
        twin.run_local((xs[0], ys[0]))
    assert torch.equal(ts.state.params, twin.state.params)
    np.testing.assert_array_equal(tlog["gates"].numpy(),
                                  np.asarray(jlog["gates"]))
    np.testing.assert_allclose(tlog["metric_merged"].numpy(),
                               tlog["metric_local"].numpy())
    np.testing.assert_allclose(tlog["metric_local"].numpy(),
                               np.asarray(jlog["metric_local"]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(
        ts.state.params.numpy(),
        tp.from_reference(layout, jax.tree.map(np.asarray, js.state.params),
                          lead=1).numpy(), atol=5e-4)
    assert ts.payload_params == js.payload_params == 0


@pytest.mark.parametrize("wire,merge,topology", [
    ("int8", "fedavg", "full"), ("int8", "fisher", "ring"),
    ("int8", "gradmatch", "dynamic"), ("bf16", "fedavg", "full")])
def test_wire_rounds_match_reference(wire, merge, topology):
    """Rounds on the int8/bf16 error-feedback wire from the same carried
    state: params and the wire reference θ̂ at the tolerances above after
    every round, gates equal, the rng folded as the reference folds it."""
    kw = dict(n_nodes=4, sync_every=2, topology=topology, merge=merge,
              lora_only=False, val_threshold=THR, wire_dtype=wire,
              wire_block=128)
    js, ts, layout = tp.sessions(kw, seed=4)
    xs, ys, val = tp.round_data(5, t=2, r=3)
    jval = tuple(jnp.asarray(v) for v in val)
    for r in range(3):
        batch = (xs[r], ys[r])
        jlog = js.round(tuple(jnp.asarray(b) for b in batch), jval)
        tlog = ts.round(batch, val)
        _check(js, ts, layout, jlog, tlog)
    np.testing.assert_array_equal(ts.state.rng, np.asarray(js.state.rng))
    assert (dataclasses.asdict(ts.sync_schedule)
            == dataclasses.asdict(js.sync_schedule))
    assert ts.payload_params == js.payload_params
    assert ts.predicted_link_bytes == js.predicted_link_bytes


def test_unported_backends_and_device_policy():
    cfg = SwarmConfig(n_nodes=2)
    flat = torch.zeros(3)
    # the gossip backend needs its mesh and axis, as the reference's does
    with pytest.raises(ValueError, match="gossip backend needs mesh and axis"):
        SwarmSession(cfg, None, None, params=flat, backend="gossip",
                     device="cpu")
    # closure lists (model zoo): one per node, engine backend only
    with pytest.raises(ValueError, match="one closure per node"):
        SwarmSession(cfg, [None], None, params=flat, device="cpu")
    for backend in ("gossip", "host"):
        with pytest.raises(ValueError, match="engine-backend only"):
            SwarmSession(cfg, [None, None], None, params=flat,
                         backend=backend, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SwarmSession(cfg, None, None, params=flat)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            SwarmSession(cfg, None, None, params=flat, device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("merge,topology", [("fedavg", "full"),
                                            ("mean", "ring"),
                                            ("fisher", "ring"),
                                            ("gradmatch", "dynamic")])
@pytest.mark.parametrize("policy", [dict(), dict(quorum=4),
                                    dict(fairness_floor=0.5),
                                    dict(val_threshold=1.0)])
@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 1]])
def test_engine_sync_matches_reference(merge, topology, policy, mask):
    """One sync (propose → gate with quorum / fairness floor → commit) on
    both engines from the same params and importance statistics, with a
    gate metric that is a smooth function of the params."""
    from repro.core.engine import SwarmEngine as JEngine
    from repro_torch.core.engine import SwarmEngine

    rng = np.random.default_rng(len(policy) * 7 + sum(mask))
    x = rng.normal(0.2, 1, (4, 300)).astype(np.float32)
    stats = np.abs(rng.normal(0, 1, (4, 300))).astype(np.float32)
    kw = dict(dict(n_nodes=4, merge=merge, topology=topology,
                   lora_only=False, val_threshold=0.8), **policy)
    je = JEngine(JSwarmConfig(**kw), None,
                 lambda p, v: jax.nn.sigmoid(4 * p["w"].mean() + v),
                 data_sizes=SIZES)
    te = SwarmEngine(SwarmConfig(**kw), None,
                     lambda p, v: torch.sigmoid(4 * p.mean(-1) + v),
                     data_sizes=SIZES)
    use_stats = je.strategy.uses_stats
    val = rng.normal(0, 0.3, (4,)).astype(np.float32)
    jc, jlog = je.sync({"w": jnp.asarray(x)}, jnp.asarray(val),
                       jnp.asarray(mask, bool),
                       stats={"w": jnp.asarray(stats)} if use_stats else None)
    tc, tlog = te.sync(torch.from_numpy(x), torch.from_numpy(val),
                       torch.tensor(mask, dtype=torch.bool),
                       stats=torch.from_numpy(stats) if use_stats else None)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc["w"]), rtol=2e-6,
                               atol=2e-6)
    assert set(tlog) == set(jlog)
    for key in jlog:
        np.testing.assert_allclose(np.asarray(tlog[key], np.float32),
                                   np.asarray(jlog[key], np.float32),
                                   rtol=1e-6, atol=1e-6)
    rejected = ~tlog["gates"]
    assert torch.equal(tc[rejected], torch.from_numpy(x)[rejected])
