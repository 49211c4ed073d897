"""The port's heterogeneous model-zoo swarm (``payload="lora"``) against the
reference: the zoo's logits per family from carried weights (1e-5) and the
gradients that reach only the payload, the per-node closure dispatch
(``zoo_vstep``/``zoo_veval``), a ``payload="lora"`` session against the
reference's analytic decay closures on the f32 and int8 wires (payload rows
at 1e-4, gates equal) with membership, the fairness floor and quorum,
payload-mode checkpoints bit-identical in both directions between the
packages, the scenario grid's shards, and one ``run_scenario`` row from a
carried zoo at 2e-3 (tests/test_hetero.py's small config)."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.core.engine import zoo_veval as j_zoo_veval  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.data import dirichlet_shards as j_dirichlet  # noqa: E402
from repro.data import make_histo_dataset as j_make_histo  # noqa: E402
from repro.experiments import scenarios as js  # noqa: E402
from repro.models import zoo as jz  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.core import comms  # noqa: E402
from repro_torch.core.engine import zoo_veval, zoo_vstep  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.core.session import SwarmSession  # noqa: E402
from repro_torch.data import dirichlet_shards  # noqa: E402
from repro_torch.experiments import scenarios as ts  # noqa: E402
from repro_torch.models import zoo as tz  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

torch.set_num_threads(2)
N = 4
KEYS = ["head/out/b", "head/out/w", "head/proj/lora_A", "head/proj/lora_B",
        "head/proj/lora_scale"]


def _jzoo(feat_dim=8, hidden=8, rank=2, seed=0):
    return jz.build_zoo(jax.random.PRNGKey(seed), N, image_size=16,
                        feat_dim=feat_dim, hidden=hidden, rank=rank)


def _carry(jnodes, feat_dim=8):
    return [convert.zoo_node_from_reference(
        nd.family, jax.tree.map(np.asarray, nd.template), feat_dim=feat_dim)
        for nd in jnodes]


@pytest.fixture(scope="module")
def zoos():
    jnodes = _jzoo()
    return jnodes, _carry(jnodes)


def _live_payload(jnode, seed):
    """The node's payload with every leaf moved off its init (a non-zero
    lora_B, so the low-rank path counts), as numpy."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.3 * rng.normal(0, 1, np.shape(v))).astype(
        np.float32) for k, v in jnode.payload().items()}


def test_zoo_logits_and_payload_grads_match_reference(zoos):
    jnodes, tnodes = zoos
    x = np.random.default_rng(0).normal(0, 1, (10, 16, 16, 3)).astype(
        np.float32)
    y = np.arange(10) % 3
    assert [n.family for n in tnodes] == list(tz.DEFAULT_FAMILIES)
    for i, (jn, tn) in enumerate(zip(jnodes, tnodes)):
        assert list(tn.payload()) == KEYS
        pl = _live_payload(jn, i)
        want = np.asarray(jn.apply({k: jnp.asarray(v) for k, v in pl.items()},
                                   jnp.asarray(x)))
        tpl = {k: torch.from_numpy(np.array(v)) for k, v in pl.items()}
        got = tn.apply(tpl, torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=tn.family)

        def jloss(p):
            return jnp.mean((jn.apply(p, jnp.asarray(x))
                             - jax.nn.one_hot(y, 3)) ** 2)

        jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in pl.items()})
        layout = FlatLayout.of_payload(tpl)
        onehot = torch.nn.functional.one_hot(torch.from_numpy(y), 3).float()

        def tloss(row):
            return torch.mean((tn.apply(layout.unflatten(row),
                                        torch.from_numpy(x)) - onehot) ** 2)

        g = layout.unflatten(torch.func.grad(tloss)(layout.flatten(tpl)))
        for k in KEYS:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{tn.family} {k}")
        # the frozen template never takes a gradient
        assert not any(t.requires_grad for t in tz.flatten_payload(
            tn.template, lambda p: True).values())


def test_port_zoo_builds_four_families_at_scenario_width():
    nodes = tz.build_zoo(torch.Generator().manual_seed(0), N, feat_dim=16,
                         hidden=16, rank=4)
    rows = [FlatLayout.of_payload(nd.payload()).flatten(nd.payload())
            for nd in nodes]
    assert [nd.family for nd in nodes] == list(tz.DEFAULT_FAMILIES)
    assert rows[0].numel() == 180
    for r in rows[1:]:
        assert torch.equal(r, rows[0])         # one shared head
    logits = nodes[2].apply(nodes[2].payload(), torch.zeros(3, 16, 16, 3))
    assert logits.shape == (3, 3)
    with pytest.raises(ValueError, match="unknown zoo family"):
        tz.build_backbone("resnet", torch.Generator(), image_size=16,
                          feat_dim=8)


def test_zoo_vstep_veval_dispatch():
    def step(scale):
        return lambda p, o, b, s: (p * scale + b, o, {"loss": p.sum()})

    p = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.ones(2, 3)
    out = zoo_vstep([step(1.0), step(2.0)])(p, None, b, 0)
    assert out[1] is None
    assert torch.equal(out[0], torch.stack([p[0] + 1, p[1] * 2 + 1]))
    assert torch.equal(out[2]["loss"], p.sum(1))

    def four(p, o, b, s):
        return p, o, {}, p

    with pytest.raises(ValueError, match="3-tuple vs"):
        zoo_vstep([step(1.0), four])(p, None, b, 0)
    # steps that update their rows in place (AdamW's in-place form) hand
    # back the stacked input itself: its storage is kept
    in_place = [lambda p, o, b, s: (p.add_(b), o, {"loss": p.sum()})] * 2
    q = p.clone()
    out = zoo_vstep(in_place)(q, None, b, 0)
    assert out[0] is q and torch.equal(q, p + 1)
    got = zoo_veval([lambda p, v: torch.tensor(0.25),
                     lambda p, v: p.sum() * 0 + v[0]])(p, torch.tensor(
                         [[0.5], [0.75]]))
    want = j_zoo_veval([lambda p, v: jnp.asarray(0.25),
                        lambda p, v: v[0]])(jnp.asarray(p.numpy()),
                                            jnp.asarray([[0.5], [0.75]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# payload="lora" sessions against the reference's analytic decay closures
# (tests/test_hetero.py::_payload_session)
# ---------------------------------------------------------------------------

SIZES = [10.0 * (i + 1) for i in range(N)]


def _jsession(cfg, payloads, metric_vals=None, decay=0.01, opt=False):
    def make(i):
        def step(p, o, b, s):
            return ({k: v * (1.0 - decay) for k, v in p.items()}, o,
                    {"loss": 0.0 * jnp.sum(p["head/out/w"])})

        def ev(p, v):
            c = 1.0 if metric_vals is None else metric_vals[i]
            return c - 0.0 * jnp.sum(p["head/out/w"])

        return step, ev

    fns = [make(i) for i in range(N)]
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in payloads]
    return JSession(JSwarmConfig(**cfg), [f[0] for f in fns],
                    [f[1] for f in fns], params=jp,
                    opt_state=[jadamw_init(p) for p in jp] if opt else None,
                    data_sizes=SIZES, seed=0)


def _tsession(cfg, payloads, metric_vals=None, decay=0.01, opt=False):
    def make(i):
        def step(p, o, b, s):
            return p * (1.0 - decay), o, {"loss": 0.0 * p.sum()}

        def ev(p, v):
            c = 1.0 if metric_vals is None else metric_vals[i]
            return c - 0.0 * p.sum()

        return step, ev

    fns = [make(i) for i in range(N)]
    layout = FlatLayout.of_payload(payloads[0])
    rows = [layout.flatten({k: torch.from_numpy(np.array(v))
                            for k, v in p.items()}) for p in payloads]
    return SwarmSession(SwarmConfig(**cfg), [f[0] for f in fns],
                        [f[1] for f in fns], params=rows,
                        opt_state=[adamw_init(r) for r in rows] if opt
                        else None, data_sizes=SIZES, layout=layout,
                        device="cpu", seed=0)


def _cfg(**kw):
    base = dict(n_nodes=N, sync_every=2, merge="fedavg", topology="full",
                lora_only=False, val_threshold=0.0, payload="lora")
    return dict(base, **kw)


def _payloads(zoos):
    return [_live_payload(jn, 10 + i) for i, jn in enumerate(zoos[0])]


def _rows(sess_state_params, layout):
    return convert.from_reference(
        layout, jax.tree.map(np.asarray, sess_state_params), lead=1).numpy()


def _compare(js_, ts_, jlog, tlog):
    layout = ts_.layout
    np.testing.assert_allclose(ts_.state.params.numpy(),
                               _rows(js_.state.params, layout),
                               rtol=1e-4, atol=1e-4)
    if js_.state.wire is not None:
        np.testing.assert_allclose(ts_.state.wire.numpy(),
                                   _rows(js_.state.wire, layout),
                                   rtol=1e-4, atol=1e-4)
    for key in ("gates", "fairness_ok", "quorum_ok"):
        assert (key in jlog) == (key in tlog), key
        if key in jlog:
            np.testing.assert_array_equal(tlog[key].numpy(),
                                          np.asarray(jlog[key]), err_msg=key)
    if "worst_site" in jlog:
        np.testing.assert_allclose(float(tlog["worst_site"]),
                                   float(jlog["worst_site"]), rtol=1e-6)


# (config, metric values, membership script: ops before each round)
PLANS = {
    "membership": (dict(topology="ring"), None,
                   [[], [("leave", 2)], [("join", 2), ("leave", 0)]]),
    "fairness": (dict(fairness_floor=0.3), [0.2, 0.4, 0.6, 0.8],
                 [[], [("leave", 0)]]),
    "quorum": (dict(fairness_floor=0.3, quorum=4), [0.5] * N,
               [[], [("leave", 3)]]),
}


@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_payload_session_matches_reference(zoos, wire, plan):
    extra, metric_vals, script = PLANS[plan]
    wire_kw = {} if wire == "f32" else dict(wire_dtype="int8",
                                            wire_block=128)
    cfg = _cfg(**extra, **wire_kw)
    payloads = _payloads(zoos)
    js_ = _jsession(cfg, payloads, metric_vals)
    ts_ = _tsession(cfg, payloads, metric_vals)
    # feat 8, hidden 8, rank 2: out/b 3 + out/w 24 + A 16 + B 16 + scale 1
    assert ts_.payload_params == js_.payload_params == 60
    assert ts_.sync_schedule.payload == js_.sync_schedule.payload == "lora"
    assert ts_.predicted_sync_bytes == js_.predicted_sync_bytes
    batches = np.zeros((cfg["sync_every"], N, 1), np.float32)
    val = np.zeros((N, 1), np.float32)
    for ops in script:
        for op, node in ops:
            getattr(js_, op)(node)
            getattr(ts_, op)(node)
        jlog = js_.round(jnp.asarray(batches), jnp.asarray(val))
        tlog = ts_.round(batches, val)
        _compare(js_, ts_, jlog, tlog)
    assert np.array_equal(ts_.active, js_.active)
    node = ts_.node_params[1]
    assert sorted(node) == KEYS and node["head/proj/lora_scale"].shape == ()


def test_payload_paths_pass_convert_and_wire_grid_unchanged(zoos):
    """The ``/``-joined payload paths are single keys for `convert` (which
    splits on ``.``) and for the wire grid's leaf order: the reference tree
    round-trips, and the int8 round-trip on the payload's per-leaf grid
    equals the reference's ``quant_dequant_tree`` bit for bit."""
    payloads = _payloads(zoos)
    layout = FlatLayout.of_payload(payloads[0])
    assert [lf.path for lf in layout.leaves] == KEYS
    assert sorted(KEYS, key=comms._ref_sort_key) == KEYS
    rows = torch.stack([layout.flatten({k: torch.from_numpy(np.array(v))
                                        for k, v in p.items()})
                        for p in payloads])
    tree = convert.to_reference_tree(layout, rows)
    assert sorted(tree) == KEYS and tree["head/proj/lora_scale"].shape == (N,)
    assert torch.equal(convert.from_reference(layout, tree, lead=1), rows)
    grid = comms.wire_grid(layout, "int8", 128)
    assert grid.perm is None and grid.segments.shape[0] == len(KEYS)
    want = jcomms.quant_dequant_tree(
        {k: jnp.asarray(v) for k, v in tree.items()}, "int8", 128)
    np.testing.assert_array_equal(
        comms.quant_dequant(rows, grid).numpy(),
        convert.from_reference(layout, jax.tree.map(np.asarray, want),
                               lead=1).numpy())


def _state_equal(ts_, js_):
    """The port's state equals the reference's bit for bit."""
    layout = ts_.layout
    st, jst = ts_.state, js_.state
    np.testing.assert_array_equal(st.params.numpy(),
                                  _rows(jst.params, layout))
    np.testing.assert_array_equal(st.wire.numpy(), _rows(jst.wire, layout))
    for k in ("mu", "nu"):
        np.testing.assert_array_equal(st.opt_state[k].numpy(),
                                      _rows(jst.opt_state[k], layout))
    np.testing.assert_array_equal(st.opt_state["count"].numpy(),
                                  np.asarray(jst.opt_state["count"]))
    np.testing.assert_array_equal(ts_.active, js_.active)
    np.testing.assert_array_equal(st.rng, np.asarray(jst.rng))
    assert (st.round, st.step) == (int(jst.round), int(jst.step))


def test_payload_checkpoints_cross_packages_bit_identical(zoos):
    """A payload-mode checkpoint (flat path-keyed params, AdamW moments and
    the int8 wire reference) restores bit for bit in the other package, in
    both directions; save → restore → continue in the port equals never
    stopping; a payload-mode mismatch is rejected."""
    cfg = _cfg(topology="ring", wire_dtype="int8", wire_block=128)
    payloads = _payloads(zoos)
    batches = np.zeros((2, N, 1), np.float32)
    val = np.zeros((N, 1), np.float32)
    tmp = tempfile.mkdtemp()

    js_ = _jsession(cfg, payloads, opt=True)
    for _ in range(2):
        js_.round(jnp.asarray(batches), jnp.asarray(val))
    js_.leave(1)
    path = os.path.join(tmp, "ref.msgpack")
    js_.save(path)
    ts_ = _tsession(cfg, payloads, opt=True).load(path)
    _state_equal(ts_, js_)

    ts2 = _tsession(cfg, payloads, opt=True)
    for _ in range(2):
        ts2.round(batches, val)
    ts2.leave(2)
    path2 = os.path.join(tmp, "port.msgpack")
    ts2.save(path2)
    js2 = _jsession(cfg, payloads, opt=True).load(path2)
    _state_equal(ts2, js2)

    # save → restore → continue == never stopping (the port alone)
    resumed = _tsession(cfg, payloads, opt=True).load(path2)
    ts2.round(batches, val)
    resumed.round(batches, val)
    assert torch.equal(resumed.state.params, ts2.state.params)
    assert torch.equal(resumed.state.wire, ts2.state.wire)

    other = _tsession(_cfg(topology="ring", wire_dtype="int8",
                           wire_block=128, payload="full"), payloads, opt=True)
    with pytest.raises(ValueError, match="payload"):
        other.load(path2)


def test_lora_only_full_payload_still_raises_at_sync(zoos):
    """lora_only with payload="full" carves the adapter leaves (``lora_``
    paths) out of the state at sync: only they merge and the rest passes
    through, as the reference's ``split_adapters`` does (this once raised,
    before the LM trainer's slice); payload="lora" needs no carving."""
    payloads = _payloads(zoos)
    cfg = _cfg(payload="full", lora_only=True)
    js, ts = _jsession(cfg, payloads), _tsession(cfg, payloads)
    batches, val = np.zeros((2, N, 1), np.float32), np.zeros((N, 1))
    jlog = js.round(jnp.asarray(batches), jnp.asarray(val))
    tlog = ts.round(batches, val)
    _compare(js, ts, jlog, tlog)
    adapters = sum(lf.size for lf in ts.layout.leaves
                   if "lora_" in lf.path)
    assert 0 < ts.payload_params == js.payload_params == adapters < 60
    sess = _tsession(_cfg(lora_only=True), payloads)    # payload="lora"
    sess.round(batches, val)
    assert sess.payload_params == 60


# ---------------------------------------------------------------------------
# the scenario grid
# ---------------------------------------------------------------------------

def test_build_shards_match_reference_for_every_partition():
    images, labels = j_make_histo(240, size=16, noise=1.1,
                                  class_probs=(0.5, 0.3, 0.2), seed=0)
    tcells, jcells = ts.scenario_grid(), js.scenario_grid()
    assert [c.name for c in tcells] == [c.name for c in jcells]
    for tc, jc in zip(tcells, jcells):
        assert tc == ts.Scenario(**{f: getattr(jc, f) for f in (
            "name", "partition", "bias", "alpha", "synth_frac", "fractions")})
        got, gn = ts.build_shards(tc, images, labels, N)
        want, wn = js.build_shards(jc, images, labels, N)
        assert gn == wn, tc.name
        for (x, y), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(x, wx, err_msg=tc.name)
            np.testing.assert_array_equal(y, wy, err_msg=tc.name)
    for alpha, seed in ((0.3, 0), (0.5, 3), (5.0, 1)):
        for (x, y), (wx, wy) in zip(
                dirichlet_shards(images, labels, N, alpha=alpha, seed=seed),
                j_dirichlet(images, labels, N, alpha=alpha, seed=seed)):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
    with pytest.raises(ValueError, match="unknown partition"):
        ts.build_shards(ts.Scenario("x", "bogus"), images, labels, N)


SMALL = dict(n_train=96, n_test=48, feat_dim=8, hidden=8, steps=8,
             batch_size=4)
SWARM = dict(n_nodes=4, sync_every=4, topology="ring", merge="fedavg",
             payload="lora", wire_dtype="int8", wire_block=128,
             val_threshold=0.0, gate_metric="auc", fairness_floor=0.05)


@pytest.fixture(scope="module")
def scenario_rows():
    """tests/test_hetero.py's small biased-label cell in both packages, the
    port's from the reference's zoo carried across."""
    jr = js.ScenarioRunConfig(**SMALL, swarm=JSwarmConfig(**SWARM))
    tr = ts.ScenarioRunConfig(**SMALL, swarm=SwarmConfig(**SWARM))
    jscn = next(s for s in js.scenario_grid() if s.partition == "label_skew")
    tscn = next(s for s in ts.scenario_grid() if s.partition == "label_skew")
    want = js.run_scenario(jscn, jr)
    nodes = _carry(_jzoo(feat_dim=8, hidden=8, rank=jr.lora_rank,
                         seed=jr.seed))
    return ts.run_scenario(tscn, tr, device="cpu", nodes=nodes), want


def _leaves(row, prefix=""):
    if isinstance(row, dict):
        for k, v in row.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(row, list):
        for i, v in enumerate(row):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, row


def test_scenario_row_matches_reference(scenario_rows):
    got, want = scenario_rows
    assert set(got) == set(want)
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert set(gl) == set(wl)
    for k, w in wl.items():
        g = gl[k]
        if isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3,
                                       err_msg=k)
        else:
            assert g == w, k
    assert got["payload_params"] == 3 + 24 + 32 + 32 + 1    # rank 4
    assert got["retraces"] == 0 and got["payload_class"] == "lora"
