"""The port's quantized error-feedback wire (`repro_torch.core.comms`)
against the reference's `repro.core.comms`: the int8/bf16 quant core bit for
bit, the per-leaf block grid over the flat ``[N, P]`` state (conv leaves in
the reference's HWIO order), the payload checksum, the cost model, the
plain quant-merge commit against the reference kernel in interpret mode,
the rng fold chain, and the EF behaviours of the reference's own tests
(telescoping residual, direct engine API, overlap schedule)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.kernels.fused_merge import fused_quant_merge_all as jquant_merge  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.convert import from_reference, to_reference_tree  # noqa: E402
from repro_torch.core import comms  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.core.prng import fold_in_key, prng_key  # noqa: E402
from repro_torch.kernels import fused_merge as fm  # noqa: E402

tp.torch_cpu()
N = 4
# leaf sizes off the 128 grid (54 / 300 / 30, as tests/test_kernels.py), a
# conv leaf whose OIHW storage order differs from the reference's HWIO, and
# a storage order of the leaves that is not the reference's (sorted) one
LEAVES = [("b", (300,)), ("conv", (8, 3, 3, 3)), ("a", (6, 9)),
          ("c", (3, 5, 2))]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _equal_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _blocks_case(kind, rng):
    """[N, 1024] f32 inputs for the quant core at wire_block 128."""
    v = rng.normal(0, 2, (N, 1024)).astype(np.float32)
    if kind == "ties":
        # scale = 127·2⁻³/127 = 2⁻³ exactly; v/scale lands on k + 0.5
        s = np.float32(2.0 ** -3)
        k = rng.integers(-120, 120, (N, 1024)).astype(np.float32)
        v = (k + 0.5) * s
        v[:, ::128] = 127 * s
    elif kind == "zeros":
        v[:, :256] = 0.0
        v[1] = 0.0
    elif kind == "large":
        v *= np.float32(1e30)
        v[:, 5] = np.float32(3e38)
    return v


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "large"])
@pytest.mark.parametrize("wire_dtype", ["int8", "bf16", "f32"])
def test_quant_core_bit_exact(kind, wire_dtype):
    v = _blocks_case(kind, np.random.default_rng(len(kind)))
    got = comms.quant_dequant_block(torch.from_numpy(v), wire_dtype, 128)
    _equal_bits(got.numpy(),
                jcomms.quant_dequant_block(jnp.asarray(v), wire_dtype, 128))
    if wire_dtype == "int8":
        q, s = comms.quant_encode(torch.from_numpy(v), 128)
        jq, js = jcomms.quant_encode(jnp.asarray(v), 128)
        assert q.dtype == torch.int8 and tuple(s.shape) == (N, 8)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        _equal_bits(s.numpy(), js)
        _equal_bits(comms.quant_decode(q, s, 128).numpy(),
                    jcomms.quant_decode(jq, js, 128))
        # int8 has no −0, so decode equals the round-trip as values
        np.testing.assert_array_equal(comms.quant_decode(q, s, 128).numpy(),
                                      got.numpy())


def _layout_and_tree(seed, scale=1.0, shift=0.0):
    layout = FlatLayout(LEAVES, convs=["conv"])
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(
        rng.normal(shift, scale, (N, layout.size)).astype(np.float32))
    return layout, flat, jax.tree.map(jnp.asarray,
                                      to_reference_tree(layout, flat))


def _port(layout, tree):
    return from_reference(layout, jax.tree.map(np.asarray, tree), lead=1)


@pytest.mark.parametrize("wire_dtype", ["int8", "bf16", "f32"])
def test_wire_effective_on_the_per_leaf_grid(wire_dtype):
    """θ̂' and the stateless round-trip of the port equal the reference's,
    bit for bit, leaf by leaf (off-grid sizes, a conv leaf)."""
    layout, x, jx = _layout_and_tree(0)
    _, r, jr = _layout_and_tree(1, scale=0.5)
    grid = comms.wire_grid(layout, wire_dtype, 128)
    eff = comms.wire_effective(x, r, grid)
    _equal_bits(eff.numpy(),
                _port(layout, jcomms.wire_effective(jx, jr, wire_dtype, 128)))
    mass = x.abs()
    _equal_bits(comms.quant_dequant(mass, grid).numpy(),
                _port(layout, jcomms.quant_dequant_tree(
                    jax.tree.map(jnp.abs, jx), wire_dtype, 128)))


@pytest.mark.parametrize("chunk", [7, 100])
@pytest.mark.parametrize("wire_dtype", ["int8", "bf16"])
def test_wire_round_trip_in_column_chunks_equals_reference(wire_dtype, chunk,
                                                           monkeypatch):
    """The round trip runs ``comms.CHUNK`` columns at a time (a block's
    maximum gathered over every chunk first): chunks that cut blocks,
    segments and leaves still give the reference's bits."""
    monkeypatch.setattr(comms, "CHUNK", chunk)
    layout, x, jx = _layout_and_tree(0)
    _, r, jr = _layout_and_tree(1, scale=0.5)
    grid = comms.wire_grid(layout, wire_dtype, 128)
    _equal_bits(comms.wire_effective(x, r, grid).numpy(),
                _port(layout, jcomms.wire_effective(jx, jr, wire_dtype, 128)))
    _equal_bits(comms.quant_dequant(x.abs(), grid).numpy(),
                _port(layout, jcomms.quant_dequant_tree(
                    jax.tree.map(jnp.abs, jx), wire_dtype, 128)))


def test_a_grid_that_ignores_leaves_or_conv_order_is_caught():
    """Blocks taken over the whole buffer, or over the conv's OIHW storage
    order, group other elements and give other bits than the reference."""
    layout, x, jx = _layout_and_tree(2)
    zero = torch.zeros_like(x)
    want = _port(layout, jcomms.wire_effective(
        jx, jax.tree.map(jnp.zeros_like, jx), "int8", 128)).numpy()
    right = comms.wire_effective(x, zero, comms.wire_grid(layout, "int8", 128))
    _equal_bits(right.numpy(), want)
    whole = comms.wire_grid(layout.size, "int8", 128)
    oihw = comms.wire_grid(FlatLayout([(p, (int(np.prod(s)),))
                                       for p, s in LEAVES]), "int8", 128)
    for grid in (whole, oihw):
        assert not np.array_equal(
            _bits(comms.wire_effective(x, zero, grid).numpy()), _bits(want))


@pytest.mark.parametrize("leaves", [LEAVES, [("x", (1500,))]])
def test_grid_segments_cover_each_element_once(leaves):
    """The kernel's walk (segments into perm) visits every stored element
    exactly once, segment by segment as ``seg_id`` groups them, in blocks
    of at most wire_block; perm is None when every block is contiguous."""
    layout = FlatLayout(leaves, convs=[p for p, s in leaves if len(s) == 4])
    grid = comms.wire_grid(layout, "int8", 128)
    order = (np.arange(layout.size) if grid.perm is None
             else grid.perm.numpy())
    assert (grid.perm is None) == all(len(s) < 4 for _, s in leaves)
    seen = np.zeros(layout.size, int)
    for s, (start, length) in enumerate(grid.segments.numpy()):
        assert 1 <= length <= 128
        idx = order[start:start + length]
        assert (grid.seg_id.numpy()[idx] == s).all()
        seen[idx] += 1
    assert (seen == 1).all()
    for wire_dtype in ("bf16", "f32"):
        flat = comms.wire_grid(layout, wire_dtype, 128)
        assert flat.perm is None and flat.seg_id is None
        assert int(flat.segments[:, 1].sum()) == layout.size


def test_payload_checksum_bit_exact_and_sensitive():
    layout, x, jx = _layout_and_tree(3)
    got = comms.payload_checksum(x, layout)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcomms.payload_checksum(jx),
                                             np.int64))
    flipped = x.clone()
    flipped.view(torch.int32)[2, 400] ^= 1 << 7
    after = comms.payload_checksum(flipped, layout)
    assert after[2] != got[2]
    assert torch.equal(after[[0, 1, 3]], got[[0, 1, 3]])
    one = comms.payload_checksum(x)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jcomms.payload_checksum(
            {"x": jnp.asarray(x.numpy())}), np.int64))


def _cfgs():
    for topology in ("full", "ring", "dynamic"):
        for merge in ("mean", "fedavg", "fisher", "gradmatch"):
            for wire in ("f32", "bf16", "int8"):
                for n in (2, 3, 4, 8):
                    yield dict(n_nodes=n, topology=topology, merge=merge,
                               wire_dtype=wire, wire_block=256,
                               lora_only=False)


def test_cost_model_matches_reference():
    """Candidates, picks and bytes over topology × merge × wire × N, flat
    and two-level meshes, with neutral and pod-skewed link costs."""
    checked = 0
    for kw in _cfgs():
        for costs in ({}, dict(cross_pod_cost=10.0)):
            cfg, jcfg = SwarmConfig(**kw, **costs), JSwarmConfig(**kw, **costs)
            for mesh_shape in (None, (2, kw["n_nodes"] // 2)):
                if mesh_shape is not None and kw["n_nodes"] % 2:
                    continue
                a = comms.candidate_schedules(cfg, mesh_shape=mesh_shape)
                b = jcomms.candidate_schedules(jcfg, mesh_shape=mesh_shape)
                assert ([dataclasses.asdict(s) for s in a]
                        == [dataclasses.asdict(s) for s in b])
                for p in (None, 1_639_705):
                    pa = comms.pick_schedule(cfg, payload_params=p,
                                             simulated=True,
                                             mesh_shape=mesh_shape)
                    pb = jcomms.pick_schedule(jcfg, payload_params=p,
                                              simulated=True,
                                              mesh_shape=mesh_shape)
                    assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
                    assert pa.describe(p) == pb.describe(p)
                    assert (pa.bytes_by_link_class(12345)
                            == pb.bytes_by_link_class(12345))
                checked += 1
    assert checked > 200
    with pytest.raises(ValueError, match="wire_block"):
        comms.validate_wire_block(100)
    with pytest.raises(ValueError, match="wire_dtype"):
        comms.validate_wire_dtype("fp8")
    # lora_only counts the adapter leaves, as the reference does
    lay = FlatLayout([("w", (2, 3)), ("lora_A", (2, 1)), ("lora_B", (1, 3))])
    tree = {k: jnp.zeros((4,) + lf.shape) for k, lf in
            ((lf.path, lf) for lf in lay.leaves)}
    for lora_only in (True, False):
        assert (comms.payload_param_count(torch.zeros(4, lay.size),
                                          lora_only, 4, lay)
                == jcomms.payload_param_count(tree, lora_only, 4))
    assert comms.payload_param_count(torch.zeros(4, 8), True, 4) == 0
    assert comms.payload_param_count(torch.zeros(4, 8), False, 4) == 8


@pytest.mark.parametrize("wire_dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("use_imp", [False, True])
def test_plain_quant_merge_matches_reference_kernel(wire_dtype, use_imp):
    """The commit's plain version (the CPU path of the kernel wrapper)
    against the reference's Pallas kernel in interpret mode, on the cases of
    tests/test_kernels.py: new reference bit-equal to the reference's
    wire_effective, committed rows at 2e-5, rejected rows exactly x."""
    rng = np.random.default_rng(11)
    n, d, wb = 4, 1500, 128
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    r = rng.normal(0, 0.5, (n, d)).astype(np.float32)
    W = rng.dirichlet(np.ones(n), size=n).astype(np.float32)
    gates = np.asarray([1, 0, 1, 1])
    imp = (np.abs(rng.normal(1, 0.4, (n, d))).astype(np.float32)
           if use_imp else None)
    before = dict(fm.LAUNCHES)
    got, new_ref = fm.fused_quant_merge_all(
        torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(W),
        torch.from_numpy(gates), None if imp is None else torch.from_numpy(imp),
        grid=comms.wire_grid(d, wire_dtype, wb))
    assert fm.LAUNCHES == before            # a CPU tensor takes the plain form
    jgot, jref = jquant_merge(jnp.asarray(x), jnp.asarray(r), jnp.asarray(W),
                              jnp.asarray(gates),
                              None if imp is None else jnp.asarray(imp),
                              wire_dtype=wire_dtype, wire_block=wb,
                              interpret=True)
    eff = jcomms.wire_effective({"x": jnp.asarray(x)}, {"x": jnp.asarray(r)},
                                wire_dtype, wb)["x"]
    _equal_bits(new_ref.numpy(), eff)
    # the reference's own kernel holds its θ̂' to 1e-6 of wire_effective
    np.testing.assert_allclose(new_ref.numpy(), np.asarray(jref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-5,
                               atol=2e-5)
    _equal_bits(got.numpy()[1], x[1])


def test_rng_fold_chain_matches_jax():
    for seed in (0, 7):
        key, jkey = prng_key(seed), jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(key, np.asarray(jkey))
        for r in range(8):
            key, jkey = fold_in_key(key, r), jax.random.fold_in(jkey, r)
            np.testing.assert_array_equal(key, np.asarray(jkey))


# -- the reference's EF behaviours (tests/test_comms.py), on the port --------

def _toy(cfg, d=4):
    """tests/test_comms.py's toy swarm: each node pulls toward its target."""
    from repro_torch.core.session import SwarmSession

    def train_step(p, o, b, s):
        g = p - b
        return p - 0.1 * g, o, {"loss": (g * g).sum()}

    def eval_fn(p, v):
        return 1.0 - 0.0 * p.sum(-1)

    return SwarmSession(cfg, train_step, eval_fn, params=torch.zeros(d),
                        data_sizes=[100 * (i + 1) for i in range(N)],
                        device="cpu")


def _cfg(**kw):
    base = dict(n_nodes=N, sync_every=2, merge="fedavg", topology="full",
                lora_only=False, val_threshold=0.0)
    return SwarmConfig(**dict(base, **kw))


def _targets(d=4):
    return torch.stack([torch.full((d,), float(t)) for t in range(N)])


def test_wire_residual_telescopes_on_constant_inputs():
    """Every node inactive, so no commit lands and params stay constant: the
    EF residual contracts ≥ 32× per round to (float) zero."""
    from repro_torch.core.session import SwarmSession
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.normal(0, 1, (N, 64)).astype(np.float32))
    cfg = _cfg(merge="fedavg", topology="dynamic", val_threshold=0.9,
               wire_dtype="int8", wire_block=128, sync_every=1)
    sess = SwarmSession(cfg, lambda p, o, b, s: (p, o, {"loss": p.sum()}),
                        lambda p, v: 0.0 * p.sum(-1), params=x0[0],
                        data_sizes=[1.0] * N, device="cpu")
    sess._state = dataclasses.replace(sess.state, params=x0.clone())
    sess.set_active([False] * N)
    prev = np.inf
    for r in range(5):
        out = sess.round(torch.zeros(1, N, 4), torch.zeros(N, 1))
        assert not out["gates"].any()
        assert torch.equal(sess.state.params, x0)
        res = float((sess.state.params - sess.state.wire).abs().max())
        if r >= 1:
            assert res <= prev / 32 + 1e-9, f"round {r}: {res} vs {prev}"
        prev = res
    assert prev < 1e-7


def test_direct_engine_api_honours_wire_dtype():
    """No threaded wire state: a zero reference per call, so the engine
    still quantizes, and hands the advanced reference back in the log."""
    from repro_torch.core.engine import SwarmEngine
    rng = np.random.default_rng(6)
    params = torch.from_numpy(rng.normal(0, 1, (N, 64)).astype(np.float32))
    outs = {}
    for wd in ("f32", "int8"):
        eng = SwarmEngine(_cfg(wire_dtype=wd, wire_block=128), None,
                          lambda p, v: 1.0 - 0.0 * p.sum(-1),
                          data_sizes=[1.0] * N)
        committed, log = eng.sync(params, torch.zeros(N, 1))
        outs[wd] = committed.numpy()
        assert ("wire" in log) == (wd == "int8")
    diff = np.abs(outs["int8"] - outs["f32"]).max()
    assert 0 < diff < 3.0 / 127 * 4


def test_wire_overlap_mode_and_bounded_drift():
    """The EF wire composes with the stale-by-one overlap schedule, and a
    serial int8 session stays within a quantization band of the f32 one
    while two int8 runs agree bit for bit."""
    cfg = _cfg(sync_every=1, overlap_sync=True, wire_dtype="int8",
               wire_block=128)
    sess = _toy(cfg)
    logs = sess.run_rounds(_targets().expand(6, 1, N, 4), torch.zeros(N, 1))
    assert logs["gates"].all() and torch.isfinite(sess.state.params).all()
    assert sess.state.wire is not None and sess.state.round == 6

    def run(wd):
        s = _toy(_cfg(merge="fisher", topology="ring", wire_dtype=wd,
                      wire_block=128))
        out = []
        for _ in range(4):
            s.round(_targets().expand(2, N, 4), torch.zeros(N, 1))
            out.append(s.state.params.clone())
        return out

    a, b, f = run("int8"), run("int8"), run("f32")
    for xa, xb, xf in zip(a, b, f):
        assert torch.equal(xa, xb)
        assert float((xa - xf).abs().max()) < 0.1


def test_quarantine_wire_and_schedule_surface():
    sess = _toy(_cfg(topology="ring", merge="fisher", wire_dtype="int8",
                     wire_block=128))
    sess.round(_targets().expand(2, N, 4), torch.zeros(N, 1))
    assert sess.state.wire.abs().sum() > 0
    sess.quarantine_wire(2)
    assert not sess.state.wire[2].any() and sess.state.wire[1].any()
    sess.quarantine_wire()
    assert not sess.state.wire.any()
    s = sess.sync_schedule
    assert s.name == "ring_topo_ppermute" and s.simulated
    assert sess.payload_params == 4
    assert sess.predicted_sync_bytes == pytest.approx(4 * 4 + 4 * 4 / 128 * 4)
    f32 = _toy(_cfg(topology="ring", merge="fisher"))
    assert f32.state.wire is None
    f32.quarantine_wire(1)                  # no wire state: a no-op
    assert f32.predicted_sync_bytes == pytest.approx(4 * 4 * 4)
