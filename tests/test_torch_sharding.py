"""The port's param partition specs (`repro_torch.sharding.rules`) and a
rank's shard of a node (`repro_torch.core.flat.ShardLayout`).

``param_specs`` is held against the reference's (`repro.sharding.rules.
param_specs`) leaf by leaf, on all 11 configs at full width (the ten LM
configs and the paper CNN; the reference's shapes from ``jax.eval_shape``,
the port's from its layouts, which allocate nothing), on the (node, data,
model) sizes (4, 1, 2), (2, 2, 2), (4, 4, 16) and (4, 1, 1), with ``fsdp``
on and off. The reference's function reads only ``axis_names`` and
``devices.shape`` of what it is given, so a stub with those two
attributes stands in, and nothing of the JAX package changes.

The shard layout: every coordinate's shard of a node, put back together,
is the node bit for bit (slots and values), for a conv leaf (cut along the
reference's HWIO axes, stored OIHW), a bf16 layout with wide leaves, a
2-D ``(data, model)`` spec, a tuple of axes on one dimension and a
dimension the axes do not divide (replicated)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core import comms as jcomms
from repro.models import build_model as jbuild
from repro.models import cnn as jcnn
from repro.sharding.rules import param_specs as jparam_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.paper_histo import PAPER_FULL
from repro_torch.core import comms
from repro_torch.core.flat import FlatLayout, ShardLayout
from repro_torch.models import build_model
from repro_torch.models.cnn import HistoCNN
from repro_torch.sharding.rules import param_specs

AXES = ("node", "data", "model")
SIZES = [(4, 1, 2), (2, 2, 2), (4, 4, 16), (4, 1, 1)]
CNN = "paper-histo-cnn"


class _AxesStub:
    """What the reference's ``param_specs`` reads of a device grid."""

    def __init__(self, sizes):
        self.axis_names = AXES
        self.devices = np.empty(sizes, dtype=np.int8)


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _shapes_and_layout(arch):
    """(the reference's shape tree, the port's layout) at full width."""
    if arch == CNN:
        kw = dict(growth=PAPER_FULL.growth, stem=PAPER_FULL.stem,
                  feat_dim=PAPER_FULL.feat_dim, hidden=PAPER_FULL.hidden)
        shapes = jax.eval_shape(lambda k: jcnn.init_cnn(k, None, **kw),
                                jax.random.key(0))
        return shapes, FlatLayout.of_module(HistoCNN(**kw))
    shapes = jax.eval_shape(jbuild(jget_config(arch)).init,
                            jax.random.key(0))
    return shapes, build_model(get_config(arch)).layout


@pytest.mark.parametrize("arch", list(ARCH_IDS) + [CNN])
def test_param_specs_match_reference_on_every_leaf(arch):
    shapes, layout = _shapes_and_layout(arch)
    for sizes in SIZES:
        for fsdp in (True, False):
            ref = jparam_specs(shapes, _AxesStub(sizes), fsdp=fsdp)
            leaves = jax.tree_util.tree_flatten_with_path(
                ref, is_leaf=lambda x: isinstance(x, P))[0]
            want = {_dotted(p): tuple(s) for p, s in leaves}
            got = param_specs(layout, dict(zip(AXES, sizes)), fsdp=fsdp)
            assert got.keys() == want.keys(), arch
            bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
            assert not bad, (arch, sizes, fsdp, bad)


def _sharded_values(layout, specs):
    """(values a spec cuts, all values) of a layout."""
    n = [int(np.prod(lf.shape)) for lf in layout.leaves]
    cut = [k for k, lf in zip(n, layout.leaves)
           if any(a is not None for a in specs[lf.path])]
    return sum(cut), sum(n)


def test_scan_stacked_placement_of_mamba2():
    """The reference's table lands one dimension early on scan-stacked
    leaves: on (node, data, model) = (2, 1, 2) Mamba2-370M's in_proj puts
    the layer axis over data and d_model over model, its conv cuts the
    kernel width 4, and 368,340,992 of 368,494,080 values are sharded
    (Hymba-1.5B 99.98 %, MiniCPM-2B 99.99 %)."""
    mesh = {"node": 2, "data": 1, "model": 2}
    layout = build_model(get_config("mamba2-370m")).layout
    specs = param_specs(layout, mesh)
    want = {"layers.ssm.in_proj.w": ("data", "model", None),
            "layers.ssm.out_proj.w": ("model", "data", None),
            "layers.ssm.conv.w": (None, "model", None),
            "layers.ssm.conv.b": (None, "model"),
            "embed_tied.table": ("model", None),
            "layers.ssm.A_log": (None, None), "layers.ssm.D": (None, None),
            "layers.ssm.dt_bias": (None, None),
            "final_norm.scale": (None,)}
    for path, spec in want.items():
        assert specs[path] == spec, path
    assert _sharded_values(layout, specs) == (368_340_992, 368_494_080)
    for arch, share in (("hymba-1.5b", 99.98), ("minicpm-2b", 99.99)):
        lay = build_model(get_config(arch)).layout
        cut, total = _sharded_values(lay, param_specs(lay, mesh))
        assert round(100 * cut / total, 2) == share, arch


@pytest.mark.parametrize("specs", [
    None, {}, {"w": (None, "model")}, {"w": P(None, "model")},
    {"w": P()}, {"w": ()}, {"w": (("data", "model"), None)}])
def test_has_inner_sharding_matches_reference(specs):
    tuples = (None if specs is None else
              {k: tuple(v) for k, v in specs.items()})
    assert comms.has_inner_sharding(tuples) == jcomms.has_inner_sharding(
        None if specs is None else {k: P(*v) for k, v in specs.items()})


def _round_trip(layout, specs, sizes, rows):
    """Every coordinate's shard of ``rows`` [R, W], put back together."""
    names = list(sizes)
    grid = [dict(zip(names, np.unravel_index(g, tuple(sizes.values()))))
            for g in range(int(np.prod(list(sizes.values()))))]
    shards = [ShardLayout(layout, specs, sizes,
                          {k: int(v) for k, v in c.items()})
              for c in grid]
    parts = torch.stack([s.shard(rows) for s in shards])
    return shards, parts, shards[0].assemble(parts)


LAYOUTS = {
    # a conv (OIHW; HWIO in the reference: O over model), a matrix over
    # (data, model), a vector whose 6 values 4 does not divide
    "conv": (FlatLayout([("c", (4, 3, 3, 2)), ("m", (8, 6)), ("v", (6,))],
                        convs=["c"]),
             {"c": (None, None, None, "model"), "m": ("data", "model"),
              "v": (("data", "model"),)}, torch.float32),
    # a bf16 layout with wide f32 leaves first (the SSM's A_log, D)
    "wide": (FlatLayout([("A_log", (3, 4)), ("w", (3, 8, 4)),
                         ("D", (3, 4)), ("e", (10, 4))],
                        wide=["A_log", "D"]),
             {"w": ("data", "model", None), "e": ("model", None),
              "A_log": (None, None)}, torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_shard_layout_round_trip(name):
    layout, specs, dtype = LAYOUTS[name]
    sizes = {"data": 2, "model": 2}
    rng = np.random.default_rng(0)
    values = torch.from_numpy(rng.normal(0, 1, (3, layout.n_values)).astype(
        np.float32))
    slots = layout.from_values(values, dtype)
    bits = (lambda t: t.view(torch.int16)) if dtype != torch.float32 else (
        lambda t: t)
    shards, parts, back = _round_trip(layout, specs, sizes, slots)
    assert torch.equal(bits(back), bits(slots))
    _, _, back = _round_trip(layout, specs, sizes, values)
    assert torch.equal(back, values)
    assert shards[0].sharded
    # a shard's slot buffer is its own layout's: its values are the
    # shard of the node's values
    for s, part in zip(shards, parts):
        assert torch.equal(s.local.values(part),
                           s.shard(layout.values(slots)))


def test_shard_cuts_follow_the_reference_axes():
    """A conv's spec over HWIO cuts the stored OIHW leaf on the axis it
    names; a dimension the axes do not divide, or an axis of size 1, is
    replicated; a tuple of axes is major first."""
    layout, specs, _ = LAYOUTS["conv"]
    s = ShardLayout(layout, specs, {"data": 2, "model": 2},
                    {"data": 1, "model": 1})
    assert dict((lf.path, lf.shape) for lf in s.local.leaves) == {
        "c": (2, 3, 3, 2), "m": (4, 3), "v": (6,)}
    assert s.cuts["c"] == ((0, 2, 2),) and s.cuts["m"] == ((0, 4, 4),
                                                           (1, 3, 3))
    one = ShardLayout(layout, specs, {"data": 1, "model": 1},
                      {"data": 0, "model": 0})
    assert not one.sharded and one.local.size == layout.size
    t = ShardLayout(FlatLayout([("v", (8,))]), {"v": (("data", "model"),)},
                    {"data": 2, "model": 2}, {"data": 1, "model": 0})
    assert t.cuts["v"] == ((0, 4, 2),)


def test_share_counts_every_value_once():
    """The shard group's shares of a sum add up to the node's sum, each
    replicated block counted once."""
    layout, specs, _ = LAYOUTS["conv"]
    sizes = {"data": 2, "model": 2}
    rows = torch.arange(layout.size, dtype=torch.float32)[None] + 1.0
    shards, parts, _ = _round_trip(layout, specs, sizes, rows)
    total = sum(float(s.share(p)) for s, p in zip(shards, parts))
    assert total == pytest.approx(float(rows.sum()), rel=1e-6)
