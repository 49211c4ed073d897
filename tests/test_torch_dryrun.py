"""The dry run (`repro_torch.launch.dryrun`): every architecture × input
shape as one rank of the production mesh, against the reference's
``repro.launch.dryrun`` / ``specs`` / ``hlo_stats``.

Held: the input shapes and ``adapt_for_shape`` equal the reference's; the
analytic model FLOPs too; a rank's batch, decode-token and cache shapes
(`repro_torch.launch.specs`) equal the reference's shard shapes from
``specs.batch_specs``, ``decode_token_specs`` and ``cache_specs`` on an
abstract ``(16, 16)`` mesh (and ``(2, 16, 16)`` with pods) for every
pair, the long-context sequence cut included, under each sharding
profile (``default``, ``dp``, ``zero3``), and each leaf's shard against
the reference's ``param_specs`` for the profile; the ``meta`` peak tracker
against a hand count; on a smoke config in a fake world of (data, model)
= (2, 2), under each profile, the ``meta`` step's FLOPs, kernel calls and
collective bytes by kind equal to a CPU run of the same rank (the plain kernels, counted by
their formulas), and the split step's bytes equal to the layout's count
that the gloo worlds are held to (`chip_smoke._tp_bytes`); the
roofline's terms; the fake world torn down after an exception; and the
full-width ``meta`` dry run of every arch at ``decode_32k`` and of two
archs at ``train_4k``; the CLI's ``--profile dp|zero3`` rows, tagged as
the reference's (the whole file in about 75 s on one CPU worker).

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is
imported; JAX's backend is initialised first, so it takes no effect here.
"""
import dataclasses
import time

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import SHAPES_BY_NAME as JSHAPES_BY_NAME
from repro.configs import adapt_for_shape as jadapt
from repro.configs import get_config as jget_config
from repro.launch import hlo_stats
from repro.launch import specs as jspecs
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, SHAPES_BY_NAME,
                                 adapt_for_shape, get_config, smoke_variant)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline, specs

jax.devices()                  # the backend first: the import below sets
from repro.launch.dryrun import PROFILES as JPROFILES  # noqa: E402
from repro.launch.dryrun import _PROFILE_FSDP as JPROFILE_FSDP  # noqa: E402
from repro.launch.dryrun import model_flops_analytic as jflops  # noqa: E402
from repro.launch.specs import param_shapes as jparam_shapes  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.sharding.rules import param_specs as jparam_specs  # noqa: E402

pytestmark = pytest.mark.spmd

MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
          "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
SMALL = {"data": 2, "model": 2}
#: (arch, kind, batch): every family, each step kind, and a batch of 1 (the
#: cache's sequence cut over data)
SMOKE_STEPS = (("minicpm-2b", "train", 4), ("granite-moe-3b-a800m", "train", 4),
               ("hymba-1.5b", "train", 4), ("mamba2-370m", "prefill", 4),
               ("seamless-m4t-medium", "prefill", 4),
               ("internvl2-1b", "decode", 4), ("nemotron-4-15b", "decode", 1))
#: the archs whose full-width train_4k rank is played here (the fastest)
TRAIN_ARCHS = ("nemotron-4-15b", "phi3.5-moe-42b-a6.6b")


def _shard(sds):
    return tuple(sds.sharding.shard_shape(sds.shape))


def _cases(*axes):
    """``pytest.param`` s of every combination of ``axes`` (lists of
    values, the profile last), ids as before the profiles for
    ``default`` and with the profile appended otherwise."""
    import itertools
    out = []
    for combo in itertools.product(*axes):
        *rest, profile = combo
        ident = "-".join(str(x) for x in rest)
        out.append(pytest.param(*combo, id=ident if profile == "default"
                                else f"{ident}-{profile}"))
    return out


def test_input_shapes_match_the_reference():
    assert [dataclasses.asdict(s) for s in INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in JSHAPES]
    assert set(SHAPES_BY_NAME) == set(JSHAPES_BY_NAME)
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adapt_for_shape_and_model_flops_match_the_reference(arch):
    for shape in INPUT_SHAPES:
        got = adapt_for_shape(get_config(arch), shape)
        want = jadapt(jget_config(arch), JSHAPES_BY_NAME[shape.name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), shape
        assert dryrun.model_flops_analytic(got, shape) == pytest.approx(
            jflops(want, JSHAPES_BY_NAME[shape.name]), rel=1e-12)


@pytest.mark.parametrize("arch,mesh,profile",
                         _cases(ARCH_IDS, list(MESHES), specs.PROFILES))
def test_rank_shapes_match_the_reference_shard_shapes(arch, mesh, profile):
    """Each shape's rank batch, decode tokens and caches against the
    reference's shard shapes under ``profile`` (its ``batch_specs``,
    ``decode_token_specs`` and ``cache_specs`` with the profile). Under
    ``default`` the conv tail of an SSM cache holds the channels of the
    rank's conv compute block (its heads' x columns and the B/C groups
    they read, whole where the heads stay whole), where the reference's
    holds ``conv_dim / M`` and leaves the gather to GSPMD: the port's
    count is checked against that rule instead. Under ``dp`` and
    ``zero3`` every shape is the reference's, ``zero3``'s conv tail
    included (its compute is whole: a decode step gathers the cut)."""
    sizes = specs.PRODUCTION[mesh]
    jmesh = MESHES[mesh]
    for shape in INPUT_SHAPES:
        cfg = adapt_for_shape(get_config(arch), shape)
        jcfg = jadapt(jget_config(arch), JSHAPES_BY_NAME[shape.name])
        jshape = JSHAPES_BY_NAME[shape.name]
        want = {k: _shard(v) for k, v in
                jspecs.batch_specs(jcfg, jshape, jmesh, profile).items()}
        assert specs.batch_shapes(cfg, shape, sizes, profile) == want, shape
        assert specs.decode_token_shape(cfg, shape, sizes, profile) == \
            _shard(jspecs.decode_token_specs(jcfg, jshape, jmesh, profile))
        jc = jspecs.cache_specs(jcfg, jshape, jmesh, profile)
        got = specs.cache_shapes(cfg, shape, sizes, profile)
        if cfg.is_encdec:
            assert got["enc_out"] == _shard(jc["enc_out"])
            got, jc = got["self"], jc["self"]
        assert set(got) == set(jc)
        for key, sds in jc.items():
            if key != "conv" or profile != "default":
                assert got[key] == _shard(sds), (shape.name, key)
                continue
            place = specs.placement_of(cfg, sizes)
            ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            if place.ssm_heads:
                ch = cfg.d_inner // sizes["model"] + 2 * cfg.ssm_state
            assert got[key] == _shard(sds)[:3] + (ch,), shape.name


class _AxesStub:
    """What the reference's ``param_specs`` reads of a device grid."""

    def __init__(self, sizes):
        import numpy as np
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=np.int8)


@pytest.mark.parametrize("profile", specs.PROFILES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_layout_matches_the_reference_param_specs(arch, profile):
    """Every leaf's shard shape under `specs.shard_layout(..., profile)`
    equals its shard under the reference's ``param_specs(logical=
    PROFILES[profile], fsdp=_PROFILE_FSDP[profile])`` on both production
    meshes, for two coordinates (``dp``'s layout spans the data group
    only: its blocks repeat over the model ranks)."""
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro_torch.models import build_model
    model = build_model(get_config(arch))
    shapes = jparam_shapes(jbuild(jget_config(arch)))
    dotted = lambda path: ".".join(str(getattr(k, "key", getattr(k, "idx",
                                                                 k)))
                                   for k in path)
    full = {lf.path: lf for lf in model.layout.leaves}
    glob = {dotted(p): s.shape for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for sizes in specs.PRODUCTION.values():
        ref = jparam_specs(shapes, _AxesStub(sizes),
                           logical=JPROFILES[profile],
                           fsdp=JPROFILE_FSDP[profile])
        spec = {dotted(p): s for p, s in jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: isinstance(x, P))[0]}
        for coords in ({"data": 0, "model": 0}, {"data": 5, "model": 15}):
            shard = specs.shard_layout(model, sizes, coords, profile)
            if profile == "dp":
                assert shard.sizes == {"data": sizes["data"]}
            for lf in shard.local.leaves:
                want = list(glob[lf.path])
                for dim, ax in enumerate(spec[lf.path]):
                    names = () if ax is None else (
                        ax if isinstance(ax, tuple) else (ax,))
                    want[dim] //= int(np.prod([sizes[a] for a in names]))
                got = tuple(lf.shape[a] for a in full[lf.path].ref_axes)
                assert got == tuple(want), (lf.path, sizes, coords)


def test_profile_tables_match_the_reference():
    """The port's copies of the reference dry run's ``PROFILES`` and
    ``_PROFILE_FSDP``."""
    from repro_torch.sharding import rules
    assert rules.PROFILES == JPROFILES
    assert rules.PROFILE_FSDP == JPROFILE_FSDP
    assert specs.PROFILES == dryrun.PROFILES == tuple(JPROFILES)


def test_peak_tracker_matches_a_hand_count():
    """Live storage bytes, each storage once however many views share it,
    freed when its last reference goes; held arguments counted from the
    start."""
    m = lambda *s: torch.empty(s, device="meta")
    arg = m(10)                                  # 40 bytes, held
    view = arg.view(2, 5)
    with dryrun.RankCounter() as c:
        assert c.hold(arg, [view]) == 40
        a = m(100)                               # +400 → 440
        b = a * 2                                # +400 → 840
        view = b.view(10, 10)[2:]                # a view: nothing new
        del a                                    # -400 → 440
        d = torch.cat([view.reshape(-1), view.reshape(-1)])   # +640 → 1080
        assert c.live == 1080
        del b, view                              # b's storage freed: 680
        assert c.live == 680
        e = d.to(torch.bfloat16)                 # +320 → 1000
        assert c.peak == 1080 and c.live == 1000
        del d, e
        assert c.live == 40
    assert c.flops == {"tensor": 0.0, "f32": 0.0}


def test_counter_flops_and_bytes_by_hand():
    """A matmul's FLOPs (FlopCounterMode's 2·M·N·K) by its operands' rate
    class, and an op's bytes its operands' and output's."""
    with dryrun.RankCounter() as c:
        a = torch.empty(8, 16, device="meta", dtype=torch.bfloat16)
        w = torch.empty(16, 4, device="meta", dtype=torch.bfloat16)
        a @ w
        x = torch.empty(8, 16, device="meta")
        x @ x.t()
    assert c.flops == {"tensor": 2.0 * 8 * 4 * 16, "f32": 2.0 * 8 * 8 * 16}
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 2 + (2 * 8 * 16 + 64) * 4


def _smoke(arch, kind, batch, device, profile="default"):
    cfg = smoke_variant(get_config(arch))
    shape = ShapeConfig("smoke", 32, batch, kind)
    return dryrun.play(arch, None, cfg=cfg, shape=shape, sizes=SMALL,
                       model_rank=1, device=device, seed=0,
                       sharding=profile)


@pytest.mark.parametrize("arch,kind,batch,profile",
                         [pytest.param(*step, profile,
                                       id="-".join(map(str, step)) + (
                                           "" if profile == "default"
                                           else f"-{profile}"))
                          for profile in specs.PROFILES
                          for step in SMOKE_STEPS])
def test_meta_step_counts_equal_a_cpu_run(arch, kind, batch, profile):
    """The meta run of rank (0, 1) of a (2, 2) world under ``profile``
    against a CPU run of the same rank (the plain kernels, counted by
    their formulas): FLOPs by rate class, kernel calls, collective bytes
    by link and kind, and the peak (the CPU's plain SSD allocates no
    chunk scratch). Under ``dp`` and ``zero3`` no kind is
    tensor-parallel but the sequence cut's softmax."""
    meta = _smoke(arch, kind, batch, "meta", profile)
    cpu = _smoke(arch, kind, batch, "cpu", profile)
    assert meta["flops"] == cpu["flops"]
    assert meta["kernels"] == cpu["kernels"]
    assert meta["coll_detail"] == cpu["coll_detail"]
    scratch = meta["memory"]["peak_bytes_per_device"] - \
        cpu["memory"]["peak_bytes_per_device"]
    assert scratch == 0 or (scratch > 0 and "ssd_scan" in meta["kernels"])
    assert meta["flops"]["f32"] > 0 and meta["coll"] > 0
    if batch == 1:
        assert meta["coll_detail"]["node"]["tp_seq_sum"] > 0
    if profile != "default":
        kinds = set(meta["coll_detail"]["node"])
        assert not {k for k in kinds if k.startswith("tp_")} - {
            "tp_seq_max", "tp_seq_sum"}, kinds
        assert ("grad_replica" in kinds) == (profile == "dp" and
                                              kind == "train"), kinds


@pytest.mark.parametrize("arch", ["minicpm-2b", "hymba-1.5b"])
def test_meta_split_step_bytes_equal_the_layout_count(arch):
    """A meta split step's bytes by kind equal the count from the layout
    that the gloo worlds' steps are held to (`chip_smoke._tp_bytes`)."""
    import torch_gossip_world as W
    from repro_torch.models import build_model
    cfg = smoke_variant(get_config(arch))
    rows, seq = 2, 32
    rec = _smoke(arch, "train", rows * SMALL["data"], "meta")
    shard = specs.shard_layout(build_model(cfg), SMALL, rec["coords"])
    want, _ = W.tp_bytes(shard, cfg, cfg.n_layers, 4, rows, seq, True)
    got = rec["coll_detail"]["node"]
    assert {k: got.get(k, 0) for k in want} == want
    assert set(got) - set(want) == {"step_control"}


def test_meta_ranks_hold_what_the_specs_say():
    """A train rank's arguments are its stored shard and moments
    (`specs.stored_bytes`) and its node's batch; a serving rank's step
    buffers hold its compute blocks (`specs.compute_block_shapes`) and
    the caches of `specs.cache_shapes`."""
    from repro_torch.models import build_model
    cfg = smoke_variant(get_config("hymba-1.5b"))
    rec = _smoke("hymba-1.5b", "train", 4, "meta")
    stored = specs.stored_bytes(specs.shard_layout(
        build_model(cfg), SMALL, rec["coords"]), dtype_bytes=4)
    batch = 2 * 4 * 32 * 8                       # tokens and labels, int64
    assert rec["memory"]["argument_bytes_per_device"] == \
        stored["params"] + stored["opt"] + 4 + batch   # + AdamW's count
    shape = ShapeConfig("smoke", 32, 1, "decode")

    def then(step):
        views = {p: tuple(v.shape) for p, v in step.st.views.items()}
        caches = {k: (cfg.n_layers,) + tuple(v.shape)
                  for k, v in step.st.caches[0].items()}
        return views, caches

    rec = dryrun.play("hymba-1.5b", None, cfg=cfg, shape=shape, sizes=SMALL,
                      model_rank=1, then=then)
    views, caches = rec["then"]
    model = build_model(cfg)
    assert views == specs.compute_block_shapes(model, SMALL, rec["coords"])
    assert caches == specs.cache_shapes(cfg, shape, SMALL)


def test_roofline_terms_and_dominant():
    r = roofline.Roofline(arch="a", shape="s", mesh="m", chips=256,
                          hlo_flops=989e12 + 67e12, f32_flops=67e12,
                          hlo_bytes=3.35e12, coll_bytes=450e9 + 50e9,
                          coll_network=50e9, model_flops=100e12)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)
    assert r.bound_s == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(100 / 1056)
    r.coll_network = 100e9
    assert r.collective_s > r.compute_s and r.dominant == "collective"
    assert roofline.link_of(range(8)) == "node"
    assert roofline.link_of([7, 8]) == "network"
    # no TPU constant carried over
    assert roofline.HBM_BW != hlo_stats.HBM_BW


def test_fake_world_tears_down_after_an_exception():
    """The production meshes on a fake world (the uneven all_to_all that
    `LayerCut.gather_compute` sends goes through it), and no group left
    behind after an exception."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                         make_swarm_mesh)
    with pytest.raises(ValueError):
        with fake_world(256, 3):
            mesh = make_production_mesh()
            assert mesh.backend == "fake" and mesh.world_size == 256
            swarm, _ = make_swarm_mesh(1, data=16, model=16)
            assert swarm.coords == {"data": 0, "model": 3}
            assert swarm.model_view.world_size == 16
            send, recv = [3, 4] + [0] * 254, [5, 0, 2] + [0] * 253
            out = torch.empty(7)
            dist.all_to_all_single(out, torch.ones(7), recv, send)
            raise ValueError("inside")
    assert not dist.is_initialized()
    with fake_world(4, 1):
        assert dist.get_world_size() == 4
    with pytest.raises(RuntimeError, match="already"):
        with fake_world(2, 0):
            with fake_world(2, 1):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("profile", ("dp", "zero3"))
def test_cli_writes_profile_tagged_rows(tmp_path, profile):
    """``--profile dp|zero3`` plays the pair (no fallback to the default
    placement): an ``ok`` row with a roofline on ``(16, 16)`` and a memory
    row on ``(2, 16, 16)``, tagged ``_{profile}`` as the reference's, each
    rank played under the profile; ``--table`` reads them back."""
    import json
    import os
    arch, shape = "mamba2-370m", "decode_32k"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                        "--profile", profile, "--out", str(tmp_path)]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == [f"{arch}_{shape}_multi_{profile}.json",
                     f"{arch}_{shape}_single_{profile}.json"]
    for name in names:
        with open(tmp_path / name) as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["profile"] == profile
        assert ("roofline" in rec) == ("single" in name)
        assert all(r["profile"] == profile for r in rec["ranks"])
    grid = dryrun.table(str(tmp_path), "single", profile)
    assert "GiB" in grid.splitlines()[2 + ARCH_IDS.index(arch)]
    assert "GiB" not in dryrun.table(str(tmp_path), "single")


def test_full_width_meta_dry_run():
    """Every arch at decode_32k (model ranks 0 and 15, as the CLI plays
    them) and two at train_4k (rank 15), at full width and depth on meta:
    ok rows that fit, with a roofline. About 40 s on one idle CPU worker;
    the bound below only catches a hang."""
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        rec = dryrun.run_pair(arch, "decode_32k", False)
        assert rec["status"] == "ok" and rec["fits"], arch
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert len(rec["ranks"]) == 2
    for arch in TRAIN_ARCHS:
        r = dryrun.play(arch, "train_4k", model_rank=15)
        assert r["memory"]["peak_bytes_per_device"] < roofline.HBM_BYTES
        assert r["kernels"]["flash_attention"] == 2 * get_config(
            arch).n_layers
    assert time.perf_counter() - t0 < 600
