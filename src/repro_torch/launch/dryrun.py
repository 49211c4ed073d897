"""The dry run: every (architecture × input-shape) pair as one rank of the
production mesh. Port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/dryrun_torch

The reference lowers and compiles each pair for its ``(16, 16)`` mesh over
``("data", "model")`` (``(2, 16, 16)`` with pods), proves from the
compiled module's memory analysis that a device's share fits, and prices
its FLOPs, bytes and collective bytes on a roofline. The port runs one
process a rank, so it **plays** a rank: this process joins a fake process
group of the mesh's 256 (512) ranks as rank ``r`` (`repro_torch.launch.
mesh.fake_world`: its collectives move nothing), builds the port's own
mesh over it (`make_swarm_mesh(1, data=16, model=16)`; with pods
``make_swarm_mesh(2, ...)``, each pod a node position holding a replica,
as the reference's ``fsdp`` is ``data`` alone), allocates what that rank
holds (`repro_torch.launch.specs`) and runs the rank's step:

* ``train``: :meth:`~repro_torch.launch.train.TrainStep.split` with
  ``remat=True`` (the reference's ``TrainConfig``): the rank's param shard
  and AdamW moments, its batch rows, each layer's compute blocks gathered
  just in time, tensor parallelism over the model group;
* ``prefill``: :func:`~repro_torch.launch.serve.prefill_step_for` (an
  enc-dec: :func:`~repro_torch.launch.serve.encode_step_for` and the first
  decode step, as the reference lowers it);
* ``decode``: one :func:`~repro_torch.launch.serve.serve_step_for` step
  at the cache's last position, the cache on the reference's placement
  (its sequence cut over ``data`` at batch 1).

``--profile`` takes the reference's three sharding profiles
(`repro_torch.sharding.rules.PROFILES`). ``default`` is the above.
``dp`` and ``zero3`` place no tensor parallelism. Each rank runs every
layer whole on its rows, gathered just in time from its shard
(`repro_torch.launch.mesh.use_profile` names the groups):

* under ``dp`` the params are FSDP over ``data`` alone, so a layer is
  gathered over the rank's data group, and the model ranks repeat its
  blocks. The gradient reduced onto the data group's blocks is summed
  over the model group (``grad_replica``). A leaf ``data`` does not cut
  (the embedding and ``lm_head``, which no rule cuts under either
  profile, the norms) is whole on every rank, and its gradient takes one
  all_reduce over the whole position;
* under ``zero3`` the params are FSDP over ``("data", "model")``. A layer
  is gathered over the whole position, and the cache keeps its model cuts
  while the compute is whole: a decode step gathers them
  (``cache_gather``, `repro_torch.sharding.stored`).

Under both a rank computes the rows the logical ``batch``
(``("data", "model")``) gives it where that divides the batch. Otherwise
it computes the rows its input holds (`repro_torch.launch.train.
TrainStep.split`). A served rank holds its shard in the stored form of
`repro_torch.launch.serve.StepBuffers`. Every row carries ``profile``,
and its file tag ends in ``_dp`` / ``_zero3``, as the reference's does.
A pair that places but does not fit is an ``ok`` row with ``fits``
False.

On the ``meta`` device nothing is allocated and the full depth runs:
:class:`RankCounter` (a dispatch mode) tracks the live storage bytes for
the peak, counts FLOPs with ``torch.utils.flop_counter``'s per-op formulas
(FlopCounterMode's table) and the bytes of every op's operands and
outputs; the flash and SSD kernels add their own work by formula
(`repro_torch.kernels.work`). The collectives count their bytes by kind,
each under its group's link class (`repro_torch.launch.roofline`: one
8-GPU node, or the network). :class:`~repro_torch.launch.roofline.
Roofline` prices the rank at the H100 SXM5's published rates.

The same :class:`RankStep` runs on the card (``device="cuda"``): the
rank's shard and compute blocks are allocated alone (never the node whole
and sliced), filled from a seed, and the step runs the CUDA kernels;
``chip_smoke.py``'s ``dryrun`` phase holds its measured peak and FLOPs to
the ``meta`` prediction. A fake collective leaves its output as the
buffer was (or a copy of the input): every size and index the step uses
comes from the config and the plan (`LayerCut`'s routes, the cache
placement), the tokens from the batch, and an argmax or a router's top-k
over whatever values stays inside its range.

Each row holds the reference's keys (``arch``, ``shape``, ``mesh``,
``chips``, ``memory``, ``per_device_stats``, ``roofline``,
``model_flops_global``, ``params``, ``active_params``, ``status``) and
``fits`` (the peak against the card's memory), ``ranks`` (each played
rank's own record) and ``build_s`` (the wall of playing them) in place of
``compile_s``. The peak counts the full depth, so there is no
``extrapolation``. Model ranks ``0`` and ``M − 1`` of data index 0 are
played (``--ranks all``: every model rank); the row's memory and stats are
the heaviest played rank's. ``--mesh multi`` writes memory rows only, as
the reference's does. A pair that raises is a ``FAIL`` row with its
traceback, and the exit code is 1.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, SHAPES_BY_NAME,
                                 adapt_for_shape, get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.kernels import work
from repro_torch.launch import roofline, specs

#: the reference's sharding profiles (`repro_torch.sharding.rules.
#: PROFILES`)
PROFILES = specs.PROFILES

_COLLECTIVES = ("c10d", "_c10d_functional", "c10d_functional")
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "_unsafe_view", "set_",
             "resize_"}
_SIXTEEN = (torch.bfloat16, torch.float16)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs, out: list) -> list:
    """The tensors of an op's arguments or outputs (top level, or one
    list or tuple down), appended to ``out``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class RankCounter(TorchDispatchMode):
    """A dispatch mode that counts one rank's step as PyTorch runs it, on
    any device (``meta`` included):

    * ``live`` / ``peak``: the bytes of the storages alive, each storage
      counted once however many views share it, from its first op's output
      (or :meth:`hold`) until it is freed;
    * ``flops``: FlopCounterMode's per-op formulas
      (``torch.utils.flop_counter.flop_registry``), ``tensor`` where an
      operand is 16-bit (the tensor cores), else ``f32``;
    * ``bytes``: each op's tensor operands and outputs (views, collectives
      and allocations move none).

    The ops of a kernel's plain version (`repro_torch.kernels.work.plain`:
    a CPU run) are skipped; the kernel's formula counts them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.live = 0
        self.peak = 0
        self.flops = {"tensor": 0.0, "f32": 0.0}
        self.bytes = 0.0
        self._held: Dict[int, int] = {}

    def _track(self, t) -> int:
        if not isinstance(t, torch.Tensor):
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def hold(self, *tensors) -> int:
        """Count tensors that exist already (a step's arguments) as live;
        returns the bytes added."""
        return sum(self._track(t) for t in tree_leaves(list(tensors)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if work.in_plain():
            return out
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,),
                        [])
        for t in outs:
            self._track(t)
        if func.namespace in _COLLECTIVES or func.is_view \
                or func._overloadpacket.__name__ in _NO_BYTES:
            return out
        ins = _tensors(kwargs.values(), _tensors(args, []))
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        fn = self._registry.get(func._overloadpacket)
        if fn is not None:
            n = fn(*args, **kwargs, out_val=out)
            cls = "tensor" if any(t.dtype in _SIXTEEN for t in ins) \
                else "f32"
            self.flops[cls] += float(n)
        return out


def model_flops_analytic(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D train / 2·N·D prefill / 2·N·B decode (N active);
    an enc-dec's encoder over ``enc_seq_len`` frames, its decoder over the
    shape's tokens (a prefill one decode step after encoding). The
    reference's formula."""
    n = cfg.active_param_count()
    if cfg.is_encdec:
        n_enc = n * cfg.n_enc_layers / (cfg.n_enc_layers + cfg.n_layers)
        n_dec = n - n_enc
        b = shape.global_batch
        if shape.kind == "train":
            return 6.0 * (n_enc * b * cfg.enc_seq_len
                          + n_dec * b * shape.seq_len)
        if shape.kind == "prefill":
            return 2.0 * (n_enc * b * cfg.enc_seq_len + n_dec * b)
        return 2.0 * n_dec * b
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------

def rank_mesh(sizes: Dict[str, int], profile: str = "default"):
    """The port's mesh of the production mesh ``sizes`` over the running
    (fake) world under ``profile``: ``make_swarm_mesh(pods, data=D,
    model=M)`` and its profile's groups (`repro_torch.launch.mesh.
    use_profile`); with pods the groups over both pods' ranks (the
    reference folds ``pod`` into the batch axes): the data ranks of the
    rank's model index (the served batch's group under ``default``) and
    the whole world. The world rank of every coordinate is the same under
    every profile (`repro_torch.launch.specs.world_rank`). Each group's
    link class is set to ``node`` or ``network`` (`repro_torch.launch.
    roofline.link_of`)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import GroupView, make_swarm_mesh, use_profile
    pods = sizes.get("pod", 1)
    d, m = sizes["data"], sizes["model"]
    mesh, _ = make_swarm_mesh(pods, data=d, model=m)
    use_profile(mesh, profile)
    if pods > 1:
        groups = [dist.new_group([(i * d + k) * m + j for i in range(pods)
                                  for k in range(d)]) for j in range(m)]
        pod_data = GroupView(mesh, groups[mesh.coords["model"]], "batch",
                             "intra")
        mesh.batch_sizes = {"pod": pods, **mesh.inner}
        mesh.axis_views[("pod", "data")] = pod_data
        mesh.axis_views[("pod", "data", "model")] = GroupView(
            mesh, None, "world", "intra")
        if profile == "default":
            mesh.batch_view = pod_data
    views = [mesh, mesh.shard_view, mesh.data_view, mesh.model_view,
             mesh.batch_view, *mesh.axis_views.values()]
    for v in views:
        if v is not None:
            v.link = roofline.link_of(dist.get_process_group_ranks(v.group)
                                      if v.group is not None else
                                      range(dist.get_world_size()))
    return mesh


def _fill(t: torch.Tensor, gen, std: float = 0.02) -> None:
    t.normal_(0.0, std, generator=gen)


class RankStep:
    """One rank's step of a pair on ``device``, built on ``mesh`` (from
    :func:`rank_mesh`, inside a fake world): :attr:`args` what the rank
    holds before the step (its param shard and moments and its batch; or
    its step buffers: compute blocks, caches, tokens), ``self()`` runs one
    step. ``seed`` fills params, caches and tokens (on ``meta`` nothing is
    filled)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh, sizes,
                 device, tc: Optional[TrainConfig] = None,
                 seed: Optional[int] = None):
        from repro_torch.models import build_model
        from repro_torch.models.layers import dtype_of
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.device = torch.device(device)
        self.model = model = build_model(cfg)
        gen = None
        if seed is not None and self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
        pods = sizes.get("pod", 1)
        dev = self.device
        if shape.kind == "train":
            from repro_torch.launch.train import make_train_step
            from repro_torch.optim import adamw_init
            self.tc = tc or TrainConfig(remat=True)
            self.shard = specs.shard_layout(model, sizes, mesh.coords,
                                            mesh.profile)
            self.params = torch.empty(self.shard.local.size,
                                      dtype=dtype_of(cfg.param_dtype),
                                      device=dev)
            if gen is not None:
                for v in self.shard.local.unflatten(self.params).values():
                    _fill(v, gen)
            self.opt = adamw_init(self.shard.local.parts(self.params))
            b = shape.global_batch
            if mesh.profile == "default" and b % pods == 0:
                b //= pods                            # a pod's batch
            # (dp and zero3: pods replicate the logical batch's rows)
            self.batch = self._batch(b, gen)
            self.step = make_train_step(model, self.tc)
            self.args = [self.params, self.opt, self.batch]
            return
        from repro_torch.launch import serve
        b, t = shape.global_batch, specs.cache_len(cfg, shape)
        self.st = st = serve.step_buffers(model, b, t, dev, mesh)
        if shape.kind == "prefill" and cfg.is_encdec:
            self.programs = [serve.encode_step_for(model, b, t, dev, mesh),
                             serve.serve_step_for(model, b, t, dev, mesh)]
            self.pos = 0
        elif shape.kind == "prefill":
            self.programs = [serve.prefill_step_for(model, b, shape.seq_len,
                                                    t, dev, mesh)]
            self.pos = None
        else:
            self.programs = [serve.serve_step_for(model, b, t, dev, mesh)]
            self.pos = t - 1
        buffers = [st.params, st.caches, st.tok, st.pos, st.logits,
                   list(st.prompts.values()), st.frames, st.patches]
        self.args = [x for x in buffers if x is not None]
        if gen is not None:
            for v in st.views.values():
                _fill(v, gen)
            for x in tree_leaves([st.caches, st.frames, st.patches]):
                if x is not None:
                    _fill(x, gen, 1.0)
            for p in st.prompts.values():
                p.random_(0, cfg.vocab_size, generator=gen)
            st.tok.random_(0, cfg.vocab_size, generator=gen)

    def _batch(self, b: int, gen) -> dict:
        cfg, s, dev = self.cfg, self.shape.seq_len, self.device
        out = {}
        for key in ("tokens", "labels"):
            out[key] = torch.empty((b, s), dtype=torch.long, device=dev)
            if gen is not None:
                out[key].random_(0, cfg.vocab_size, generator=gen)
        extra = {}
        if cfg.family == "vlm":
            extra["patch_embeds"] = (b, cfg.n_patches, cfg.frontend_dim)
        if cfg.is_encdec:
            extra["frames"] = (b, cfg.enc_seq_len, cfg.frontend_dim)
        for key, shp in extra.items():
            out[key] = torch.empty(shp, dtype=torch.float32, device=dev)
            if gen is not None:
                _fill(out[key], gen, 1.0)
        return out

    def __call__(self):
        """One step; returns what it outputs (the train step's metrics, or
        the step buffers' logits and token)."""
        if self.shape.kind == "train":
            _, _, metrics = self.step.split(self.params, self.opt,
                                            self.batch, shard=self.shard,
                                            mesh=self.mesh)
            return metrics
        if self.pos is not None:
            self.st.pos.fill_(self.pos)
        for prog in self.programs:
            prog.run()
        return [self.st.logits, self.st.tok]


def release_serving() -> None:
    """Drop the cached step buffers and programs (a played rank's serving
    state is its own: the next rank is another mesh)."""
    from repro_torch.launch import serve
    for fn in (serve.step_buffers, serve.serve_step_for,
               serve.prefill_step_for, serve.encode_step_for):
        fn.cache_clear()


def _link_bytes(mesh) -> Dict[str, Dict[str, int]]:
    return {link: dict(kinds) for link, kinds in mesh.link_counts.items()}


def count_step(step: RankStep, profile: bool = False) -> dict:
    """One step of ``step`` under a :class:`RankCounter` and the kernels'
    counter: its memory (``argument``, ``output``, ``temp``, ``peak``
    bytes), FLOPs by rate class, bytes, kernel calls and collective bytes
    by link class and kind; with ``profile`` (on the card) also
    ``device_ms``, the step's CUDA kernels' own time summed from
    ``torch.profiler`` tracing CUDA activity alone (the counter's host
    work adds none of it)."""
    from contextlib import nullcontext
    step.mesh.reset_counts()
    t0 = time.perf_counter()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    with prof or nullcontext(), RankCounter() as counter, \
            work.counting() as kw:
        arg_bytes = counter.hold(*step.args)
        out = step()
        out_bytes = sum(_nbytes(t) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
        if profile:
            torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    links = _link_bytes(step.mesh)
    coll = sum(sum(k.values()) for k in links.values())
    network = sum(links.get("network", {}).values())
    return {
        "memory": {"argument_bytes_per_device": arg_bytes,
                   "output_bytes_per_device": out_bytes,
                   "temp_bytes_per_device": counter.peak - arg_bytes,
                   "peak_bytes_per_device": counter.peak},
        "flops": {"tensor": counter.flops["tensor"] + kw.flops["tensor"],
                  "f32": counter.flops["f32"] + kw.flops["f32"]},
        "op_flops": dict(counter.flops), "kernel_flops": dict(kw.flops),
        "bytes": counter.bytes + kw.bytes,
        "kernels": dict(kw.calls),
        "coll": float(coll), "coll_network": float(network),
        "coll_detail": links, "run_s": run_s,
        "device_ms": None if prof is None else _kernel_ms(prof),
    }


def _kernel_ms(prof) -> float:
    """The CUDA kernels' own time in a finished CUDA-only trace, summed
    over the trace's raw records (building the profiler's event tree for a
    whole train step's kernels takes seconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6


def play(arch: str, shape_name: str, mesh_name: str = "single", *,
         model_rank: int = 0, data_rank: int = 0, device="meta",
         tc: Optional[TrainConfig] = None, seed: Optional[int] = None,
         profile: bool = False, then=None, cfg: Optional[ModelConfig] = None,
         shape: Optional[ShapeConfig] = None,
         sizes: Optional[Dict[str, int]] = None,
         sharding: str = "default") -> dict:
    """Rank ``(data_rank, model_rank)`` of node position 0 of the pair's
    production mesh under the sharding profile ``sharding``, played in a
    fake world on ``device``: its :func:`count_step` record (``profile``:
    its device time too), with ``rank`` (the world rank), ``coords`` and
    ``build_s``. ``then(step)``, if given, runs inside the world after the
    count. ``cfg``, ``shape`` and ``sizes`` replace the arch's config, the
    named shape and the named mesh (a small rank for a test)."""
    from repro_torch.launch.mesh import fake_world
    sizes = sizes or specs.PRODUCTION[mesh_name]
    shape = shape or SHAPES_BY_NAME[shape_name]
    cfg = cfg or adapt_for_shape(get_config(arch), shape)
    coords = {"node": 0, "data": data_rank, "model": model_rank}
    world = 1
    for s in sizes.values():
        world *= s
    rank = specs.world_rank(coords, sizes)
    t0 = time.perf_counter()
    with fake_world(world, rank):
        try:
            mesh = rank_mesh(sizes, sharding)
            step = RankStep(cfg, shape, mesh, sizes, device, tc, seed)
            build_s = time.perf_counter() - t0
            rec = count_step(step, profile)
            if then is not None:
                rec["then"] = then(step)
        finally:
            release_serving()
    rec.update(rank=rank, coords=coords, build_s=build_s, profile=sharding)
    return rec


def run_pair(arch: str, shape_name: str, multi: bool,
             tc: Optional[TrainConfig] = None, *, do_stats: bool = True,
             ranks: str = "ends", device="meta",
             profile: str = "default") -> dict:
    """The dry-run row of one pair under ``profile``: its played ranks
    (model ranks 0 and M − 1 of data index 0, or every model rank with
    ``ranks="all"``), the heaviest one's memory and, with ``do_stats``,
    its per-device stats and roofline."""
    mesh_name = "multi" if multi else "single"
    sizes = specs.PRODUCTION[mesh_name]
    chips = 1
    for s in sizes.values():
        chips *= s
    shape = SHAPES_BY_NAME[shape_name]
    cfg = adapt_for_shape(get_config(arch), shape)
    m = sizes["model"]
    which = range(m) if ranks == "all" else sorted({0, m - 1})
    t0 = time.perf_counter()
    played = [play(arch, shape_name, mesh_name, model_rank=r, device=device,
                   tc=tc, sharding=profile) for r in which]
    build_s = time.perf_counter() - t0
    top = max(played, key=lambda r: r["memory"]["peak_bytes_per_device"])
    peak = top["memory"]["peak_bytes_per_device"]
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi else "16x16", "chips": chips,
        "build_s": build_s, "memory": top["memory"],
        "fits": peak <= roofline.HBM_BYTES,
        "card": roofline.CARD, "card_bytes": roofline.HBM_BYTES,
        "ranks": played, "status": "ok", "profile": profile,
        "model_flops_global": model_flops_analytic(cfg, shape),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if do_stats:
        slow = max(played, key=lambda r: _roof(arch, shape_name, rec, r
                                                ).bound_s)
        rec["per_device_stats"] = {
            "flops": slow["flops"]["tensor"] + slow["flops"]["f32"],
            "f32_flops": slow["flops"]["f32"], "bytes": slow["bytes"],
            "coll": slow["coll"], "coll_network": slow["coll_network"],
            "rank": slow["rank"]}
        rec["roofline"] = _roof(arch, shape_name, rec, slow).row()
    return rec


def _roof(arch, shape_name, rec, r) -> roofline.Roofline:
    return roofline.Roofline(
        arch=arch, shape=shape_name, mesh=rec["mesh"], chips=rec["chips"],
        hlo_flops=r["flops"]["tensor"] + r["flops"]["f32"],
        f32_flops=r["flops"]["f32"], hlo_bytes=r["bytes"],
        coll_bytes=r["coll"], coll_network=r["coll_network"],
        model_flops=rec["model_flops_global"] / rec["chips"],
        coll_detail=r["coll_detail"])


# ---------------------------------------------------------------------------
# the card check: five ranks played on the card against their meta count
# ---------------------------------------------------------------------------

#: ``(label, arch, shape, layers, profile)`` the card plays as model rank
#: M − 1 of data index 0 (the last query rows: the most causal work);
#: ``layers`` None is the config's depth. The train steps are cut to 8 of
#: Hymba's 32 layers (one of them global attention) to keep the card's
#: check within a minute: a rank's meta step walks every piece of every
#: layer's compute blocks in Python (about 4,000 ops a layer here). (d)
#: is (a)'s pair under ``dp`` (one row of 4,096 a rank, the replica
#: group's all_reduce), (e) the stored serving form under ``zero3`` (2
#: rows of 32,768)
CARD_PAIRS = (("a", "hymba-1.5b", "train_4k", 8, "default"),
              ("b", "nemotron-4-15b", "prefill_32k", None, "default"),
              ("c", "deepseek-coder-33b", "decode_32k", None, "default"),
              ("d", "hymba-1.5b", "train_4k", 8, "dp"),
              ("e", "hymba-1.5b", "prefill_32k", None, "zero3"))
#: the measured peak within this share of the meta prediction (the CUDA
#: caching allocator rounds each block and keeps a cuBLAS workspace)
PEAK_BAND = 0.10


def card_pair(arch: str, shape_name: str, *, layers: Optional[int] = None,
              seed: int = 0, profile: str = "default") -> dict:
    """One pair's rank ``(0, M − 1)`` on ``(16, 16)`` under ``profile``,
    played on ``meta`` and then on the card (CUDA kernels, values from
    ``seed``): the meta prediction, the card's count of the same step
    (FLOPs by the same counters) and its profiled device time, the
    measured peak (``max_memory_allocated`` above the memory before the
    pair), and the roofline's bound of the rank. Raises where the peak
    leaves the band or the FLOPs differ."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg = adapt_for_shape(get_config(arch), shape)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    m = specs.PRODUCTION["single"]["model"]
    kw = dict(model_rank=m - 1, cfg=cfg, shape=shape, sharding=profile)
    t0 = time.perf_counter()
    gc.collect()            # the last pair's graph, before this one counts
    gc_s = time.perf_counter() - t0
    meta = play(arch, shape_name, **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def then(step):
        torch.cuda.synchronize()
        return {"peak": torch.cuda.max_memory_allocated() - base}

    card = play(arch, shape_name, device="cuda", seed=seed, profile=True,
                then=then, **kw)
    del card["coll_detail"]
    rec = {"arch": arch, "shape": shape_name, "layers": cfg.n_layers,
           "profile": profile, "rank": meta["rank"], "coords": meta["coords"],
           "meta_peak": meta["memory"]["peak_bytes_per_device"],
           "card_peak": card["then"]["peak"],
           "meta_flops": meta["flops"], "card_flops": card["flops"],
           "kernels": meta["kernels"], "card_kernels": card["kernels"],
           "gc_s": gc_s, "meta_s": meta["build_s"] + meta["run_s"],
           "card_s": card["build_s"] + card["run_s"],
           "wall_s": time.perf_counter() - t0}
    rec["peak_rel_err"] = abs(rec["meta_peak"] - rec["card_peak"]) / max(
        rec["card_peak"], 1)
    roof = _roof(arch, shape_name, {"mesh": "16x16", "chips": 256,
                                    "model_flops_global":
                                        model_flops_analytic(cfg, shape)},
                 meta)
    rec.update(compute_s=roof.compute_s, memory_s=roof.memory_s,
               collective_s=roof.collective_s, bound_ms=roof.bound_s * 1e3,
               device_ms=card["device_ms"])
    if rec["peak_rel_err"] > PEAK_BAND:
        raise AssertionError(f"{arch} × {shape_name} ({profile}): the meta "
                             f"peak {rec['meta_peak']} is not within "
                             f"{PEAK_BAND:.0%} of the card's "
                             f"{rec['card_peak']}")
    if rec["meta_flops"] != rec["card_flops"] or \
            rec["kernels"] != rec["card_kernels"]:
        raise AssertionError(f"{arch} × {shape_name} ({profile}): FLOPs "
                             f"{rec['meta_flops']}"
                             f" / kernels {rec['kernels']} on meta, "
                             f"{rec['card_flops']} / {rec['card_kernels']} "
                             "on the card")
    return rec


def _ulp_check(got, want, atol, rtol, what):
    err = (got.float() - want.float()).abs()
    if bool((err > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{what}: max err {float(err.max())}")
    return float(err.max())


#: the flash calls of the card pairs: ``(pair, b, heads, KV heads, queries,
#: keys, head dim, q_off, window, plain slice)``, the slice ``(rows, KV
#: groups, last query rows)`` whose plain f32 scores fit (None: whole)
CARD_FLASH = (("b", 2, 48, 8, 2048, 32768, 128, 30720, 0, (1, 1, None)),
              ("d", 1, 25, 5, 4096, 4096, 64, 0, 0, (1, 5, None)),
              ("d", 1, 25, 5, 4096, 4096, 64, 0, 1024, (1, 5, None)),
              ("e", 2, 25, 5, 32768, 32768, 64, 0, 0, (1, 1, 2048)),
              ("e", 2, 25, 5, 32768, 32768, 64, 0, 1024, (1, 1, 2048)))
#: the SSD calls: ``(pair, rows, tokens, heads, head dim, state, chunk,
#: plain rows)``
CARD_SSD = (("a", 16, 4096, 50, 64, 16, 256, 2),
            ("d", 1, 4096, 50, 64, 16, 256, 1),
            ("e", 2, 32768, 50, 64, 16, 256, 1))


def _bound(tf, f32f, nbytes):
    """``(bound ms, bound_by)`` of a kernel's work at the H100's rates."""
    ops_s = tf / roofline.BF16_FLOPS + f32f / roofline.F32_FLOPS
    mem_s = nbytes / roofline.HBM_BW
    return max(ops_s, mem_s) * 1e3, "operations" if ops_s > mem_s \
        else "bytes"


def _card_flash(case, time_call, gen) -> dict:
    """One :data:`CARD_FLASH` call: the kernel against its plain version
    on the slice (bf16 within one ulp: atol 2e-4, rtol 8e-3), the
    kernel's ms, the plain ms where the slice is the whole call, the
    bound, and one SDPA call's ms where there is one (a
    lower-right causal bias with a query offset, ``is_causal`` without a
    window, the boolean mask with one where its scores fit)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain
    pair, b, h, hkv, s, t, d, q_off, window, (rows, groups, last) = case
    bf, dev = torch.bfloat16, "cuda"
    q = torch.randn(b, h, s, d, device=dev, generator=gen).to(bf)
    k = torch.randn(b, hkv, t, d, device=dev, generator=gen).to(bf)
    v = torch.randn(b, hkv, t, d, device=dev, generator=gen).to(bf)
    call = lambda: fa.flash_attention(q, k, v, causal=True, window=window,
                                      q_off=q_off)
    got = call()
    g = groups * (h // hkv)
    lo = 0 if last is None else s - last
    plain = lambda: flash_attention_plain(
        q[:rows, :g, lo:], k[:rows, :groups], v[:rows, :groups],
        causal=True, window=window, q_off=q_off + lo)
    err = _ulp_check(got[:rows, :g, lo:], plain(), 2e-4, 8e-3,
                     f"flash at ({pair})'s shape, window {window}")
    whole = rows == b and groups == hkv and lo == 0
    tf, f32f, nbytes = work.flash_work(b, h, hkv, s, t, d, 2, True, window,
                                       q_off)
    bound_ms, bound_by = _bound(tf, f32f, nbytes)
    row = dict(pair=pair, shape=[b, h, s, d], kv=[b, hkv, t, d],
               q_off=q_off, window=window, max_abs_err=err,
               ms=time_call(call), plain_slice=[rows, g, s - lo, d],
               plain_ms=time_call(plain) if whole else None,
               bound_ms=bound_ms, bound_by=bound_by, gflop=tf / 1e9,
               library_ms=None)
    try:
        if q_off:
            from torch.nn.attention.bias import causal_lower_right
            lib = dict(attn_mask=causal_lower_right(s, t))
        elif not window:
            lib = dict(is_causal=True)
        elif s * t <= 1 << 26:
            i = torch.arange(s, device=dev)[:, None]
            j = torch.arange(t, device=dev)[None]
            lib = dict(attn_mask=(j <= i) & (j > i - window))
        else:
            lib = None
        if lib is not None:
            row["library_ms"] = time_call(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       enable_gqa=True,
                                                       **lib))
    except Exception as e:  # noqa: BLE001
        row["library_error"] = repr(e)[:200]
    return row


def _card_ssd(case, time_call, gen) -> dict:
    """One :data:`CARD_SSD` call: the kernel against its plain version on
    its first rows (y in bf16 within 2e-2, the f32 state within 1e-4),
    the kernel's ms, the plain ms where those rows are all of them, the
    bound; no one library call computes it."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_plain
    pair, bs, ls, hs, p, n, chunk, rows = case
    bf, dev = torch.bfloat16, "cuda"
    x = torch.randn(bs, ls, hs, p, device=dev, generator=gen).to(bf)
    dt = torch.rand(bs, ls, hs, device=dev, generator=gen) * 0.1 + 0.05
    alog = torch.log(torch.linspace(1, 16, hs, device=dev))
    bm = (torch.randn(bs, ls, 1, n, device=dev, generator=gen) * 0.5).to(bf)
    cm = (torch.randn(bs, ls, 1, n, device=dev, generator=gen) * 0.5).to(bf)
    call = lambda: ss.ssd_scan(x, dt, alog, bm, cm, chunk=chunk)
    y, st = call()
    plain = lambda: ssd_scan_plain(x[:rows], dt[:rows], alog, bm[:rows],
                                   cm[:rows], chunk=chunk)
    yw, sw = plain()
    err_y = _ulp_check(y[:rows], yw, 2e-2, 2e-2, f"ssd y at ({pair})'s shape")
    err_s = _ulp_check(st[:rows], sw, 1e-4, 1e-4,
                       f"ssd state at ({pair})'s shape")
    del y, st, yw, sw
    tf, f32f, nbytes = work.ssd_work(bs, ls, hs, p, 1, n, chunk, 2, hs)
    bound_ms, bound_by = _bound(tf, f32f, nbytes)
    return dict(pair=pair, shape=[bs, ls, hs, p, n, chunk],
                max_abs_err=err_y, max_abs_err_state=err_s,
                ms=time_call(call), plain_slice=[rows, ls, hs, p],
                plain_ms=time_call(plain) if rows == bs else None,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                gflop=(tf + f32f) / 1e9)


def card_kernels(time_call, seed: int = 5) -> dict:
    """The two kernels at every shape the card pairs launch them at
    (:data:`CARD_FLASH`, :data:`CARD_SSD`), each against its plain
    version on a slice of rows, heads and query rows whose f32 scores fit,
    with its device ms (``time_call``: five calls after two, one trace,
    CUDA events where it loses kernel records), its bound at the H100's
    rates (the kernels' work formulas) and the library's one call where
    there is one."""
    timed = time_call
    time_call = lambda fn: timed(fn, iters=5, warm=2, tries=1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"flash_attention": [], "ssd_scan": []}
    for name, cases, fn in (("flash_attention", CARD_FLASH, _card_flash),
                            ("ssd_scan", CARD_SSD, _card_ssd)):
        for case in cases:
            out[name].append(fn(case, time_call, gen))
            torch.cuda.empty_cache()
    return out


def card_phase(time_call, pairs=CARD_PAIRS) -> dict:
    """``chip_smoke.py``'s ``dryrun`` phase: each of ``pairs`` played on
    ``meta`` and on the card (:func:`card_pair`), then the two kernels at
    their shapes (:func:`card_kernels`). ``time_call(fn, iters, warm,
    tries)`` is the script's device-ms timer for the kernels; a pair's
    step is profiled in its counted run. Returns the pairs' records (each
    with its kernels' launches on the card, which must hold every kernel
    its meta count calls), the kernels' rows and the launches of all the
    pairs."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    rows, launches = [], {}
    for label, arch, shape, layers, prof in pairs:
        reset_launches()
        rec = dict(card_pair(arch, shape, layers=layers, profile=prof),
                   pair=label)
        rec["launches"] = {k: v for k, v in LAUNCHES.items() if v}
        if set(rec["kernels"]) - set(rec["launches"]):
            raise AssertionError(f"({label}): kernels {rec['kernels']} "
                                 f"counted, {rec['launches']} launched")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        rows.append(rec)
    release_serving()
    torch.cuda.empty_cache()
    return {"pairs": rows, "kernels": card_kernels(time_call),
            "launches": launches}


def _tag(arch: str, shape: str, multi: bool, profile: str = "default",
         accum: int = 1) -> str:
    """A row's file tag, the reference's: ``{arch}_{shape}_{single|multi}``,
    then ``_{profile}`` for a profile other than ``default`` and
    ``_accum{A}`` for accumulation."""
    tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
    if profile != "default":
        tag += f"_{profile}"
    return tag + (f"_accum{accum}" if accum > 1 else "")


def table(out: str, mesh: str = "single", profile: str = "default") -> str:
    """The markdown table of the rows under ``out`` for ``mesh`` and
    ``profile``: a rank's peak GiB, whether it fits, and the dominant
    roofline term with the three terms (seconds), an arch a row, a shape a
    column."""
    rows = {}
    ending = _tag("", "", mesh == "multi", profile)[1:] + ".json"
    for name in sorted(os.listdir(out)):
        if name.endswith(ending):
            with open(os.path.join(out, name)) as f:
                rec = json.load(f)
            rows[(rec["arch"], rec["shape"])] = rec
    shapes = [s.name for s in INPUT_SHAPES]
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "|---|" + "---|" * len(shapes)]
    for arch in ARCH_IDS:
        cells = []
        for shape in shapes:
            rec = rows.get((arch, shape))
            if rec is None or rec["status"] != "ok":
                cells.append("FAIL" if rec else "—")
                continue
            cell = (f"{rec['memory']['peak_bytes_per_device'] / 2 ** 30:.2f}"
                    f" GiB{'' if rec['fits'] else ' (does not fit)'}")
            rf = rec.get("roofline")
            if rf:
                cell += (f"; {rf['dominant']} ({rf['compute_s']:.3g} / "
                         f"{rf['memory_s']:.3g} / {rf['collective_s']:.3g})")
            cells.append(cell)
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-stats", action="store_true",
                    help="memory only (skip the roofline)")
    ap.add_argument("--profile", default="default", choices=list(PROFILES))
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatch gradient-accumulation steps (train)")
    ap.add_argument("--ranks", default="ends", choices=["ends", "all"],
                    help="model ranks played: 0 and M-1, or every one")
    ap.add_argument("--table", action="store_true",
                    help="print the markdown table of the rows in --out "
                         "for each --mesh, and play nothing")
    args = ap.parse_args(argv)
    if args.table:
        for mesh in {"single": ["single"], "multi": ["multi"],
                     "both": ["single", "multi"]}[args.mesh]:
            print(table(args.out, mesh, args.profile) + "\n")
        return 0

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in INPUT_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    tc = TrainConfig(remat=True, accum_steps=args.accum)
    os.makedirs(args.out, exist_ok=True)
    failures: List[str] = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = _tag(arch, shape, multi, args.profile, args.accum)
                path = os.path.join(args.out, tag + ".json")
                t0 = time.time()
                try:
                    rec = run_pair(arch, shape, multi, tc,
                                   do_stats=not multi and not args.no_stats,
                                   ranks=args.ranks, profile=args.profile)
                    dom = rec.get("roofline", {}).get("dominant", "-")
                    gib = rec["memory"]["peak_bytes_per_device"] / 2 ** 30
                    print(f"[ok]   {tag}  build={rec['build_s']:.1f}s "
                          f"peak/dev={gib:.2f}GiB fits={rec['fits']} "
                          f"dominant={dom}  ({time.time() - t0:.0f}s)",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "profile": args.profile,
                           "status": "FAIL", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=float)
    print(f"\n{len(failures)} failures: {failures}" if failures
          else "\nALL PAIRS PLAYED")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
