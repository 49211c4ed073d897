"""Serving primitives: batched greedy decode against the KV cache / SSM
state. Port of ``repro.launch.serve``.

``make_logits_step`` is the raw-logits form the continuous-batching
engine (`repro_torch.serve`) runs over nodes and slots.

``serve_step_for`` / ``prefill_step_for`` are the counterparts of the
reference's cached jitted steps: captured programs
(`repro_torch.launch.capture`), cached per (model, batch, max_len[, seq],
device), over one :class:`StepBuffers` per (model, batch, max_len,
device) — one node's params (the caller's copied in, unless the caller
passes this buffer itself), the caches, the token fed ``[B, 1]`` and the
per-row position ``[B]``, both int64 on the device. The decode step feeds
its own token and advances the position on the card, so ``generate``
replays it back to back with no host work between tokens.

**Over a model group** (``mesh``: a `repro_torch.launch.mesh.SwarmMesh`
with ``model`` = M > 1, e.g. ``make_swarm_mesh(1, model=M)`` on a world
of M ranks, each calling with the same arguments): the rank's buffers
hold only its **compute blocks** (`repro_torch.sharding.rules.
compute_blocks`, sliced once from the node's flat vector and never
gathered again), its cut of the caches (`repro_torch.sharding.rules.
cache_shapes`: K/V on its KV heads or its slice of the head dim, the SSM
state on its heads) and its plan (`repro_torch.sharding.tensor.
TensorPlan`); the model's forward divides each layer's work over the
group as the reference's ``sharding_rules`` place it (a prefill M divides
with the residual cut on the sequence, every decode step and any other
prompt with the residual whole). The greedy token is the argmax of the
all_gathered vocab-cut logits (or of the whole logits, where M does not
divide the vocab), the same on every rank (``torch.argmax``'s first-index
tie rule). On a gloo group the programs run eagerly
(`repro_torch.launch.capture.ProgramPool` with ``eager``): gloo stages
through host memory, which a CUDA graph cannot hold.

**From a stored shard** (``mesh`` under the dry run's ``dp`` or
``zero3`` profile, `repro_torch.launch.mesh.use_profile`: no tensor
parallelism): the rank's buffer holds its shard of the node's params
(`repro_torch.launch.specs.shard_layout`), each layer is gathered whole
just before its block from the store group (`repro_torch.models.gather.
NodeSplit` under ``no_grad``), its rows are the ones the profile's input
cut gives it and its caches are at the profile's shard shapes
(`repro_torch.sharding.stored`: ``zero3``'s cache keeps its model cut
and is gathered per layer by a decode step). The logits are whole.

An enc-dec model (no prefill: ``generate`` feeds its prompt token by token
against the zeroed caches, ``enc_out`` zero, as the reference's does) has
:func:`encode_step_for`: the encoder over the buffers' ``frames`` into
the caches' ``enc_out`` (over a model group the frames' residual cut where
M divides them, the output gathered whole into every rank's ``enc_out``;
the self-attention's cache is the rank's cut). An encode followed by the
first decode step is the counterpart of the reference's enc-dec prefill
lowering (``repro.launch.dryrun``: ``encode``, then the first decoder
step).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.flat import FlatLayout
from repro_torch.launch.capture import Program, ProgramPool
from repro_torch.models import Model
from repro_torch.models.layers import dtype_of
from repro_torch.sharding import tensor


def make_logits_step(model: Model) -> Callable:
    """(params, tokens [B,S], caches, cache_pos[, commit]) -> (logits
    [B,S,V], caches).

    The raw decode primitive: one forward against the cache, no sampling.
    With S > 1 and cache_pos = 0 it doubles as prefill (attention writes
    tokens 0..S-1 in place and the causal mask hides everything past the
    query position), which is how the serve engine runs both phases
    through one function. ``cache_pos`` may be an int tensor ``[B]`` (a
    position per row) and ``commit`` a bool ``[B]`` (the rows whose caches
    change).
    """

    def logits_step(params, tokens, caches, cache_pos, commit=None):
        return model.decode(params, tokens, caches, cache_pos, commit=commit)

    return logits_step


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor of a cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree, in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def take_block(t: torch.Tensor, ivs) -> torch.Tensor:
    """The compute block of ``t``: per dimension the ``(start, length)``
    intervals ``ivs`` (`repro_torch.sharding.rules.compute_cut`), joined
    in order."""
    for dim, iv in enumerate(ivs):
        if iv == ((0, t.shape[dim]),):
            continue
        t = torch.cat([t.narrow(dim, a, n) for a, n in iv], dim=dim)
    return t


class StepBuffers:
    """The static buffers of one (model, batch, max_len, device[, mesh])
    set of step programs: one node's params ``[P]`` (over a model group
    the rank's compute blocks ``[P_rank]``, under ``layout``), the caches
    (the rank's cut), the token fed ``tok [B, 1]``, the position ``pos
    [B]`` (int64), the last position's logits ``logits [B, V]`` (whole:
    gathered over the vocab cut), a padded prompt ``[B, S]`` per prefill
    length, for an enc-dec the frames ``[B, enc_seq_len, frontend_dim]``
    (f32) an encode reads and for a vlm the patch embeddings ``[B,
    n_patches, frontend_dim]`` (f32) a prefill reads. ``plan`` is the
    rank's `repro_torch.sharding.tensor.TensorPlan`, or None.

    On a mesh whose data group (or ``mesh.batch_view``) has ``D`` > 1
    ranks, ``batch`` is the whole batch, placed as the reference's
    ``batch_specs`` / ``cache_specs`` place it: where ``D`` divides it
    the rank serves its ``B / D`` rows (:attr:`rows`), else every row,
    with the K/V cache's sequence cut over the group where ``D`` divides
    ``max_len`` (:attr:`seq`: ``T / D`` positions a rank, the plan's
    ``seq_view``)."""

    def __init__(self, model: Model, batch: int, max_len: int,
                 device: torch.device, mesh=None):
        self.model = model
        cfg = model.cfg
        self.plan = self.split = self.cache_plan = None
        if mesh is not None and mesh.profile != "default":
            self._stored(model, batch, max_len, device, mesh)
            return
        if mesh is not None:
            from repro_torch.launch.train import tensor_plan
            self.plan = tensor_plan(model, mesh)
        self.layout, place = model.layout, None
        #: the rows of the caller's batch this rank serves (None: all)
        self.rows, seq = None, 1
        view = None if mesh is None else (mesh.batch_view or mesh.data_view)
        if self.plan is not None and view is not None \
                and view.world_size > 1:
            n = view.world_size
            if batch % n == 0:          # the batch's rows over the group
                batch //= n
                self.rows = slice(view.rank * batch, (view.rank + 1) * batch)
            elif max_len % n == 0:      # else the cache's sequence
                seq = n
                self.plan = self.plan.with_seq(view)
        self.seq = seq
        if self.plan is not None:
            from repro_torch.sharding.rules import compute_blocks
            place = self.plan.place
            self.blocks = compute_blocks(model.layout, cfg, place,
                                         self.plan.rank)
            self.layout = FlatLayout(
                [(lf.path, tuple(sum(n for _, n in iv)
                                 for iv in self.blocks[lf.path]))
                 for lf in model.layout.leaves], model.layout.wide)
        self._buffers(batch, max_len, device, place, seq)
        # gloo stages through host memory, which a graph cannot hold; a
        # fake world's step runs once, as it is counted
        self.graphs = ProgramPool(device, eager=self.plan is not None and
                                  self.plan.view.backend in ("gloo", "fake"))

    def _stored(self, model: Model, batch: int, max_len: int, device,
                mesh) -> None:
        """The stored form (see the module docstring)."""
        from repro_torch.launch import specs
        from repro_torch.models.gather import NodeSplit
        from repro_torch.sharding import rules, stored
        sizes, profile = mesh.batch_sizes, mesh.profile
        self.rows, seq, seq_view = None, 1, None
        cut = specs.batch_cut(batch, sizes, profile)
        if cut is not None:             # the input's rows over their axes
            view = mesh.axis_views[cut]
            batch //= view.world_size
            self.rows = slice(view.rank * batch, (view.rank + 1) * batch)
        else:                           # else the cache's sequence
            ba = specs.batch_axes(sizes, profile)
            n = math.prod(sizes[a] for a in ba)
            if n > 1 and max_len % n == 0:
                seq, seq_view = n, mesh.axis_views[ba]
        self.seq = seq
        place = rules.profile_cache_cut(model.cfg, profile,
                                        sizes.get("model", 1))
        self.cache_plan = stored.CachePlan(place, mesh.model_view, seq_view)
        self.shard = specs.shard_layout(model, mesh.inner, mesh.coords,
                                        profile)
        self.layout = self.shard.local
        dtype = dtype_of(model.cfg.param_dtype)
        self.split = NodeSplit(self.shard, mesh.store_view, None, dtype=dtype,
                               device=device)
        self._buffers(batch, max_len, device, place, seq)
        self.graphs = ProgramPool(device, eager=mesh.backend in ("gloo",
                                                                 "fake"))

    def _buffers(self, batch: int, max_len: int, device, place,
                 seq: int) -> None:
        cfg, model = self.model.cfg, self.model
        self.params = torch.zeros(self.layout.size,
                                  dtype=dtype_of(cfg.param_dtype),
                                  device=device)
        self.views = self.layout.unflatten(self.params)
        self.caches = (model.init_cache(batch, max_len, device) if place is
                       None else model.init_cache(batch, max_len, device,
                                                  place=place, seq=seq))
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.pos = torch.zeros(batch, dtype=torch.long, device=device)
        self.logits = torch.zeros((batch, cfg.padded_vocab),
                                  dtype=dtype_of(cfg.compute_dtype),
                                  device=device)
        self.prompts: Dict[int, torch.Tensor] = {}
        self.frames = (torch.zeros((batch, cfg.enc_seq_len, cfg.frontend_dim),
                                   dtype=torch.float32, device=device)
                       if cfg.is_encdec else None)
        self.patches = (torch.zeros((batch, cfg.n_patches, cfg.frontend_dim),
                                    dtype=torch.float32, device=device)
                        if cfg.family == "vlm" else None)

    def load(self, params: torch.Tensor) -> None:
        """One node's flat params ``[P]`` (any device) into the buffer:
        whole, the rank's compute block of every leaf, or its shard."""
        if self.split is not None:
            self.params.copy_(self.shard.shard(params.to(self.params.device)))
            return
        if self.plan is None:
            self.params.copy_(params)
            return
        whole = self.model.layout.unflatten(params)
        for path, ivs in self.blocks.items():
            self.views[path].copy_(take_block(whole[path], ivs))

    def step(self, batch: Optional[dict] = None, tokens=None,
             cache_pos=None) -> torch.Tensor:
        """The model's forward of a step program: a prefill of ``batch``,
        else a decode of ``tokens`` at ``cache_pos``; its logits (over a
        model group the rank's vocab cut)."""
        from repro_torch.sharding import stored
        plan = self._plan()
        with stored.cache_group(self.cache_plan):
            if batch is not None:
                return self.model.prefill(self.views, batch, self.caches,
                                          **plan)[0]
            return self.model.decode(self.views, tokens, self.caches,
                                     cache_pos, **plan)[0]

    def _plan(self) -> dict:
        if self.split is not None:
            return {"split": self.split}
        return {} if self.plan is None else {"plan": self.plan}

    def encode(self) -> None:
        """The encoder output of ``frames`` into the caches' ``enc_out``
        (over a model group, whole on every rank)."""
        plan = self._plan()
        self.caches["enc_out"].copy_(self.model.encode(
            self.views, self.frames, **plan))

    def pick(self, logits: torch.Tensor) -> None:
        """The last position's logits (the rank's vocab cut, all_gathered
        over the model group; whole where M does not divide the vocab)
        into ``logits``, their greedy token into ``tok``."""
        last = logits[:, -1]
        if self.plan is not None and self.plan.place.vocab:
            with torch.no_grad(), tensor.model_group(self.plan):
                last = tensor.gather(last, dim=-1)
        self.logits.copy_(last)
        self.tok.copy_(torch.argmax(last, dim=-1, keepdim=True))


def _on(mesh) -> tuple:
    """The trailing ``mesh`` argument of the cached step functions, left
    out when None: ``lru_cache`` keys a call by the arguments as passed,
    so the single-process form keeps the key of a caller that names no
    mesh."""
    return () if mesh is None else (mesh,)


@functools.lru_cache(maxsize=None)
def step_buffers(model: Model, batch: int, max_len: int,
                 device: torch.device, mesh=None) -> StepBuffers:
    return StepBuffers(model, batch, max_len, device, mesh)


@functools.lru_cache(maxsize=None)
def serve_step_for(model: Model, batch: int, max_len: int,
                   device: torch.device, mesh=None) -> Program:
    """The decode step: ``tok`` at ``pos`` → the greedy next token in
    ``tok`` (its logits in ``logits``), ``pos`` + 1, the caches written
    at ``pos``; over ``mesh``'s model group the rank's share."""
    st = step_buffers(model, batch, max_len, device, *_on(mesh))

    def body():
        st.pick(st.step(tokens=st.tok, cache_pos=st.pos))
        st.pos.add_(1)

    return st.graphs.capture(body)


@functools.lru_cache(maxsize=None)
def prefill_step_for(model: Model, batch: int, seq: int, max_len: int,
                     device: torch.device, mesh=None) -> Program:
    """The prefill of ``prompts[seq]`` into fresh caches → the greedy first
    token in ``tok`` (its logits in ``logits``), ``pos`` = seq; over
    ``mesh``'s model group the rank's share."""
    st = step_buffers(model, batch, max_len, device, *_on(mesh))
    prompt = st.prompts[seq] = torch.zeros((st.tok.shape[0], seq),
                                           dtype=torch.long, device=device)
    feed = {"tokens": prompt}
    if st.patches is not None:
        feed["patch_embeds"] = st.patches

    def body():
        st.pick(st.step(batch=feed))
        st.pos.fill_(seq)

    return st.graphs.capture(body)


@functools.lru_cache(maxsize=None)
def encode_step_for(model: Model, batch: int, max_len: int,
                    device: torch.device, mesh=None) -> Program:
    """An enc-dec model's encode of the buffers' ``frames`` into the
    caches' ``enc_out``; over ``mesh``'s model group the rank's share,
    the output whole on every rank. The decode step (:func:`serve_step_for`)
    then reads it: fed the prompt token by token from position 0, its
    first step completes the reference's enc-dec prefill."""
    st = step_buffers(model, batch, max_len, device, *_on(mesh))
    if st.frames is None:
        raise ValueError(f"{model.cfg.name} has no encoder")
    return st.graphs.capture(st.encode)


def generate(model: Model, params, prompt_tokens, max_new: int,
             max_len: int, device="cuda", mesh=None, with_logits=False):
    """Host-loop greedy generation on ``device`` (CUDA unless the caller
    asks for the CPU). ``params`` is one node's flat vector ``[P]``, copied
    into the step buffers, unless it is the very tensor object those
    buffers hold (``step_buffers(model, B, max_len, device[, mesh]).
    params`` itself, tested by identity; a view or an equal copy is
    copied): then nothing is copied, so a model whose weights fit the card
    only once (deepseek-coder-33b's 62.1 GiB in bf16) is initialised there
    and served from it. ``mesh`` (a mesh with ``model`` above 1; every
    rank of the model group calls with the same prompt) serves over its
    model group: ``params`` the node's flat vector, of which the rank
    keeps its compute blocks (the buffer's own ``params`` are those
    blocks). ``prompt_tokens`` [B, S] int. Returns [B, max_new] int32, and
    with ``with_logits`` the logits each token was picked from [B,
    max_new, V]."""
    device = resolve_device(device)
    prompt_tokens = torch.as_tensor(prompt_tokens).to(device=device,
                                                      dtype=torch.long)
    b, s = prompt_tokens.shape
    if s + max_new - 1 > max_len:
        raise ValueError(f"prompt ({s}) + max_new ({max_new}) - 1 exceeds "
                         f"the cache depth max_len={max_len}")
    st = step_buffers(model, b, max_len, device, *_on(mesh))
    # built before the buffers are set: a build's warm-up runs the body
    decode = serve_step_for(model, b, max_len, device, *_on(mesh))
    prefill = (prefill_step_for(model, b, s, max_len, device, *_on(mesh))
               if model.prefill is not None else None)
    if st.rows is not None:
        prompt_tokens = prompt_tokens[st.rows]
    if params is not st.params:
        st.load(params)
    for t in tree_leaves(st.caches):
        t.zero_()
    if prefill is not None:
        st.prompts[s].copy_(prompt_tokens)
        prefill.run()
    else:  # feed the prompt token by token
        for i in range(s):
            st.tok.copy_(prompt_tokens[:, i:i + 1])
            st.pos.fill_(i)
            decode.run()
    out, seen = [st.tok.clone()], [st.logits.clone()] if with_logits else []
    for _ in range(max_new - 1):
        decode.run()
        out.append(st.tok.clone())
        if with_logits:
            seen.append(st.logits.clone())
    tokens = torch.cat(out, dim=1).to(torch.int32)
    return (tokens, torch.stack(seen, dim=1)) if with_logits else tokens
