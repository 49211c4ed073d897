"""Continuous-batching consensus engine: port of ``repro.serve.engine``.

* **Slot model.** The engine owns a table of up to ``max_slots`` decode
  slots. Each live slot is one in-flight request: a lane in the stacked
  cache, a position counter and a pinned param version. ``step()`` is one
  scheduler tick: admit pending requests into free slots (one bucketed
  prefill each), then advance every live slot one token with one batched
  decode.
* **One captured program per dispatch key.** The keys are the reference's
  ``trace_counts`` keys: ``("decode", batch bucket)`` and ``("prefill",
  seq bucket, batch bucket)``. A key's program covers all N nodes and the
  ensemble aggregation, and reads every per-dispatch value from static
  device buffers: the host stages tokens, positions, the commit mask, the
  node mask, the padded prompt, the slot and the prompt length in one
  pinned int64 row, copies the span a dispatch reads to the card, replays,
  and reads the aggregated tokens back (the one sync per dispatch the
  scheduler needs). On CUDA a program is a CUDA graph
  (`repro_torch.launch.capture`), on the CPU its body called directly.
* **Builds.** ``trace_counts[key]`` counts builds of a key's program. A
  build captures one graph per physical param buffer of the
  :class:`~repro_torch.serve.hot_swap.HotSwapSlot`'s pool (programs are
  keyed by ``(key, buffer index)`` in ``programs``), each after one eager
  warm-up pass; on the card that is about two eager passes of the body
  and two captures, seconds at full width (``build_seconds``). Steady
  serving, a hot swap into a free buffer and ``fail_node`` /
  ``restore_node`` (the node mask is data) build nothing; a swap during a
  swap, which grows the pool, builds each key again on its next dispatch
  on the new buffer.
* **The ensemble.** The N per-node variants are the swarm state's
  ``[N, P]`` tensor (in the model's param dtype) and the model's
  :class:`~repro_torch.core.flat.FlatLayout`. The reference double-vmaps
  its decode over nodes and slots; the port's kernels take device
  pointers, which a ``vmap``'d tensor cannot give, so a program loops over
  the N nodes and folds the slots into the batch: each node's decode
  serves every slot in one call with a per-row position vector (RoPE, the
  mask and the cache write take per-lane positions), and
  :func:`aggregate_logits` chooses the token every node continues with.
* **Caches** are the model's per-layer dicts with leaves ``[N, slots,
  ...]``, allocated and zeroed once at the batch bucket ``max_slots``
  needs; bucket b's programs read the view ``[:, :b]``, so growing or
  shrinking the bucket moves no storage. A decode writes only the lanes its
  commit mask marks (the reference's masked commit; the others, live lanes
  of another version included, are computed and discarded). A prefill runs
  each node on a fresh one-lane scratch cache and copies the lane into the
  table at the slot's device index (``index_copy_``, the reference's
  ``dynamic_update_index_in_dim``), so one program serves every slot and
  prompt length of its key.
* **Hot swap.** Params live in a :class:`~repro_torch.serve.hot_swap.
  HotSwapSlot`. Each request decodes under the version it was admitted
  with; during a transition a tick issues one decode per live version
  (the program of that version's buffer), and superseded versions are
  retired once their last request drains.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.launch.capture import Program, ProgramPool
from repro_torch.launch.serve import make_logits_step, tree_leaves, tree_map
from repro_torch.models import Model
from repro_torch.serve.batcher import BucketPolicy
from repro_torch.serve.hot_swap import HotSwapSlot
from repro_torch.serve.queue import Request, RequestQueue

AGG_MODES = ("consensus", "average", "per_node", "topk")


def aggregate_logits(logits, mode: str, top_k: int = 2, node_mask=None):
    """Ensemble aggregation: per-node logits [N, B, V] -> the next token
    each node continues with, [N, B] int32.

    consensus
        Majority vote over per-node argmaxes; ties break toward the
        candidate with the highest mean probability (the fractional
        tie-break term is < 1 vote, so a strict majority always wins).
    average
        Argmax of the mean per-node softmax.
    topk
        Like ``average``, but only the ``top_k`` most confident nodes
        (highest max-probability) vote in each slot.
    per_node
        No aggregation: every node decodes its own stream.

    ``node_mask`` ([N] bool, optional) drops crashed lanes from the
    aggregate: masked nodes cast no vote, contribute no probability mass,
    and can never be selected by ``topk``. ``None`` is the unmasked math.
    """
    n, b, v = logits.shape
    if mode == "per_node":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)                         # [N, B, V]

    def topk_probs(conf):
        idx = torch.topk(conf.T, top_k, dim=-1).indices           # [B, k]
        sel = torch.gather(probs.transpose(0, 1), 1,
                           idx[..., None].expand(b, top_k, v))    # [B, k, V]
        return idx, sel

    if node_mask is None:
        if mode == "consensus":
            votes = F.one_hot(torch.argmax(logits, -1), v).to(torch.float32)
            score = votes.sum(0) + probs.mean(0) / (n + 1.0)
            winner = torch.argmax(score, -1)
        elif mode == "average":
            winner = torch.argmax(probs.mean(0), -1)
        elif mode == "topk":
            _, sel = topk_probs(probs.max(-1).values)
            winner = torch.argmax(sel.mean(1), -1)
        else:
            raise ValueError(f"unknown aggregation mode {mode!r}; "
                             f"expected one of {AGG_MODES}")
        return winner[None].expand(n, b).to(torch.int32)
    m = torch.as_tensor(node_mask, device=logits.device).to(probs.dtype)
    n_act = torch.clamp(m.sum(), min=1.0)
    if mode == "consensus":
        votes = (F.one_hot(torch.argmax(logits, -1), v).to(torch.float32)
                 * m[:, None, None])
        pmean = (probs * m[:, None, None]).sum(0) / n_act
        score = votes.sum(0) + pmean / (n_act + 1.0)
        winner = torch.argmax(score, -1)
    elif mode == "average":
        winner = torch.argmax((probs * m[:, None, None]).sum(0) / n_act, -1)
    elif mode == "topk":
        # masked lanes sink below every real confidence, so top_k only
        # surfaces them when fewer than k survivors exist — and then their
        # zero ``valid`` weight still keeps them out of the average
        conf = torch.where(m[:, None] > 0, probs.max(-1).values, -1.0)
        idx, sel = topk_probs(conf)
        valid = m[idx]                                            # [B, k]
        weighted = ((sel * valid[..., None]).sum(1)
                    / torch.clamp(valid.sum(1), min=1.0)[..., None])
        winner = torch.argmax(weighted, -1)
    else:
        raise ValueError(f"unknown aggregation mode {mode!r}; "
                         f"expected one of {AGG_MODES}")
    return winner[None].expand(n, b).to(torch.int32)


# the engine's static int64 inputs, in staging order: a decode reads
# tokens..mask, a prefill mask..prompt
_INPUTS = ("tokens", "pos", "commit", "mask", "slot", "last", "prompt")


class ServeEngine:
    """Continuous-batching ensemble server over stacked per-node params.

    Parameters
    ----------
    model : the (single-node) :class:`~repro_torch.models.Model`; its decode
        takes ``(params, tokens [B,S], caches, cache_pos, commit=None)``
        with ``cache_pos`` an int or a ``[B]`` tensor, and updates the
        caches in place.
    params : the stacked ensemble ``[N, P]`` (``SwarmState.params``'s
        form, in the model's param dtype), or a :class:`HotSwapSlot`
        already wrapping it.
    mode : aggregation mode, one of ``AGG_MODES``.
    max_len : cache depth per slot; prompt_len + max_new must fit.
    max_slots : concurrency ceiling (≤ the largest batch bucket).
    device : where the engine serves; CUDA unless the caller asks for the
        CPU (the params are moved there).
    """

    def __init__(self, model: Model, params, *, mode: str = "consensus",
                 top_k: int = 2, max_len: int = 64, max_slots: int = 8,
                 policy: Optional[BucketPolicy] = None,
                 max_pending: Optional[int] = None,
                 now=time.perf_counter, device="cuda"):
        if mode not in AGG_MODES:
            raise ValueError(f"unknown mode {mode!r}; expected {AGG_MODES}")
        self.model = model
        self.mode = mode
        self.top_k = int(top_k)
        self.max_len = int(max_len)
        self.max_slots = int(max_slots)
        self.policy = policy if policy is not None else BucketPolicy()
        if self.max_slots > self.policy.batch_buckets[-1]:
            raise ValueError(
                f"max_slots={self.max_slots} exceeds the largest batch "
                f"bucket {self.policy.batch_buckets[-1]}")
        device = resolve_device(device)
        if isinstance(params, HotSwapSlot):
            self.slot = params
        else:
            self.slot = HotSwapSlot(params.to(device), layout=model.layout)
        if self.slot.live.device.type != device.type:
            raise ValueError(f"the slot's params are on "
                             f"{self.slot.live.device}, the engine serves "
                             f"on {device}")
        self.device = self.slot.live.device
        self.n_nodes = int(self.slot.live.shape[0])
        self._logits_step = make_logits_step(model)
        self._now = now
        self.queue = RequestQueue(now=now, max_pending=max_pending)
        self.completed: List[Request] = []
        # ensemble-lane health: a crashed node's lane is dropped from every
        # aggregation; per_node mode keeps decoding all lanes
        self._node_mask = np.ones(self.n_nodes, bool)
        # key -> builds of its program; (key, pool index) -> the program
        self.trace_counts = collections.defaultdict(int)
        self.build_seconds = collections.defaultdict(float)
        self.programs: Dict[tuple, Program] = {}
        self._graphs = ProgramPool(self.device)
        self._views: Dict[int, list] = {}   # pool index -> per-node views
        self._init_static()
        self._bucket = self.policy.batch_buckets[0]
        self._pos = np.zeros(self._bucket, np.int32)
        self._live = np.zeros(self._bucket, bool)
        self._pinned = np.zeros(self._bucket, np.int64)
        self._tokens = np.zeros((self.n_nodes, self._bucket), np.int32)
        self._reqs: List[Optional[Request]] = [None] * self._bucket

    # -- static buffers -----------------------------------------------------

    def _init_static(self) -> None:
        """The cache table, the prefill's scratch lane, the staged inputs
        and the outputs: allocated once, read and written by every
        program in place."""
        n, dev = self.n_nodes, self.device
        bmax = self.policy.batch_bucket(self.max_slots)
        self._table = self._init_caches(bmax)
        self._scratch = self.model.init_cache(1, self.max_len, dev)
        sizes = dict(tokens=n * bmax, pos=bmax, commit=bmax, mask=n, slot=1,
                     last=1, prompt=self.policy.seq_buckets[-1])
        pin = dev.type == "cuda"
        total = sum(sizes.values())
        self._host = torch.zeros(total, dtype=torch.int64, pin_memory=pin)
        self._dev = torch.zeros(total, dtype=torch.int64, device=dev)
        host = self._host.numpy()
        self._span, self._in, self._staged = {}, {}, {}
        at = 0
        for name in _INPUTS:
            self._span[name] = (at, at + sizes[name])
            self._in[name] = self._dev[at:at + sizes[name]]
            self._staged[name] = host[at:at + sizes[name]]
            at += sizes[name]
        self._in["tokens"] = self._in["tokens"].view(n, bmax)
        self._staged["tokens"] = self._staged["tokens"].reshape(n, bmax)
        # decode tokens in columns :bmax, a prefill's first tokens in bmax
        self._out = torch.zeros((n, bmax + 1), dtype=torch.int32, device=dev)
        self._host_out = torch.zeros((n, bmax + 1), dtype=torch.int32,
                                     pin_memory=pin)

    def _init_caches(self, b: int):
        """Stacked slot caches, zeroed: leaves [N, b, *single-slot cache
        dims]."""
        one = self.model.init_cache(1, self.max_len, self.device)
        return tree_map(
            lambda leaf: torch.zeros((self.n_nodes, b) + tuple(leaf.shape[1:]),
                                     dtype=leaf.dtype, device=self.device),
            one)

    def _upload(self, first: str, last: str, stop: Optional[int] = None):
        """Copy the staged inputs ``first``..``last`` to the card (``stop``
        cuts the last one short)."""
        a = self._span[first][0]
        z = self._span[last][1] if stop is None else \
            self._span[last][0] + stop
        self._dev[a:z].copy_(self._host[a:z], non_blocking=True)

    def _read(self) -> np.ndarray:
        """The outputs on the host: the dispatch's one sync."""
        self._host_out.copy_(self._out, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._host_out.numpy()

    # -- programs -------------------------------------------------------------

    def _params(self, index: int):
        """Per-node param views of pool buffer ``index``."""
        views = self._views.get(index)
        if views is None:
            buf = self.slot.pool[index]
            views = [self.model.layout.unflatten(buf[i])
                     for i in range(self.n_nodes)]
            self._views[index] = views
        return views

    def _built(self, key, version: int) -> bool:
        return (key, self.slot.index(version)) in self.programs

    def _build(self, key, body_for: Callable) -> None:
        """Build ``key``'s program on every pool buffer that lacks one;
        ``body_for(per-node params)`` makes the body."""
        t0 = time.perf_counter()
        for index in range(len(self.slot.pool)):
            if (key, index) not in self.programs:
                self.programs[key, index] = self._graphs.capture(
                    body_for(self._params(index)))
        self.trace_counts[key] += 1
        self.build_seconds[key] += time.perf_counter() - t0

    def _decode_body(self, b: int, params) -> Callable[[], None]:
        tokens, pos = self._in["tokens"][:, :b], self._in["pos"][:b]
        lanes = [tree_map(lambda t, n=n: t[n, :b], self._table)
                 for n in range(self.n_nodes)]

        def body():
            commit = self._in["commit"][:b] != 0
            logits = []
            for n in range(self.n_nodes):
                lg, _ = self._logits_step(params[n], tokens[n][:, None],
                                          lanes[n], pos, commit=commit)
                logits.append(lg[:, -1])
            nxt = aggregate_logits(torch.stack(logits), self.mode,
                                   self.top_k, node_mask=self._in["mask"])
            self._out[:, :b].copy_(nxt)

        return body

    def _prefill_body(self, s: int, b: int, params) -> Callable[[], None]:
        prompt = self._in["prompt"][:s][None]
        slot, last = self._in["slot"], self._in["last"]
        scratch = tree_leaves(self._scratch)
        lanes = [tree_leaves(tree_map(lambda t, n=n: t[n, :b], self._table))
                 for n in range(self.n_nodes)]

        def body():
            logits = []
            for n in range(self.n_nodes):
                for t in scratch:           # a fresh cache, in place
                    t.zero_()
                lg, _ = self._logits_step(params[n], prompt, self._scratch,
                                          0)
                logits.append(lg[0].index_select(0, last))
                for full, new in zip(lanes[n], scratch):
                    full.index_copy_(0, slot, new)
            first = aggregate_logits(torch.cat(logits)[:, None], self.mode,
                                     self.top_k,
                                     node_mask=self._in["mask"])[:, 0]
            self._out[:, -1].copy_(first)

        return body

    # -- dispatch cores -----------------------------------------------------

    def _stage_decode(self, tokens, pos, commit) -> None:
        b = tokens.shape[1]
        self._staged["tokens"][:, :b] = tokens
        self._staged["pos"][:b] = pos
        self._staged["commit"][:b] = commit
        self._staged["mask"][:] = self._node_mask
        self._upload("tokens", "mask")

    def _stage_prefill(self, prompt, slot: int, length: int) -> None:
        s = prompt.shape[0]
        self._staged["mask"][:] = self._node_mask
        self._staged["slot"][0] = slot
        self._staged["last"][0] = length - 1
        self._staged["prompt"][:s] = prompt
        self._upload("mask", "prompt", stop=s)

    def _decode_commit(self, version, tokens, pos, live) -> np.ndarray:
        """One batched ensemble decode tick: tokens [N,B], pos [B], live
        [B] (host arrays) -> aggregated next tokens [N,B]; only the lanes
        ``live`` marks are written."""
        b = tokens.shape[1]
        key = ("decode", b)
        if not self._built(key, version):
            # the build's warm-up passes commit no lane
            self._stage_decode(tokens, pos, np.zeros(b, bool))
            self._build(key, lambda params: self._decode_body(b, params))
        self._stage_decode(tokens, pos, live)
        self.programs[key, self.slot.index(version)].run()
        return self._read()[:, :b].copy()

    def _prefill_commit(self, version, prompt, slot: int,
                        length: int) -> np.ndarray:
        """Ensemble prefill of ONE slot: padded prompt [S] -> per-node first
        tokens [N]; the slot's cache lane is replaced in place."""
        s, b = prompt.shape[0], self._bucket
        key = ("prefill", s, b)
        self._stage_prefill(prompt, slot, length)
        if not self._built(key, version):
            # the build's warm-up passes write only this (free) lane, which
            # the dispatch then replaces
            self._build(key, lambda params: self._prefill_body(s, b, params))
        self.programs[key, self.slot.index(version)].run()
        return self._read()[:, -1].copy()

    # -- slot-table plumbing ------------------------------------------------

    def _grow(self, nb: int) -> None:
        pad = nb - self._bucket
        self._pos = np.concatenate([self._pos, np.zeros(pad, np.int32)])
        self._live = np.concatenate([self._live, np.zeros(pad, bool)])
        self._pinned = np.concatenate([self._pinned, np.zeros(pad, np.int64)])
        self._tokens = np.concatenate(
            [self._tokens, np.zeros((self.n_nodes, pad), np.int32)], axis=1)
        self._reqs.extend([None] * pad)
        self._bucket = nb

    def _maybe_shrink(self) -> None:
        b0 = self.policy.batch_buckets[0]
        if self._bucket == b0 or self._live.any() or len(self.queue):
            return
        self._pos = self._pos[:b0].copy()
        self._live = self._live[:b0].copy()
        self._pinned = self._pinned[:b0].copy()
        self._tokens = self._tokens[:, :b0].copy()
        self._reqs = self._reqs[:b0]
        self._bucket = b0
    # -- public API ---------------------------------------------------------

    @property
    def live_count(self) -> int:
        return int(self._live.sum())

    @property
    def total_traces(self) -> int:
        return sum(self.trace_counts.values())

    @property
    def node_mask(self) -> np.ndarray:
        return self._node_mask.copy()

    def fail_node(self, node: int) -> None:
        """Drop one ensemble lane from every aggregation, effective the very
        next dispatch — in-flight requests keep decoding, their consensus
        re-forms over the surviving lanes."""
        mask = self._node_mask.copy()
        mask[node] = False
        self.set_node_mask(mask)

    def restore_node(self, node: int) -> None:
        """Re-admit a recovered lane to the aggregate."""
        mask = self._node_mask.copy()
        mask[node] = True
        self.set_node_mask(mask)

    def set_node_mask(self, mask) -> None:
        mask = np.asarray(mask, bool).reshape(-1)
        if mask.shape[0] != self.n_nodes:
            raise ValueError(f"node mask has {mask.shape[0]} entries, the "
                             f"ensemble has {self.n_nodes} nodes")
        if not mask.any():
            raise ValueError("cannot fail every ensemble lane: at least one "
                             "node must survive to serve")
        self._node_mask = mask

    def submit(self, prompt, max_new: int,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue a request. ``deadline_s`` is a wall-clock budget from
        submission; a bounded queue (``max_pending``) may return the request
        already terminal ``rejected``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.policy.seq_bucket(prompt.size)   # must fit a bucket
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds the "
                f"cache depth max_len={self.max_len}")
        req = self.queue.submit(prompt, max_new, deadline_s=deadline_s)
        if req.status == "rejected":
            self.completed.append(req)
        return req

    def swap(self, params: torch.Tensor) -> int:
        """Publish a new stacked ensemble; in-flight requests finish on the
        version they were admitted with."""
        return self.slot.publish(params.to(self.device))

    def ingest_checkpoint(self, path: str) -> int:
        """Hot-swap in the params of a ``SwarmSession.save`` checkpoint."""
        return self.slot.ingest(path, expect_nodes=self.n_nodes)

    def step(self) -> List[Request]:
        """One scheduler tick: expire -> admit -> decode -> harvest. Returns
        the requests that reached a terminal state this tick."""
        done: List[Request] = []
        done.extend(self.queue.expire())
        self._expire_live(done)
        self._admit(done)
        if self._live.any():
            self._decode_tick(done)
        self.slot.retire(self._pinned[self._live].tolist())
        self._maybe_shrink()
        self.completed.extend(done)
        return done

    def drain(self, max_ticks: int = 100_000) -> List[Request]:
        """Tick until the queue and all slots are empty; raises
        ``TimeoutError`` naming the stuck work if the budget runs out."""
        done: List[Request] = []
        while len(self.queue) or self._live.any():
            if max_ticks <= 0:
                stuck = [(int(s), self._reqs[s].rid)
                         for s in np.flatnonzero(self._live)]
                queued = [r.rid for r in self.queue.pending]
                raise TimeoutError(
                    f"drain did not converge: live slots (slot, rid) "
                    f"{stuck}, queued rids {queued}")
            max_ticks -= 1
            done.extend(self.step())
        return done

    # -- scheduler ----------------------------------------------------------

    def _admit(self, done: List[Request]) -> None:
        while len(self.queue):
            if self.live_count >= self.max_slots:
                break
            free = np.flatnonzero(~self._live)
            if free.size == 0:
                self._grow(self.policy.batch_bucket(self.live_count + 1))
                free = np.flatnonzero(~self._live)
            self._start(self.queue.pop(), int(free[0]), done)

    def _start(self, req: Request, slot: int, done: List[Request]) -> None:
        padded, length = self.policy.pad_prompt(req.prompt)
        version = self.slot.version
        first = self._prefill_commit(version, padded, slot, length)
        req.param_version = version
        req.admit_t = self._now()
        req.status = "live"
        req.node_tokens.append(first)
        self._reqs[slot] = req
        self._live[slot] = True
        self._pinned[slot] = version
        self._pos[slot] = length
        self._tokens[:, slot] = first
        if req.max_new == 1:
            done.append(self._finish(slot))

    def _decode_tick(self, done: List[Request]) -> None:
        # one dispatch per live param version (≥ 2 only mid-hot-swap);
        # non-matching lanes are masked out of the cache commit and their
        # host state is left untouched
        for version in sorted(set(self._pinned[self._live].tolist())):
            mask = self._live & (self._pinned == version)
            nxt = self._decode_commit(version, self._tokens, self._pos, mask)
            for slot in np.flatnonzero(mask):
                req = self._reqs[slot]
                req.node_tokens.append(nxt[:, slot].copy())
                self._tokens[:, slot] = nxt[:, slot]
                self._pos[slot] += 1
                if len(req.node_tokens) >= req.max_new:
                    done.append(self._finish(int(slot)))

    def _expire_live(self, done: List[Request]) -> None:
        """Finish live slots whose wall-clock deadline elapsed."""
        now = self._now()
        for slot in np.flatnonzero(self._live):
            req = self._reqs[slot]
            if (req.deadline_s is not None
                    and now - req.submit_t >= req.deadline_s):
                done.append(self._finish(int(slot),
                                         status="deadline_exceeded"))

    def _finish(self, slot: int, status: str = "done") -> Request:
        req = self._reqs[slot]
        req.finish_t = self._now()
        req.status = status
        self._live[slot] = False
        self._reqs[slot] = None
        return req
