"""Train-step builders and the LM trainer CLI: port of
``repro.launch.train``.

Standard synchronous training (the centralized baseline) and the swarm
variant, the paper's technique: ``torch.func.vmap`` of the local step over
a leading node axis (gradients never cross node slices), with the gated
sync of a :class:`~repro_torch.core.session.SwarmSession` on the engine
backend between rounds; :func:`make_swarm_sync_step` gives the gossip
backend's propose and commit over a process group.

A node's params are its flat ``[P]`` vector (`repro_torch.models`); a step
differentiates the layout's parts (`repro_torch.core.flat.FlatLayout.
parts`: for a bf16 LM the f32 prefix of its wide leaves and its 16-bit
rest), so ``A_log``, ``D``, ``dt_bias`` and ``lora_scale`` train as f32
numbers, and AdamW's moments run over the values. The forward's prefill
form goes through the flash and SSD kernels' autograd Functions
(`repro_torch.kernels.ops`): their forwards are the hand-written kernels on
a CUDA tensor, their backwards plain PyTorch, and their vmap rules fold the
node axis into the kernels' batch.

:func:`make_train_step` returns a :class:`TrainStep`, a callable class that
a session takes as its train step directly. On a gossip session with inner
specs (`repro_torch.launch.mesh.make_swarm_mesh(n, data=D, model=M)`) it
runs split (:meth:`TrainStep.split`): on the rank's shard of its node, the
batch's rows over the node's data group, each layer gathered just in time
(`repro_torch.models.gather`), the gradient and AdamW on the shard. With
``M`` above 1 the layer's work divides over the node's model group (tensor
parallelism, `repro_torch.sharding.tensor`): a rank gathers only its
compute blocks and computes its share, as the reference's GSPMD places it
(`repro_torch.sharding.rules.placement`), the enc-dec family's encoder
and cross-attention too.
:func:`make_swarm_eval` returns a :class:`SwarmEval`, the session's gate
metric in the same form: on such a session the gate scores each node
through :meth:`SwarmEval.split`, a layer at a time, never the node whole.

    python -m repro_torch.launch.train --arch mamba2-370m --smoke \\
        --swarm-nodes 4 --sync-every 2 --steps 4 --batch 2 --seq 32 \\
        --device cpu

runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import SwarmConfig, TrainConfig
from repro_torch.core.engine import SwarmEngine, gate_decisions, gated_commit
from repro_torch.models import Model
from repro_torch.models.gather import node_norm
from repro_torch.optim import adamw_init, adamw_update_, make_schedule


def tensor_plan(model: Model, mesh):
    """The `repro_torch.sharding.tensor.TensorPlan` of a split step of
    ``model`` on ``mesh``: its model group and placement; None with one
    model rank. What the group does not divide stays whole, as the
    reference's ``logical_shard`` leaves it UNCONSTRAINED: the logits and
    ``lm_head`` where it does not divide the padded vocab (the loss then
    the whole cross entropy, counted once over the group), the SSM's heads
    where a rank's would read their groups unevenly, and the residual of a
    sequence (an enc-dec's frames or tokens each on its own), which the
    forward runs in the whole-residual form. None under the dry run's
    ``dp`` and ``zero3`` profiles (`repro_torch.launch.mesh.use_profile`),
    which place no tensor parallelism."""
    m = mesh.inner.get("model", 1)
    if m <= 1 or model.cfg is None or mesh.profile != "default":
        return None
    from repro_torch.sharding.rules import placement
    from repro_torch.sharding.tensor import TensorPlan
    return TensorPlan(mesh.model_view, placement(model.cfg, m), model.cfg)


class TrainStep:
    """One node's train step: ``(params [P], opt_state, batch[, step]) ->
    (params, opt_state, metrics)``, the params and moments updated in
    place. It takes the engine's fourth ``step`` argument (and ignores it:
    the schedule reads the optimizer's count), so a session takes it as
    its ``train_step_fn`` directly.

    With ``tc.accum_steps`` = A > 1 the batch is cut into A microbatches of
    B/A rows whose f32 gradients are summed (each divided by A), as the
    reference's ``lax.scan`` does; live activation memory scales with B/A.
    ``tc.remat=True`` checkpoints every block (`Model.loss_fn`): the
    backward recomputes each block's activations from its input. The
    clipping norm's squares are summed in f64 (`repro_torch.models.gather.
    node_norm`), so a shard's step (:meth:`split`) reaches the same norm.

    On an inner-sharded gossip mesh a session runs :meth:`split` instead:
    the step on the rank's shard of the node, each layer gathered just in
    time, the batch's rows over the node's data group."""

    def __init__(self, model: Model, tc: TrainConfig):
        self.model = model
        self.tc = tc
        self.schedule = make_schedule(tc)

    def _grads(self, grads_of, batch):
        """(grads, loss, metrics) of ``grads_of(microbatch) -> (grads,
        (loss, metrics))`` over the batch, accumulated over
        ``tc.accum_steps`` microbatches."""
        a = self.tc.accum_steps
        if a <= 1:
            grads, (l, metrics) = grads_of(batch)
            return grads, l, metrics
        grads, l = None, 0.0
        for i in range(a):
            mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            g, (li, _) = grads_of(mb)
            g = tuple(t.to(torch.float32) / a for t in g)
            grads = g if grads is None else tuple(
                x + y for x, y in zip(grads, g))
            l = l + li / a
        return grads, l, {"xent": l, "aux": torch.zeros_like(l)}

    def __call__(self, params, opt_state, batch, step=None):
        model, tc = self.model, self.tc
        layout = model.layout
        parts = layout.parts(params)

        def grads_of(mb):
            """(grads of ``parts``, (loss, metrics)). A vjp whose backward
            neither keeps nor records its graph: ``torch.func.grad``
            records the backward for a higher derivative
            (``create_graph``), which holds every intermediate gradient
            until the step ends (about 9x the activations of plain
            autograd, measured on the CPU at Mamba2-370M's width)."""
            loss, vjp_fn, metrics = torch.func.vjp(
                lambda p: model.loss_fn(layout.unflatten_parts(p), mb,
                                        remat=tc.remat), parts, has_aux=True)
            (grads,) = vjp_fn(torch.ones_like(loss), retain_graph=False,
                              create_graph=False)
            return grads, (loss, metrics)

        grads, l, metrics = self._grads(grads_of, batch)
        lr = self.schedule(opt_state["count"])
        # the parts are views of ``params``: the update writes the slot
        # buffer and the moments in place (the reference donates them)
        _, opt_state = adamw_update_(
            parts, grads, opt_state, tc, lr,
            norm=node_norm(grads) if tc.grad_clip > 0 else None)
        return params, opt_state, dict(metrics, loss=l, lr=lr)

    def split(self, params, opt_state, batch, step=None, *, shard, mesh):
        """The step on this rank's shard of one node: ``params`` its shard
        ``[P_local]`` (``shard``: the :class:`~repro_torch.core.flat.
        ShardLayout`), ``opt_state`` its AdamW moments over the shard's
        values, ``batch`` the node's whole batch ``[B, ...]``, ``mesh`` the
        inner-sharded `repro_torch.launch.mesh.SwarmMesh`.

        The rank takes its ``B / D`` rows over the node's ``D`` data ranks
        (the reference's ``batch → data``); rows that ``D · accum_steps``
        does not divide stay whole on every data rank, as the reference's
        batch falls back to replicated. The loss runs under the data group
        (`repro_torch.sharding.batch`) with each layer gathered from the
        shard group (`repro_torch.models.gather`, inside the checkpoint
        with ``remat``), the shard's gradient comes back summed over the
        data group, and AdamW updates the shard in place with the whole
        node's clipping norm. The metrics are the node's (the loss averaged
        over the data group), alike on every rank of the node. With one
        data rank and one model rank the step is the whole node's, bit for
        bit. With ``M`` model ranks (:func:`tensor_plan`) each layer's work
        divides over the model group: the same function, summed in
        another order.

        Under the dry run's ``dp`` and ``zero3`` profiles (`repro_torch.
        launch.mesh.use_profile`: ``shard`` then the profile's, `repro_
        torch.launch.specs.shard_layout`) no work divides over the model
        group: the rows divide over the batch group (the node's every
        rank) where it divides them, else over the axes the profile's
        input divides them over (`repro_torch.launch.specs.batch_cut`:
        ``model`` under ``dp``, ``data`` under ``zero3``), else stay whole;
        each layer is gathered whole from the store group, and the
        gradient, summed over the batch group (``dp``: onto the data
        group's blocks, then over the model group that repeats them) and
        divided by its size, comes back onto the shard."""
        from repro_torch.models.gather import NodeSplit
        from repro_torch.sharding.batch import batch_group

        model, tc = self.model, self.tc
        if mesh.profile != "default":
            batch, plan = self._profile_rows(batch, shard, mesh, params)
            d_size = plan.data_view.world_size
        else:
            d_size = mesh.inner.get("data", 1)
            b = next(iter(batch.values())).shape[0]
            rows = d_size > 1 and b % (d_size * tc.accum_steps) == 0
            if rows:
                n, d = b // d_size, mesh.coords["data"]
                batch = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
            tp = tensor_plan(model, mesh)
            plan = NodeSplit(shard, mesh.shard_view,
                             mesh.data_view if rows else None,
                             dtype=params.dtype, device=params.device,
                             tensor=tp)
        local = shard.local
        parts = local.parts(params)
        leaves = tuple(p.detach().requires_grad_() for p in parts)

        def grads_of(mb):
            with batch_group(plan.data_view):
                loss, metrics = model.loss_fn(local.unflatten_parts(leaves),
                                              mb, remat=tc.remat, split=plan)
                grads = torch.autograd.grad(loss, leaves)
            return grads, (loss.detach(),
                           {k: v.detach() for k, v in metrics.items()})

        grads, l, metrics = self._grads(grads_of, batch)
        lr = self.schedule(opt_state["count"])
        _, opt_state = adamw_update_(
            parts, grads, opt_state, tc, lr,
            norm=plan.grad_norm(grads) if tc.grad_clip > 0 else None)
        metrics = dict(metrics, loss=l)
        if plan.data_view is not None:
            from repro_torch.core import gossip
            keys = sorted(metrics)
            mean = gossip.all_reduce(
                plan.data_view, torch.stack([metrics[k] for k in keys]),
                kind="step_control") / d_size
            metrics = dict(zip(keys, mean.unbind(0)))
        return params, opt_state, dict(metrics, lr=lr)

    def _profile_rows(self, batch, shard, mesh, params):
        """The rank's rows of the node's batch under ``mesh.profile`` and
        the :class:`~repro_torch.models.gather.NodeSplit` of the step (see
        :meth:`split`)."""
        from repro_torch.launch import specs
        from repro_torch.models.gather import NodeSplit
        view = mesh.batch_view
        b = next(iter(batch.values())).shape[0]
        a = self.tc.accum_steps
        if b % (view.world_size * a) == 0:
            n, i = b // view.world_size, view.rank
        else:
            n, i = b, 0
            for ax in specs.batch_cut(b, mesh.inner, mesh.profile) or ():
                n //= mesh.inner[ax]
                i = i * mesh.inner[ax] + mesh.coords[ax]
            if n % a:
                n, i = b, 0
        batch = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        # the gradient reduces over the store group: every axis the
        # profile's shard layout cuts over (dp: data; zero3: both)
        plan = NodeSplit(shard, mesh.store_view, view, dtype=params.dtype,
                         device=params.device, reduce_view=mesh.store_view,
                         replica_view=mesh.replica_view,
                         reduce_axes=tuple(shard.sizes))
        return batch, plan


def make_train_step(model: Model, tc: TrainConfig) -> TrainStep:
    """One node's :class:`TrainStep`: ``(params [P], opt_state, batch[,
    step]) -> (params, opt_state, metrics)``, and its :meth:`TrainStep.
    split` on a rank's shard (a gossip session with inner specs runs it)."""
    return TrainStep(model, tc)


class SwarmEval:
    """The swarm gate's metric, ``1 / (1 + loss)`` of each node's params
    on its validation rows: ``(stacked [N, P], val) -> [N]`` (vmapped over
    the nodes). A session takes it as its ``eval_fn`` directly; on a
    gossip session with inner specs it scores through :meth:`split`."""

    def __init__(self, model: Model):
        self.model = model
        layout = model.layout
        self._veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
            layout.unflatten(p), v, remat=False)[0]))

    def __call__(self, stacked, val):
        return self._veval(stacked, val)

    def split(self, params, val, *, shard, mesh):
        """One node's metric from this rank's shard ``params`` [P_local]
        (``shard`` its :class:`~repro_torch.core.flat.ShardLayout`, ``mesh``
        the inner-sharded `repro_torch.launch.mesh.SwarmMesh`) and the
        node's whole validation rows ``val``: the forward of
        :meth:`TrainStep.split` without autograd, each layer gathered over
        the shard group just before its block (``gate_gather`` bytes;
        the unscanned unit and at most two layers whole at once), the
        rows whole on every rank. The same bytes through the same ops as
        the whole node's: every rank of the node reaches the node's
        metric. With ``M`` model ranks each layer's work divides over the
        model group as in :meth:`TrainStep.split` (the metric then within
        rounding of the whole node's)."""
        from repro_torch.models.gather import NodeSplit

        tp = tensor_plan(self.model, mesh)
        plan = NodeSplit(shard, mesh.store_view or mesh.shard_view, None,
                         dtype=params.dtype, device=params.device,
                         kind="gate_gather", tensor=tp)
        with torch.no_grad():
            loss, _ = self.model.loss_fn(shard.local.unflatten(params), val,
                                         remat=False, split=plan)
        return 1.0 / (1.0 + loss)


def make_swarm_eval(model: Model) -> SwarmEval:
    """The gate's :class:`SwarmEval` of ``model``: ``(stacked [N, P], val)
    -> [N]``, and :meth:`SwarmEval.split` on a rank's shard (a gossip
    session with inner specs scores through it)."""
    return SwarmEval(model)


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, batch):
        loss, metrics = model.loss_fn(model.layout.unflatten(params), batch,
                                      remat=False)
        return dict(metrics, loss=loss)

    return eval_step


def init_train_state(model: Model, generator: torch.Generator,
                     device="cuda"):
    """One node's params ``[P]`` and AdamW state (moments over values)."""
    params = model.init(generator, device)
    return params, adamw_init(model.layout.parts(params))


# ---------------------------------------------------------------------------
# swarm-parallel: the paper's technique on one device
# ---------------------------------------------------------------------------

def make_swarm_train_step(model: Model, tc: TrainConfig) -> Callable:
    """vmapped local step (of the :class:`TrainStep`): stacked (params
    [N, P], opt_state) with a leading node axis, batch [N, local_B, ...].
    Gradients stay within each node."""
    return torch.func.vmap(make_train_step(model, tc), in_dims=(0, 0, 0))


def make_swarm_sync_step(swarm_cfg: SwarmConfig, mesh, axis: str,
                         data_sizes, param_specs=None, layout=None):
    """Gossip sync: ``(propose, commit)`` over the engine's gossip backend
    on ``mesh`` (`repro_torch.launch.mesh.make_swarm_mesh`), each on this
    rank's rows.

    ``propose(stacked_params [per, P], active=None, fishers=None,
    stats=None) -> candidate [per, P]``: the collective merge of the
    schedule the cost model picks (ring neighbours for a ring of one node a
    rank, all_reduce for full fedavg, all_gather with the runtime mask for
    dynamic). ``commit(candidate, local_params, metric_merged,
    metric_local) -> params``: the validation-gated select on the rank's
    [per] metrics.

    With ``param_specs`` that name the mesh's ``data`` / ``model`` axes
    (`repro_torch.sharding.rules.param_specs`; ``layout`` required) both
    take and return the rank's shard rows ``[per, P_local]`` of
    ``ShardLayout(layout, param_specs, mesh.inner, mesh.coords)``
    (`repro_torch.core.flat`: its ``shard`` cuts a node's rows), and the
    cost model leaves the q8 psums out, as the reference's does."""
    engine = SwarmEngine(swarm_cfg, None, None, data_sizes=data_sizes,
                         layout=layout, backend="gossip", mesh=mesh,
                         axis=axis, param_specs=param_specs)

    def propose(stacked_params, active=None, fishers=None, stats=None):
        candidate, _, _ = engine.propose(stacked_params, active=active,
                                         fishers=fishers, stats=stats)
        return candidate

    def commit(candidate, local_params, metric_merged, metric_local):
        gates = gate_decisions(metric_merged, metric_local,
                               swarm_cfg.val_threshold)
        return gated_commit(candidate, local_params, gates)

    return propose, commit


# ---------------------------------------------------------------------------
# CLI launcher:  python -m repro_torch.launch.train --arch minicpm-2b ...
# ---------------------------------------------------------------------------

def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="P2P-SL trainer")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--swarm-nodes", type=int, default=0,
                    help="0 = plain training; N = P2P-SL with N nodes")
    ap.add_argument("--sync-every", type=int, default=10)
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "full", "dynamic"])
    ap.add_argument("--merge", default="fedavg",
                    choices=["mean", "fedavg", "fisher", "gradmatch"])
    ap.add_argument("--lora", action="store_true",
                    help="LoRA-adapter-only peer payloads (paper §3.2)")
    ap.add_argument("--wire-dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="sync wire compression (core.comms): int8 = "
                         "error-feedback quantized deltas")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", default="",
                    help="resume a swarm run from a session checkpoint "
                         "(session.msgpack written by --ckpt-dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """``python -m repro_torch.launch.train``: :func:`run` on the parsed
    command line."""
    run(parse_args(argv))
    return 0


def run(args) -> dict:
    """The trainer of :func:`main` on parsed arguments. Returns what a
    caller measuring it needs: ``steps`` (the final step), ``walls``
    (``(step, seconds since the start)`` after every step of plain
    training or every round or remainder block of a swarm, the card
    synchronized), ``sync_log``, and ``model`` with either ``params`` /
    ``opt_state`` / ``step_fn`` (plain) or ``session`` (swarm)."""
    import time

    from repro_torch import resolve_device
    from repro_torch.checkpointing import save_json, save_pytree
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.core.session import SwarmSession
    from repro_torch.data import make_lm_stream
    from repro_torch.models import build_model
    from repro_torch.optim import EarlyStopper

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if cfg.is_encdec or cfg.family == "vlm":
        raise SystemExit("CLI LM trainer supports decoder-only families; "
                         "use examples/ for vlm/audio drivers")
    model = build_model(cfg)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     max_steps=args.steps, remat=False)
    base_step = make_train_step(model, tc)
    n_nodes = max(args.swarm_nodes, 1)
    streams = [make_lm_stream(256, args.seq, cfg.vocab_size,
                              seed=args.seed + i, topic_bias=1.0)
               for i in range(n_nodes)]
    stopper = EarlyStopper(patience=5, mode="min")
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    final_step, sync_log, walls = 0, [], []
    result = {"model": model}

    def mark(step):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls.append((step, time.time() - t0))

    def rate(steps):
        """s/step since the start, and training tokens/s on the card."""
        wall = time.time() - t0
        line = f"{wall / steps:.2f}s/step"
        if device.type == "cuda":
            line += (f", {steps * args.batch * args.seq * n_nodes / wall:.0f}"
                     " tokens/s")
        return line

    def to_device(arrays):
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    if not args.swarm_nodes:  # plain single-learner training
        p, o = init_train_state(model, _generator(args.seed, device), device)
        s = streams[0]
        for step in range(args.steps):
            idx = rng.integers(0, len(s["tokens"]), args.batch)
            p, o, m = base_step(p, o, to_device({k: v[idx]
                                                 for k, v in s.items()}))
            final_step = step + 1
            mark(final_step)
            if step % 20 == 0 or step == args.steps - 1:
                loss = float(m["loss"])
                print(f"step {final_step:4d} loss={loss:.3f} "
                      f"({rate(final_step)})", flush=True)
                if stopper.update(loss):
                    print("early stop (patience exhausted)")
                    break
        node_params = [lm_params_to_reference(model.layout, p)]
        result.update(params=p, opt_state=o, step_fn=base_step)
    else:  # P2P-SL: one SwarmSession over the stacked node axis
        smodel = build_model(cfg, lora_rank=8) if args.lora else model
        layout = smodel.layout
        train_step = make_train_step(smodel, tc)
        # every node starts from the same base; with --lora each injects
        # its own adapters, as the reference's nodes do
        ps = [smodel.init(_generator(args.seed, device), device,
                          adapter_generator=_generator(args.seed + 1 + i,
                                                       device))
              for i in range(n_nodes)]

        eval_fn = make_swarm_eval(smodel)
        scfg = SwarmConfig(n_nodes=n_nodes, sync_every=args.sync_every,
                           topology=args.topology, merge=args.merge,
                           lora_only=args.lora, wire_dtype=args.wire_dtype)
        # fisher/gradmatch importance accumulators live inside the session's
        # SwarmState: estimation is on the device, no host-side Fisher loop
        sess = SwarmSession(scfg, train_step, eval_fn, params=ps,
                            opt_state=adamw_init(layout.parts(ps[0])),
                            seed=args.seed, layout=layout, device=device,
                            data_sizes=[len(s["tokens"]) for s in streams])
        del ps
        print(f"sync schedule: "
              f"{sess.sync_schedule.describe(sess.payload_params)}")
        if args.resume:
            sess.load(args.resume)
            final_step = int(sess.state.step)
            print(f"resumed from {args.resume} at step {final_step} "
                  f"(round {int(sess.state.round)})")
        vals = to_device({k: np.stack([s[k][:8] for s in streams])
                          for k in streams[0]})

        def draw(count):  # [count, N, B, S] stacked batch block
            # one index draw per node, shared by every key: tokens and
            # labels rows are paired within a sequence
            idx = [rng.integers(0, len(s["tokens"]), (count, args.batch))
                   for s in streams]
            return to_device({k: np.stack([s[k][i] for s, i
                                           in zip(streams, idx)], axis=1)
                              for k in streams[0]})

        last_check = 0  # keep the plain loop's every-20-steps stopper cadence
        while final_step < args.steps:
            t = min(max(args.sync_every, 1), args.steps - final_step)
            block = draw(t)
            if t == args.sync_every:  # full round: local steps + gated sync
                out = sess.round(block, vals)
                losses = out["train"]["loss"][-1].cpu().numpy()
                gates = out["gates"].cpu().numpy().astype(bool).tolist()
                sync_log.append({
                    "step": final_step + t, "gates": gates,
                    "metric_local": out["metric_local"].cpu().tolist(),
                    "metric_merged": out["metric_merged"].cpu().tolist()})
                extra = f" sync gates={gates}"
            else:  # remainder steps, no sync
                tm = sess.run_local(block)
                losses = tm["loss"][-1].cpu().numpy()
                extra = ""
            final_step += t
            mark(final_step)
            print(f"step {final_step:4d} loss={['%.3f' % l for l in losses]} "
                  f"({rate(final_step)}){extra}", flush=True)
            if final_step - last_check >= 20 or final_step >= args.steps:
                last_check = final_step
                if stopper.update(float(np.mean(losses))):
                    print("early stop (patience exhausted)")
                    break
        result.update(session=sess, model=smodel)
        if args.ckpt_dir:  # full session state: checkpoint/resume round-trip
            node_params = sess.node_params
            sess.save(f"{args.ckpt_dir}/session.msgpack")

    if args.ckpt_dir:
        for i, p in enumerate(node_params):
            save_pytree(f"{args.ckpt_dir}/node{i}.msgpack", p,
                        metadata={"arch": cfg.name, "step": final_step})
        save_json(f"{args.ckpt_dir}/sync_log.json", sync_log)
        print(f"checkpoints -> {args.ckpt_dir}")
    return dict(result, steps=final_step, walls=walls, sync_log=sync_log)


if __name__ == "__main__":
    main()
