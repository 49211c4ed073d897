"""The paper's experimental protocol (§4), end to end on the port.

Port of ``repro.experiments.histo``: the 4-node P2P-SL swarm over synthetic
histopathology shards against a centralized "full-data" baseline and
standalone per-node models, under the unbalanced 10/30/30/30 split,
reporting AUC / sensitivity / specificity / F1 / Davies-Bouldin on a shared
held-out test set. Same data, same batch stream and same protocol as the
reference; every commit of the swarm runs through the fused CUDA kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SwarmConfig, TrainConfig
from repro_torch.core.flat import FlatLayout
from repro_torch.core.session import SwarmSession
from repro_torch.data import (augment, batches, make_histo_dataset,
                              paper_splits, shard_to_nodes)
from repro_torch.metrics import classify_report, davies_bouldin, gate_metric_fn
from repro_torch.models.cnn import (HistoCNN, bce_loss, forward_cnn, init_cnn,
                                    one_hot)
from repro_torch.optim import adamw_init, adamw_update_, make_schedule


@dataclass
class HistoExperimentConfig:
    n_train: int = 2000
    n_test: int = 500
    image_size: int = 24
    noise: float = 1.1               # tuned so AUCs land in the paper's band
    class_probs: tuple = (0.5, 0.3, 0.2)  # imbalanced classes (minority = 2)
    fractions: tuple = (0.10, 0.30, 0.30, 0.30)
    scarcity: Optional[Dict[int, float]] = None  # e.g. {2: 0.25} / {3: 0.05}
    steps: int = 240
    batch_size: int = 16
    lr: float = 1e-3
    sync_every: int = 20             # ≈ paper's every-3-epochs cadence
    val_frac: float = 0.25
    seed: int = 0
    swarm: SwarmConfig = field(default_factory=lambda: SwarmConfig(
        n_nodes=4, sync_every=20, topology="full", merge="fedavg",
        lora_only=False, val_threshold=0.8, gate_metric="auc"))
    # small CNN (paper arch scaled to 24px inputs for CPU)
    growth: int = 8
    stem: int = 16
    feat_dim: int = 96
    hidden: int = 32
    n_blocks: int = 4
    layers_per_block: int = 4


def _model(ecfg) -> HistoCNN:
    return HistoCNN(growth=ecfg.growth, stem=ecfg.stem, feat_dim=ecfg.feat_dim,
                    hidden=ecfg.hidden, n_blocks=ecfg.n_blocks,
                    layers_per_block=ecfg.layers_per_block)


def _make_model_fns(ecfg: HistoExperimentConfig, model: HistoCNN,
                    layout: FlatLayout):
    """Per-node train step and predictions over flat ``[P]`` params."""
    tc = TrainConfig(lr=ecfg.lr, warmup_steps=20, max_steps=ecfg.steps,
                     weight_decay=1e-4, schedule="cosine")
    sched = make_schedule(tc)

    def loss(flat, x, y):
        return bce_loss(forward_cnn(model, layout.unflatten(flat), x),
                        one_hot(y, 3))

    def train_step(params, opt_state, batch, step):
        x, y = batch
        g, l = torch.func.grad_and_value(loss)(params, x, y)
        params, opt_state = adamw_update_(params, g, opt_state, tc,
                                          sched(opt_state["count"]))
        return params, opt_state, {"loss": l}

    @torch.no_grad()
    def predict(params, x):
        logits, feats = forward_cnn(model, layout.unflatten(params), x,
                                    return_features=True)
        return torch.sigmoid(logits), feats

    return train_step, predict


def _make_eval_fn(cfg: SwarmConfig, model: HistoCNN, layout: FlatLayout):
    """Stacked gate metric: ``(params [N, P], (x, y, mask)) -> [N]``. BN
    statistics include the zero-padded validation rows, as in the
    reference's vmapped eval."""
    metric = gate_metric_fn(cfg.gate_metric)

    def logits_one(flat, x):
        return forward_cnn(model, layout.unflatten(flat), x)

    vlogits = torch.func.vmap(logits_one)

    def eval_fn(params, val):
        x, y, m = val
        return metric(torch.sigmoid(vlogits(params, x)), y, m)

    return eval_fn


def _init_params(ecfg, model: HistoCNN) -> Dict[str, torch.Tensor]:
    """Shared init of every node (the warm-start effect): {path: tensor}."""
    gen = torch.Generator().manual_seed(ecfg.seed + 42)
    return init_cnn(gen, model)


def _batch_stream(ecfg, trains):
    """Precompute the per-node minibatch stream as stacked arrays.

    Returns (xs [steps, N, B, H, W, C], ys [steps, N, B]) — the reference's
    stream, draw for draw: nodes that can serve a full batch walk their own
    epoch iterators; a node with fewer than B samples draws B samples with
    replacement per step.
    """
    n = len(trains)
    bs = min(ecfg.batch_size, max(len(y) for _, y in trains))
    rngs = [np.random.default_rng(ecfg.seed * 100 + i) for i in range(n)]
    iters = [iter(()) for _ in range(n)]
    h = trains[0][0].shape[1]
    xs = np.empty((ecfg.steps, n, bs, h, h, 3), np.float32)
    ys = np.empty((ecfg.steps, n, bs), np.int32)
    for s in range(ecfg.steps):
        for i, (x, y) in enumerate(trains):
            if len(y) < bs:  # tiny shard: resample with replacement
                idx = rngs[i].integers(0, len(y), bs)
                xs[s, i], ys[s, i] = augment(x[idx], rngs[i]), y[idx]
                continue
            try:
                b = next(iters[i])
            except StopIteration:
                iters[i] = batches(x, y, bs, rngs[i])
                b = next(iters[i])
            xs[s, i], ys[s, i] = b
    return xs, ys


def _stack_vals(vals):
    """Pad per-node validation sets to a common length + validity mask."""
    n = len(vals)
    vmax = max(len(y) for _, y in vals)
    h = vals[0][0].shape[1]
    vx = np.zeros((n, vmax, h, h, 3), np.float32)
    vy = np.zeros((n, vmax), np.int64)
    vm = np.zeros((n, vmax), bool)
    for i, (x, y) in enumerate(vals):
        vx[i, :len(y)], vy[i, :len(y)], vm[i, :len(y)] = x, y, True
    return vx, vy, vm


def _train_loop(ecfg, train_step, shards, model, layout, device, *,
                swarm_cfg=None, log=None):
    """Train nodes (swarm if swarm_cfg else isolated) on a `SwarmSession`.
    Returns the stacked node params [N, P] and the sync log."""
    n = len(shards)
    vals, trains = [], []
    for x, y in shards:
        n_val = max(8, int(len(y) * ecfg.val_frac))
        vals.append((x[:n_val], y[:n_val]))
        trains.append((x[n_val:], y[n_val:]))

    params = layout.flatten(_init_params(ecfg, model)).to(device)
    xs, ys = _batch_stream(ecfg, trains)
    xs = torch.from_numpy(xs).to(device)
    ys = torch.from_numpy(ys.astype(np.int64)).to(device)
    val = _stack_vals(vals)

    cfg = swarm_cfg or SwarmConfig(n_nodes=n, sync_every=10**9,
                                   gate_metric="auc")
    sess = SwarmSession(cfg, train_step, _make_eval_fn(cfg, model, layout),
                        params=params, opt_state=adamw_init(params),
                        data_sizes=[len(y) for _, y in shards],
                        layout=layout, device=device)

    sync_log = []
    if swarm_cfg is None or cfg.sync_every > ecfg.steps:
        sess.run_local((xs, ys))
    else:
        t = cfg.sync_every
        rounds = ecfg.steps // t
        head = (xs[:rounds * t].reshape((rounds, t) + xs.shape[1:]),
                ys[:rounds * t].reshape((rounds, t) + ys.shape[1:]))
        logs = sess.run_rounds(head, val)
        if ecfg.steps % t:
            sess.run_local((xs[rounds * t:], ys[rounds * t:]))
        gates = logs["gates"].cpu().numpy()
        ml = logs["metric_local"].cpu().numpy()
        mm = logs["metric_merged"].cpu().numpy()
        sync_log = [{"step": (r + 1) * t, "gates": gates[r].tolist(),
                     "metric_local": ml[r].tolist(),
                     "metric_merged": mm[r].tolist(),
                     "spectral_gap": sess.engine.spectral_gap}
                    for r in range(rounds)]
        if log is not None:
            log.extend(sync_log)
    return sess.state.params, sync_log


def run_experiment(ecfg: HistoExperimentConfig, *, device="cuda") -> dict:
    """Full §4 protocol. Returns nested report dict."""
    device = resolve_device(device)
    images, labels = make_histo_dataset(
        ecfg.n_train, size=ecfg.image_size, noise=ecfg.noise,
        class_probs=ecfg.class_probs, seed=ecfg.seed)
    test_x, test_y = make_histo_dataset(
        ecfg.n_test, size=ecfg.image_size, noise=ecfg.noise,
        class_probs=ecfg.class_probs, seed=ecfg.seed + 999)

    sizes = paper_splits(ecfg.n_train, ecfg.fractions)
    shards = shard_to_nodes(images, labels, sizes, seed=ecfg.seed)
    if ecfg.scarcity:  # down-sample chosen nodes (the 25% / 5% trials)
        shards = [
            (x[: max(16, int(len(y) * ecfg.scarcity.get(i, 1.0)))],
             y[: max(16, int(len(y) * ecfg.scarcity.get(i, 1.0)))])
            for i, (x, y) in enumerate(shards)
        ]

    model = _model(ecfg)
    layout = FlatLayout.of_module(model)
    train_step, predict = _make_model_fns(ecfg, model, layout)
    test_xd = torch.from_numpy(test_x).to(device)

    def report(params):
        probs, feats = predict(params, test_xd)
        rep = classify_report(probs.cpu().numpy(), test_y)
        rep["dbi"] = davies_bouldin(feats.cpu().numpy(), test_y)
        return rep

    # centralized full-data baseline
    params = layout.flatten(_init_params(ecfg, model)).to(device)
    opt = adamw_init(params)
    rng = np.random.default_rng(ecfg.seed)
    it = iter(())
    for step in range(ecfg.steps):
        try:
            b = next(it)
        except StopIteration:
            it = batches(images, labels, 32, rng)
            b = next(it)
        x = torch.from_numpy(b[0]).to(device)
        y = torch.from_numpy(b[1].astype(np.int64)).to(device)
        params, opt, _ = train_step(params, opt, (x, y), step)
    central = report(params)

    # standalone local learners
    local_params, _ = _train_loop(ecfg, train_step, shards, model, layout,
                                  device, swarm_cfg=None)
    local = [report(p) for p in local_params]

    # P2P-SL swarm
    swarm_params, sync_log = _train_loop(ecfg, train_step, shards, model,
                                         layout, device, swarm_cfg=ecfg.swarm)
    swarm = [report(p) for p in swarm_params]

    return {
        "config": {"sizes": [len(s[1]) for s in shards], "steps": ecfg.steps,
                   "sync_every": ecfg.swarm.sync_every,
                   "merge": ecfg.swarm.merge, "topology": ecfg.swarm.topology},
        "centralized": central,
        "local": local,
        "swarm": swarm,
        "sync_log": sync_log[-3:],
        "recovery": [  # fraction of centralized AUC recovered by swarm
            (s["auc"] - 0.5) / max(central["auc"] - 0.5, 1e-9) for s in swarm
        ],
    }


def summarize(result: dict) -> str:
    lines = ["node,setting,auc,sensitivity,specificity,f1,dbi"]
    c = result["centralized"]
    lines.append(f"-,centralized,{c['auc']:.4f},{c['sensitivity']:.2f},"
                 f"{c['specificity']:.2f},{c['f1']:.2f},{c['dbi']:.3f}")
    for i, (l, s) in enumerate(zip(result["local"], result["swarm"])):
        lines.append(f"{i},local,{l['auc']:.4f},{l['sensitivity']:.2f},"
                     f"{l['specificity']:.2f},{l['f1']:.2f},{l['dbi']:.3f}")
        lines.append(f"{i},swarm,{s['auc']:.4f},{s['sensitivity']:.2f},"
                     f"{s['specificity']:.2f},{s['f1']:.2f},{s['dbi']:.3f}")
    return "\n".join(lines)
