"""Scenario grid: non-IID partitions + synthetic augmentation over the
heterogeneous swarm.

Port of ``repro.experiments.scenarios``: the paper's "unlike sites" setting.
Frozen, heterogeneous backbones (`repro_torch.models.zoo`) sit behind one
LoRA'd head, and only the adapter payload (180 values per node at the
defaults) crosses the int8 error-feedback wire.

  * :func:`scenario_grid` — named cells over partition strategies: iid, the
    paper's 10/30/30/30 unbalanced split, biased-label allocations, biased
    labels + synthetic minority augmentation, and Dirichlet non-IID
    sharding.
  * :func:`build_shards` — materializes one cell into per-node shards
    (numpy; the same shards as the reference from the same seed).
  * :func:`run_scenario` — drives a ``payload="lora"`` model-zoo swarm
    through the cell and reports per-site test metrics, their spread, a
    centralized single-model oracle on the pooled data with the same step
    budget, predicted wire bytes against a full-payload f32 sync, and the
    fairness gate's log; each row has the reference's keys.
  * :func:`run_grid` — the five cells, one row each.

On the card every head forward runs the fused LoRA kernel
(`repro_torch.kernels.lora_matmul`) and every commit one launch of the
quantized-wire commit kernel. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SwarmConfig, TrainConfig
from repro_torch.core import comms
from repro_torch.core.flat import FlatLayout
from repro_torch.core.lora import flatten_payload
from repro_torch.core.session import SwarmSession
from repro_torch.data import (augment, batches, dirichlet_shards,
                              make_histo_dataset, paper_splits,
                              shard_to_nodes)
from repro_torch.metrics import classify_report, gate_metric_fn
from repro_torch.models import zoo
from repro_torch.models.cnn import bce_loss, one_hot
from repro_torch.optim import adamw_init, adamw_update_, make_schedule


@dataclass(frozen=True)
class Scenario:
    """One grid cell: how the shared corpus lands on the N sites.

    partition:
      ``iid``            uniform random equal shards
      ``paper``          the paper's unbalanced 10/30/30/30 split
      ``label_skew``     biased-label allocation — site i oversamples class
                         i mod C by ``bias``
      ``label_synth``    label_skew + each site augments its starved classes
                         with ``synth_frac``·|shard| synthetic samples drawn
                         from the generator with inverted class odds
      ``dirichlet``      Dirichlet(α) non-IID federated sharding
    """

    name: str
    partition: str
    bias: float = 8.0
    alpha: float = 0.3
    synth_frac: float = 0.5
    fractions: Tuple[float, ...] = (0.10, 0.30, 0.30, 0.30)


def scenario_grid(n_nodes: int = 4) -> List[Scenario]:
    """The benchmark grid: five cells, incl. the biased-label and
    synthetic-augmentation scenarios."""
    del n_nodes  # cells are partition strategies; N is a run_scenario knob
    return [
        Scenario("iid", "iid"),
        Scenario("paper_unbalanced", "paper"),
        Scenario("label_skew", "label_skew"),
        Scenario("label_skew_synth", "label_synth"),
        Scenario("dirichlet03", "dirichlet", alpha=0.3),
    ]


def _bias_rows(n_nodes: int, n_classes: int, bias: float) -> List[List[float]]:
    """class_bias rows: site i oversamples class i mod C by ``bias``×."""
    rows = []
    for i in range(n_nodes):
        row = [1.0] * n_classes
        row[i % n_classes] = float(bias)
        rows.append(row)
    return rows


def build_shards(scn: Scenario, images, labels, n_nodes: int, *,
                 seed: int = 0, n_classes: int = 3, image_size: int = 16,
                 noise: float = 1.1):
    """Materialize one grid cell into per-node shards.

    Returns ``(shards, n_synth)``: N ``(x, y)`` pairs, and ``n_synth[i]``
    site i's synthetic-augmentation samples (zero outside ``label_synth``).
    """
    n = len(labels)
    n_synth = [0] * n_nodes
    if scn.partition == "iid":
        shards = shard_to_nodes(images, labels, [n // n_nodes] * n_nodes,
                                seed=seed)
    elif scn.partition == "paper":
        shards = shard_to_nodes(images, labels,
                                paper_splits(n, scn.fractions), seed=seed)
    elif scn.partition in ("label_skew", "label_synth"):
        bias = _bias_rows(n_nodes, n_classes, scn.bias)
        shards = shard_to_nodes(images, labels, [n // n_nodes] * n_nodes,
                                seed=seed, class_bias=bias)
        if scn.partition == "label_synth":
            # each site synthesizes samples with INVERTED class odds
            # (starved classes oversampled), shrinking its label skew
            # without sharing data
            out = []
            for i, (x, y) in enumerate(shards):
                k = max(4, int(len(y) * scn.synth_frac))
                sx, sy = make_histo_dataset(
                    k, size=image_size, n_classes=n_classes,
                    class_probs=[1.0 / w for w in bias[i]], noise=noise,
                    seed=seed * 1000 + 77 + i)
                out.append((np.concatenate([x, sx]), np.concatenate([y, sy])))
                n_synth[i] = k
            shards = out
    elif scn.partition == "dirichlet":
        shards = dirichlet_shards(images, labels, n_nodes, alpha=scn.alpha,
                                  seed=seed)
        # a Dirichlet draw can starve a site entirely; float it on a few
        # global samples so every site can still train and validate
        shards = [(x, y) if len(y) >= 8 else (images[:8], labels[:8])
                  for x, y in shards]
    else:
        raise ValueError(f"unknown partition {scn.partition!r}")
    return shards, n_synth


@dataclass
class ScenarioRunConfig:
    """Run-scale knobs, the reference's defaults (BENCH_hetero.json)."""

    n_nodes: int = 4
    n_train: int = 320
    n_test: int = 160
    image_size: int = 16  # make_histo_dataset tiles 8×8 blobs — keep ≥16
    noise: float = 1.1
    class_probs: tuple = (0.5, 0.3, 0.2)
    feat_dim: int = 16
    hidden: int = 16
    lora_rank: int = 4
    steps: int = 24
    batch_size: int = 8
    lr: float = 3e-3
    val_frac: float = 0.25
    seed: int = 0
    swarm: SwarmConfig = field(default_factory=lambda: SwarmConfig(
        n_nodes=4, sync_every=6, topology="ring", merge="fedavg",
        payload="lora", wire_dtype="int8", wire_block=128,
        val_threshold=0.0, gate_metric="auc", fairness_floor=0.05))


def _zoo_closures(nodes: Sequence[zoo.ZooNode], layout: FlatLayout,
                  cfg: SwarmConfig, tc: TrainConfig, n_classes: int):
    """Per-node ``(train_step, eval_fn)`` closures over a flat payload row
    ``[P]`` in ``layout`` (the payload's sorted paths)."""
    sched = make_schedule(tc)
    metric = gate_metric_fn(cfg.gate_metric)

    def make(node):
        def loss(row, x, y):
            return bce_loss(node.apply(layout.unflatten(row), x),
                            one_hot(y, n_classes))

        def train_step(row, opt, batch, step):
            x, y = batch
            g, lv = torch.func.grad_and_value(loss)(row, x, y)
            row, opt = adamw_update_(row, g, opt, tc, sched(opt["count"]))
            return row, opt, {"loss": lv}

        def eval_fn(row, v):
            x, y, m = v
            return metric(torch.sigmoid(node.apply(layout.unflatten(row), x)),
                          y, m)

        return train_step, eval_fn

    return [make(nd) for nd in nodes]


def _batch_stream(trains, steps: int, batch_size: int, seed: int):
    """[steps, N, B, H, W, 3] / [steps, N, B] stacked minibatch stream, the
    reference's draw for draw (tiny shards resample with replacement — the
    stacked state needs one B)."""
    n = len(trains)
    bs = min(batch_size, max(len(y) for _, y in trains))
    rngs = [np.random.default_rng(seed * 100 + i) for i in range(n)]
    iters = [iter(()) for _ in range(n)]
    h = trains[0][0].shape[1]
    xs = np.empty((steps, n, bs, h, h, 3), np.float32)
    ys = np.empty((steps, n, bs), np.int64)
    for s in range(steps):
        for i, (x, y) in enumerate(trains):
            if len(y) < bs:
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
    """Pad per-node validation sets to one length + validity mask."""
    n = len(vals)
    vmax = max(len(y) for _, y in vals)
    h = vals[0][0].shape[1]
    vx = np.zeros((n, vmax, h, h, 3), np.float32)
    vy = np.zeros((n, vmax), np.int64)
    vm = np.zeros((n, vmax), bool)
    for i, (x, y) in enumerate(vals):
        vx[i, :len(y)], vy[i, :len(y)], vm[i, :len(y)] = x, y, True
    return vx, vy, vm


def _full_payload_f32_bytes(nodes, cfg: SwarmConfig) -> float:
    """Counterfactual wire cost: the SAME schedule shape forced onto a
    full-payload f32 sync at the zoo's mean full param count."""
    full_cfg = SwarmConfig(
        n_nodes=cfg.n_nodes, sync_every=cfg.sync_every,
        topology=cfg.topology, merge=cfg.merge, lora_only=False,
        val_threshold=cfg.val_threshold, gate_metric=cfg.gate_metric)
    counts = [sum(int(x.numel()) for x in flatten_payload(
        nd.template, lambda p: True).values()) for nd in nodes]
    p_full = int(np.mean(counts))
    return comms.pick_schedule(full_cfg, simulated=True).bytes_per_sync(p_full)


def _probs(node, payload, x):
    with torch.no_grad():
        return torch.sigmoid(node.apply(payload, x)).cpu().numpy()


@dataclass
class Cell:
    """One grid cell set up to run: the data, the zoo on the device, the
    payload layout, the ``payload="lora"`` session and its inputs."""

    rcfg: ScenarioRunConfig
    images: np.ndarray
    labels: np.ndarray
    test_x: torch.Tensor
    test_y: np.ndarray
    shards: list
    n_synth: list
    nodes: list
    layout: FlatLayout
    tc: TrainConfig
    rows: list
    session: SwarmSession
    xs: torch.Tensor
    ys: torch.Tensor
    val: tuple


def prepare(scn: Scenario, rcfg: ScenarioRunConfig, *, device="cuda",
            nodes: Optional[Sequence[zoo.ZooNode]] = None) -> Cell:
    """Data, shards, zoo and session of one cell on ``device`` (see
    :func:`run_scenario`)."""
    device = resolve_device(device)
    cfg = rcfg.swarm
    n = cfg.n_nodes
    images, labels = make_histo_dataset(
        rcfg.n_train, size=rcfg.image_size, noise=rcfg.noise,
        class_probs=rcfg.class_probs, seed=rcfg.seed)
    test_x, test_y = make_histo_dataset(
        rcfg.n_test, size=rcfg.image_size, noise=rcfg.noise,
        class_probs=rcfg.class_probs, seed=rcfg.seed + 999)
    shards, n_synth = build_shards(scn, images, labels, n, seed=rcfg.seed,
                                   image_size=rcfg.image_size,
                                   noise=rcfg.noise)

    vals, trains = [], []
    for x, y in shards:
        n_val = max(4, int(len(y) * rcfg.val_frac))
        vals.append((x[:n_val], y[:n_val]))
        trains.append((x[n_val:], y[n_val:]))

    if nodes is None:
        nodes = zoo.build_zoo(torch.Generator().manual_seed(rcfg.seed), n,
                              image_size=rcfg.image_size,
                              feat_dim=rcfg.feat_dim, hidden=rcfg.hidden,
                              rank=rcfg.lora_rank)
    nodes = [nd.to(device) for nd in nodes]
    layout = FlatLayout.of_payload(nodes[0].payload())
    tc = TrainConfig(lr=rcfg.lr, warmup_steps=4, max_steps=rcfg.steps,
                     weight_decay=1e-4, schedule="cosine")
    fns = _zoo_closures(nodes, layout, cfg, tc, n_classes=3)
    rows = [layout.flatten(nd.payload()) for nd in nodes]
    sess = SwarmSession(cfg, [f[0] for f in fns], [f[1] for f in fns],
                        params=rows, opt_state=[adamw_init(r) for r in rows],
                        data_sizes=[len(y) for _, y in trains], layout=layout,
                        device=device, seed=rcfg.seed)
    xs, ys = _batch_stream(trains, rcfg.steps, rcfg.batch_size, rcfg.seed)
    return Cell(rcfg, images, labels, torch.from_numpy(test_x).to(device),
                test_y, shards, n_synth, nodes, layout, tc, rows, sess,
                torch.from_numpy(xs).to(device),
                torch.from_numpy(ys).to(device),
                tuple(torch.from_numpy(v).to(device)
                      for v in _stack_vals(vals)))


def run_scenario(scn: Scenario, rcfg: Optional[ScenarioRunConfig] = None, *,
                 device="cuda",
                 nodes: Optional[Sequence[zoo.ZooNode]] = None) -> dict:
    """One grid cell end to end. Returns the BENCH_hetero row dict.

    ``nodes``: the zoo to run (default: :func:`~repro_torch.models.zoo.
    build_zoo` from ``rcfg.seed``; the tests pass a zoo carried across from
    the reference). ``retraces`` is 0: the port runs eagerly and compiles
    nothing, so there is no trace to repeat (the reference counts jit
    retraces of the train step across rounds).
    """
    rcfg = rcfg or ScenarioRunConfig()
    cell = prepare(scn, rcfg, device=device, nodes=nodes)
    cfg, sess, layout = rcfg.swarm, cell.session, cell.layout
    nodes, device = cell.nodes, sess.device
    t = cfg.sync_every
    rounds = max(1, rcfg.steps // t)
    logs = [sess.round((cell.xs[r * t:(r + 1) * t],
                        cell.ys[r * t:(r + 1) * t]), cell.val)
            for r in range(rounds)]

    # per-site test metrics: each site's committed payload row through its
    # OWN frozen backbone, on the shared held-out test set
    per_site = []
    for nd, row in zip(nodes, sess.state.params):
        rep = classify_report(_probs(nd, layout.unflatten(row), cell.test_x),
                              cell.test_y)
        rep["family"] = nd.family
        per_site.append(rep)

    # centralized oracle: node 0's architecture on the pooled corpus with
    # the same step budget — the "no privacy constraint" upper bound
    o_step = _zoo_closures(nodes[:1], layout, cfg, cell.tc, 3)[0][0]
    p0 = cell.rows[0].to(device)
    o0 = adamw_init(p0)
    rng = np.random.default_rng(rcfg.seed)
    it = iter(())
    for step in range(rcfg.steps):
        try:
            b = next(it)
        except StopIteration:
            it = batches(cell.images, cell.labels, rcfg.batch_size, rng)
            b = next(it)
        batch = (torch.from_numpy(b[0]).to(device),
                 torch.from_numpy(b[1].astype(np.int64)).to(device))
        p0, o0, _ = o_step(p0, o0, batch, step)
    oracle = classify_report(
        _probs(nodes[0], layout.unflatten(p0), cell.test_x), cell.test_y)

    aucs = [r["auc"] for r in per_site]
    sens = [r["sensitivity"] for r in per_site]
    last = logs[-1]
    out = {
        "scenario": scn.name,
        "partition": scn.partition,
        "families": [nd.family for nd in nodes],
        "shard_sizes": [len(y) for _, y in cell.shards],
        "n_synth": cell.n_synth,
        "schedule": sess.sync_schedule.name,
        "payload_class": sess.sync_schedule.payload,
        "payload_params": int(sess.payload_params),
        "wire_bytes_per_sync": float(sess.predicted_sync_bytes),
        "full_f32_bytes_per_sync": _full_payload_f32_bytes(nodes, cfg),
        "retraces": 0,
        "rounds": rounds,
        "per_site": per_site,
        "site_auc_spread": float(max(aucs) - min(aucs)),
        "site_sensitivity_spread": float(max(sens) - min(sens)),
        "worst_site_auc": float(min(aucs)),
        "oracle": oracle,
        "oracle_gap_auc": float(oracle["auc"] - float(np.mean(aucs))),
        "gates_last": last["gates"].cpu().numpy().astype(int).tolist(),
    }
    out["wire_fraction_of_full"] = (out["wire_bytes_per_sync"]
                                    / max(out["full_f32_bytes_per_sync"], 1.0))
    if "fairness_ok" in last:
        out["fairness_ok_last"] = bool(last["fairness_ok"])
        out["worst_site_gate_metric"] = float(last["worst_site"])
    return out


def run_grid(rcfg: Optional[ScenarioRunConfig] = None,
             cells: Optional[List[Scenario]] = None, *,
             device="cuda") -> List[dict]:
    """Sweep the grid — the BENCH_hetero.json rows."""
    rcfg = rcfg or ScenarioRunConfig()
    return [run_scenario(s, rcfg, device=device)
            for s in (cells or scenario_grid())]
