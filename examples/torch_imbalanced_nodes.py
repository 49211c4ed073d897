"""Merge-strategy & topology ablation under node imbalance, on the
PyTorch/CUDA port (the twin of ``examples/imbalanced_nodes.py``).

The paper uses FedAvg-weighted full merging; its §2 survey cites Fisher
and gradient-matching merging as principled upgrades. On the same biased
shards this compares:

  fedavg/full    the paper's mechanism (faithful baseline)
  mean/full      unweighted averaging (the paper's strawman)
  fedavg/ring    sparse P2P gossip
  fisher/full    diagonal-Fisher-weighted merging
  gradmatch/full uncertainty-based gradient matching

and DYNAMIC MEMBERSHIP: node 3 leaves the swarm mid-training via
``session.leave(3)`` and re-joins later via ``session.join(3)``.

fisher/gradmatch take their importance mass from the strategy's Δθ²
accumulation during the local steps (no host-side Fisher loop); with AdamW
that proxy weighs update activity more than curvature.

Run:  PYTHONPATH=src python examples/torch_imbalanced_nodes.py
      [--steps 150] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SwarmConfig, TrainConfig
from repro_torch.core.flat import FlatLayout
from repro_torch.core.session import SwarmSession
from repro_torch.data import batches, make_histo_dataset, shard_to_nodes
from repro_torch.metrics import classify_report
from repro_torch.models.cnn import (HistoCNN, bce_loss, forward_cnn,
                                    init_cnn, one_hot)
from repro_torch.optim import adamw_init, adamw_update_


def run(swarm_cfg, steps, device, dynamic=False, seed=0):
    imgs, labels = make_histo_dataset(1200, size=24, noise=0.8,
                                      class_probs=(0.5, 0.3, 0.2), seed=seed)
    test_x, test_y = make_histo_dataset(400, size=24, noise=0.8,
                                        class_probs=(0.5, 0.3, 0.2),
                                        seed=seed + 99)
    # class-biased shards: each node sees a skewed class mix
    shards = shard_to_nodes(imgs, labels, [120, 360, 360, 360], seed=seed,
                            class_bias=[[5, 1, 1], [1, 5, 1], [1, 1, 5],
                                        [1, 1, 1]])
    tc = TrainConfig(lr=1e-3, weight_decay=1e-4)
    model = HistoCNN(growth=8, stem=16, feat_dim=96, hidden=32)
    layout = FlatLayout.of_module(model)

    def loss(flat, x, y):
        return bce_loss(forward_cnn(model, layout.unflatten(flat), x),
                        one_hot(y, 3))

    def train_step(params, opt, batch, step):
        x, y = (torch.as_tensor(t).to(device) for t in batch)
        g, l = torch.func.grad_and_value(loss)(params, x, y)
        params, opt = adamw_update_(params, g, opt, tc, 1e-3)
        return params, opt, {"loss": l}

    @torch.no_grad()
    def predict(params, x):
        return torch.sigmoid(forward_cnn(model, layout.unflatten(params),
                                         torch.as_tensor(x).to(device)))

    def eval_fn(params, val):
        x, y = val
        return classify_report(predict(params, x).cpu().numpy(), y)["auc"]

    params = layout.flatten(init_cnn(torch.Generator().manual_seed(42),
                                     model)).to(device)
    sw = SwarmSession(swarm_cfg, train_step, eval_fn, backend="host",
                      params=params, opt_state=adamw_init(params),
                      data_sizes=[len(s[1]) for s in shards], layout=layout,
                      device=device)

    rngs = [np.random.default_rng(seed * 10 + i) for i in range(4)]
    iters = [iter(()) for _ in range(4)]
    vals = [(s[0][:48], s[1][:48]) for s in shards]
    t = swarm_cfg.sync_every
    for round_start in range(0, steps, t):
        if dynamic:  # node 3 leaves at 1/3, rejoins at 2/3 of the run
            if steps // 3 <= round_start < 2 * steps // 3:
                sw.leave(3)
            else:
                sw.join(3)
        round_batches = []
        for _ in range(min(t, steps - round_start)):
            bs = []
            for i, s in enumerate(shards):
                if not sw.active[i]:
                    bs.append(None)
                    continue
                try:
                    b = next(iters[i])
                except StopIteration:
                    iters[i] = batches(s[0], s[1], 16, rngs[i])
                    b = next(iters[i])
                bs.append(b)
            round_batches.append(bs)
        # fisher/gradmatch importance mass accumulates inside the round
        sw.round(round_batches, vals)

    return [classify_report(predict(p, test_x).cpu().numpy(), test_y)["auc"]
            for p in sw.state.params]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    settings = [
        ("fedavg/full (paper)", SwarmConfig(n_nodes=4, sync_every=15,
         topology="full", merge="fedavg", lora_only=False)),
        ("mean/full", SwarmConfig(n_nodes=4, sync_every=15, topology="full",
         merge="mean", lora_only=False)),
        ("fedavg/ring (P2P)", SwarmConfig(n_nodes=4, sync_every=15,
         topology="ring", merge="fedavg", lora_only=False)),
        ("fisher/full", SwarmConfig(n_nodes=4, sync_every=15, topology="full",
         merge="fisher", lora_only=False)),
        ("gradmatch/full", SwarmConfig(n_nodes=4, sync_every=15,
         topology="full", merge="gradmatch", lora_only=False)),
    ]
    print(f"{'setting':22s}  node AUCs (scarce node first)        mean")
    for name, cfg in settings:
        aucs = run(cfg, args.steps, device)
        print(f"{name:22s}  {[round(a, 3) for a in aucs]}  {np.mean(aucs):.3f}")

    aucs = run(SwarmConfig(n_nodes=4, sync_every=15, topology="dynamic",
                           merge="fedavg", lora_only=False),
               args.steps, device, dynamic=True)
    print(f"{'dynamic membership':22s}  {[round(a, 3) for a in aucs]}  "
          f"{np.mean(aucs):.3f}   (node 3 left & re-joined)")


if __name__ == "__main__":
    main()
