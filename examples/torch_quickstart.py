"""Quickstart of the PyTorch/CUDA port: the P2P-SL framework in ~80 lines.

Builds a reduced LM, trains a 4-node swarm on heterogeneous token streams
with LoRA-only peer exchanges on a ring, and prints per-round gates. Uses
`SwarmSession` with ``backend="host"``: arbitrary Python ``train_step_fn``
/ ``eval_fn`` callables, applied node by node (batches are ``[T][N]``
nested lists), with propose and commit stacked on the device. The twin of
``examples/quickstart.py`` on `repro_torch`.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      [--rounds 5] [--steps 10]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import SwarmConfig, TrainConfig
from repro_torch.core.session import SwarmSession
from repro_torch.data import make_lm_stream
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10,
                    help="local steps per round (sync_every)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. pick an assigned architecture, reduced; LoRA adapters of rank 8
    cfg = smoke_variant(get_config("minicpm-2b"))
    model = build_model(cfg, lora_rank=8)
    layout = model.layout
    tc = TrainConfig(lr=3e-3, remat=False, warmup_steps=5, max_steps=200)
    base_step = make_train_step(model, tc)

    def train_step(params, opt_state, batch, step):
        return base_step(params, opt_state, batch)

    @torch.no_grad()
    def eval_fn(params, val):
        loss, _ = model.loss_fn(layout.unflatten(params), val, remat=False)
        return 1.0 / (1.0 + float(loss))  # higher = better

    # 2. four nodes, one shared base, each injecting its own adapters
    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    node_params = [model.init(gen(0), device, adapter_generator=gen(i + 1))
                   for i in range(4)]
    swarm = SwarmSession(
        SwarmConfig(n_nodes=4, sync_every=args.steps, topology="ring",
                    merge="fedavg", lora_only=True, val_threshold=0.8),
        train_step, eval_fn, backend="host", params=node_params,
        opt_state=[adamw_init(layout.parts(p)) for p in node_params],
        data_sizes=[100, 300, 300, 300], layout=layout, device=device)

    # 3. heterogeneous local data (topic-biased token streams)
    streams = [make_lm_stream(64, 32, cfg.vocab_size, seed=i, topic_bias=1.0)
               for i in range(4)]
    rng = np.random.default_rng(0)

    def to_device(arrays):
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    vals = [to_device({k: v[:8] for k, v in s.items()}) for s in streams]

    def draw():  # one [N] list of per-node batches
        out = []
        for s in streams:
            idx = rng.integers(0, 64, 8)   # tokens and labels stay paired
            out.append(to_device({k: v[idx] for k, v in s.items()}))
        return out

    # 4. train + gossip: each round = sync_every local steps + gated merge
    for _ in range(args.rounds):
        log = swarm.round([draw() for _ in range(args.steps)], vals)
        print(f"step {log['step']:3d} gossip: gates={log['gates']} "
              f"merged-metric={[round(m, 4) for m in log['metric_merged']]}")

    for i, p in enumerate(swarm.state.params):
        print(f"node {i}: final val loss = "
              f"{1.0 / eval_fn(p, vals[i]) - 1.0:.3f}")
    print("OK — swarm training with LoRA-only P2P sync complete.")


if __name__ == "__main__":
    main()
