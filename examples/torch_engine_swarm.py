"""The engine-backend swarm session in ~60 lines, on the PyTorch/CUDA port
(the twin of ``examples/engine_swarm.py``).

Where torch_quickstart.py drives arbitrary Python callables
(``backend="host"``), this example hands the P2P-SL schedule to the default
engine backend of ``SwarmSession.run_rounds``: each round runs
``sync_every`` local steps of all nodes at once (the train step vmapped
over the node axis, so each attention layer is one flash-kernel launch for
every node), the validation of local and merged params, the 80% gate, and
the gated commit in one ``fused_merge_all`` launch. The engine runs
eagerly; its mixing matrix is built on the device from the runtime active
mask, so the membership changes below (``session.leave`` /
``session.join``) only flip one element of that mask.

Run:  PYTHONPATH=src python examples/torch_engine_swarm.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, SwarmConfig, TrainConfig
from repro_torch.core.session import SwarmSession
from repro_torch.data import make_lm_stream
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init

N_NODES, ROUNDS, SYNC_EVERY, BATCH, SEQ = 4, 3, 5, 8, 32
CFG = ModelConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=256)


def run(params, device):
    """The session from one node's initial flat params ``[P]`` (shared by
    every node). Returns the round logs: ``losses`` [rounds, T, N] and
    ``gates`` [rounds, N] of the first ``run_rounds`` call, ``left`` (the
    same after ``leave(3)``) and the session."""
    model = build_model(CFG)
    base_step = make_train_step(model, TrainConfig(
        lr=3e-3, remat=False, warmup_steps=2, max_steps=ROUNDS * SYNC_EVERY))
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
        model.layout.unflatten(p), v, remat=False)[0]))

    # heterogeneous local shards: topic-biased token streams per node
    streams = [make_lm_stream(128, SEQ, CFG.vocab_size, seed=i,
                              topic_bias=1.0) for i in range(N_NODES)]
    rng = np.random.default_rng(0)

    def block(count):  # [rounds, T, N, B, S] stacked batch schedule
        # one index draw per node, shared by every key (tokens/labels pair up)
        idx = [rng.integers(0, len(s["tokens"]), (ROUNDS, count, BATCH))
               for s in streams]
        return {k: torch.from_numpy(np.stack([s[k][i] for s, i
                                              in zip(streams, idx)],
                                             axis=2)).to(device)
                for k in streams[0]}

    vals = {k: torch.from_numpy(np.stack([s[k][:8] for s in streams]))
            .to(device) for k in streams[0]}
    params = params.to(device)
    session = SwarmSession(
        SwarmConfig(n_nodes=N_NODES, sync_every=SYNC_EVERY, topology="full",
                    merge="fedavg", lora_only=False, val_threshold=0.8),
        lambda p, o, b, s: base_step(p, o, b),
        lambda p, v: veval(p, v),
        params=params, opt_state=adamw_init(model.layout.parts(params)),
        layout=model.layout, device=device,
        data_sizes=[len(s["tokens"]) for s in streams])

    logs = session.run_rounds(block(SYNC_EVERY), vals)
    losses = logs["train"]["loss"].cpu().numpy()     # [rounds, T, N]
    gates = logs["gates"].cpu().numpy().astype(bool)
    for r in range(ROUNDS):
        print(f"round {r}: loss={[f'{l:.3f}' for l in losses[r, -1]]} "
              f"gates={gates[r].tolist()}")

    # dynamic membership: node 3 drops out of every merge; the same eager
    # round serves the new configuration (the active mask is runtime data)
    session.leave(3)
    left = session.run_rounds(block(SYNC_EVERY), vals)
    left_gates = left["gates"].cpu().numpy().astype(bool)
    print(f"node 3 left: gates={left_gates[-1].tolist()} "
          f"(round {int(session.state.round)}, "
          f"step {int(session.state.step)})")
    session.join(3)
    print(f"OK — {int(session.state.round)} rounds on the engine backend; "
          f"node 3 rejoined: active={session.active.tolist()}")
    return dict(losses=losses, gates=gates,
                left=dict(losses=left["train"]["loss"].cpu().numpy(),
                          gates=left_gates),
                session=session)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(CFG)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    return run(params, device)


if __name__ == "__main__":
    main()
