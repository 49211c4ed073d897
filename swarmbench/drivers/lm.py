"""An LM swarm, built as the port's LM trainer builds it
(`repro_torch.launch.train`: ``make_train_step`` and ``make_swarm_eval``
over ``build_model``, a `SwarmSession` on the engine backend). The
configuration's ``reference`` names the LM's plain reference, a module of
`swarmbench.reference` (its ``init``, ``loss``, ``gate_metric``, ``WIDE``,
``forward_flops`` and ``kernel_calls``)."""
from __future__ import annotations

import types

import torch

from swarmbench.harness import Cell, load_reference
from swarmbench.traffic import Traffic, generator


def build(config: dict, workload: dict, seed: int, device) -> Cell:
    from repro_torch.configs.base import ModelConfig, SwarmConfig, TrainConfig
    from repro_torch.core.session import SwarmSession
    from repro_torch.launch.train import make_swarm_eval, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    m, sw, tr = config["model"], workload["swarm"], workload["train"]
    ref_mod = load_reference(config["reference"])
    cfg = ModelConfig(**{k: v for k, v in m.items() if k != "source"},
                      source=config["source"])
    dtype = getattr(torch, m["param_dtype"])
    traffic = Traffic(workload["traffic"], m, sw["n_nodes"], seed, device)
    init = ref_mod.init(m, generator(seed, 2, device), device, dtype)
    model = build_model(cfg)
    layout = model.layout
    tc = TrainConfig(lr=tr["lr"], warmup_steps=tr["warmup_steps"],
                     max_steps=tr["max_steps"], remat=tr["remat"])
    scfg = SwarmConfig(n_nodes=sw["n_nodes"], sync_every=sw["sync_every"],
                       topology=sw["topology"], merge=sw["merge"],
                       lora_only=False, val_threshold=sw["val_threshold"],
                       wire_dtype=sw["wire_dtype"],
                       self_weight=sw.get("self_weight", 0.5))
    flat = layout.flatten(init, dtype)
    sess = SwarmSession(scfg, make_train_step(model, tc),
                        make_swarm_eval(model), params=flat,
                        opt_state=adamw_init(layout.parts(flat)),
                        seed=seed, layout=layout, device=device,
                        data_sizes=traffic.data_sizes)
    del flat

    t, n = sw["sync_every"], sw["n_nodes"]
    tk = workload["traffic"]
    b, v, s = tk["batch_per_node"], tk["val_seqs"], tk["seq_len"]
    f = ref_mod.forward_flops(m, s)
    round_flops = t * n * b * 3 * f + 2 * n * v * f
    # per round: a forward of every step's rows, two gate scores
    steps = ref_mod.kernel_calls(m, n * b, s)
    gate = ref_mod.kernel_calls(m, n * v, s)
    kernels = {name: [(shape, t * calls), (gate[name][0], 2 * gate[name][1])]
               for name, (shape, calls) in steps.items()}
    wide = set(ref_mod.WIDE)

    def store(path, x):
        return x if path in wide else x.to(dtype).to(torch.float32)

    ref = types.SimpleNamespace(
        loss=lambda p, batch, policy="f32": ref_mod.loss(p, batch, m, policy),
        gate_metric=lambda p, val, policy="f32": ref_mod.gate_metric(
            p, val, m, policy),
        store=store)
    return Cell(session=sess, layout=layout, init=init, traffic=traffic,
                ref=ref, swarm=sw, train=tr, round_flops=round_flops,
                peak_flops=config["peak_flops"],
                kernels={"commit": {"n": n, "p": layout.n_values,
                                    "itemsize": 4}, **kernels},
                device_notes={})
