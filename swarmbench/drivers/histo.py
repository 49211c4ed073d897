"""The paper's DenseNet-lite swarm, built as the port's protocol builds it
(`repro_torch.experiments.histo`: its train step and gate eval over the
flat layout, a `SwarmSession` on the engine backend); the configuration's
``reference`` names the plain CNN (`swarmbench.reference.cnn`)."""
from __future__ import annotations

import types

import torch

from swarmbench import work
from swarmbench.harness import Cell, load_reference
from swarmbench.traffic import Traffic, generator


def build(config: dict, workload: dict, seed: int, device) -> Cell:
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.core.flat import FlatLayout
    from repro_torch.core.session import SwarmSession
    from repro_torch.experiments import histo
    from repro_torch.optim import adamw_init

    m, sw, tr = config["model"], workload["swarm"], workload["train"]
    cnn = load_reference(config["reference"])
    tf32 = config["precision"]["conv"] == "tf32"
    if torch.backends.cudnn.allow_tf32 != tf32:
        raise RuntimeError("cuDNN's TF32 flag is not what the configuration "
                           "states")
    if tr["warmup_steps"] != 20:
        raise ValueError("the protocol's step warms up over 20 steps")
    traffic = Traffic(workload["traffic"], m, sw["n_nodes"], seed, device)
    init = cnn.init(m, generator(seed, 2, device), device)
    scfg = SwarmConfig(n_nodes=sw["n_nodes"], sync_every=sw["sync_every"],
                       topology=sw["topology"], merge=sw["merge"],
                       lora_only=False, val_threshold=sw["val_threshold"],
                       gate_metric=sw["gate_metric"],
                       wire_dtype=sw["wire_dtype"],
                       self_weight=sw.get("self_weight", 0.5))
    ecfg = histo.HistoExperimentConfig(
        image_size=m["image_size"], steps=tr["max_steps"], lr=tr["lr"],
        batch_size=workload["traffic"]["batch_per_node"],
        sync_every=sw["sync_every"], swarm=scfg, growth=m["growth"],
        stem=m["stem"], feat_dim=m["feat_dim"], hidden=m["hidden"],
        n_blocks=m["n_blocks"], layers_per_block=m["layers_per_block"])
    model = histo._model(ecfg)
    layout = FlatLayout.of_module(model)
    step, _ = histo._make_model_fns(ecfg, model, layout)
    flat = layout.flatten(init)
    sess = SwarmSession(
        scfg, step, histo._make_eval_fn(scfg, model, layout), params=flat,
        opt_state=adamw_init(flat), data_sizes=traffic.data_sizes,
        layout=layout, device=device)
    del flat

    f = work.cnn_forward_flops(m)
    t, n, b = sw["sync_every"], sw["n_nodes"], workload["traffic"]["batch_per_node"]
    v = workload["traffic"]["val_per_node"]
    round_flops = t * n * b * (3 * f["total"] - f["stem"]) + 2 * n * v * f["total"]
    ref = types.SimpleNamespace(
        loss=lambda p, batch, policy="f32": cnn.loss(p, batch, m, policy),
        gate_metric=lambda p, val, policy="f32": cnn.gate_metric(p, val, m,
                                                                  policy),
        store=lambda k, x: x)
    return Cell(session=sess, layout=layout, init=init, traffic=traffic,
                ref=ref, swarm=sw, train=tr, round_flops=round_flops,
                peak_flops=config["peak_flops"],
                kernels={"commit": {"n": n, "p": layout.n_values,
                                    "itemsize": 4}},
                device_notes={"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
