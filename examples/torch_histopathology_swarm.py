"""End-to-end run of the paper's cancer-histopathology experiments on the
PyTorch/CUDA port (the twin of ``examples/histopathology_swarm.py``).

Runs the full §4 protocol: 4 nodes, unbalanced 10/30/30/30 shards, P2P-SL
with validation-gated FedAvg merging every `sync_every` steps, against
centralized and standalone baselines; then the 25% and 5% scarcity trials.
Writes one JSON a scenario and seed into experiments/histo_torch/ (relative
to the working directory), in the layout of the reference's
experiments/histo/.

Run:  PYTHONPATH=src python examples/torch_histopathology_swarm.py
      [--steps 400] [--n-train 2000] [--seeds 1] [--device cpu]
"""
import argparse
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.experiments.histo import (HistoExperimentConfig,
                                           run_experiment, summarize)

OUT = "experiments/histo_torch"
# scenario → the config fields it sets beside steps, n_train, noise, seed
SCENARIOS = {
    "unbalanced": {},
    "scarcity25": {"scarcity": {2: 0.25}},
    "scarcity5": {"scarcity": {3: 0.05}},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--seeds", type=int, default=1,
                    help="the paper repeats 5 seeds")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":   # the convolutions' precision on the card
        print(f"TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
              f"cuDNN convolutions {torch.backends.cudnn.allow_tf32}")
    os.makedirs(OUT, exist_ok=True)

    results, start = {}, time.perf_counter()
    for tag, extra in SCENARIOS.items():
        for seed in range(args.seeds):
            cfg = HistoExperimentConfig(
                steps=args.steps, n_train=args.n_train, noise=0.8,
                seed=seed, **extra)
            print(f"\n=== scenario {tag} (seed {seed}) "
                  f"steps={cfg.steps} ===")
            t0 = time.perf_counter()
            r = run_experiment(cfg, device=device)
            print(summarize(r))
            print("recovery of centralized AUC:",
                  [round(x, 2) for x in r["recovery"]],
                  f"({time.perf_counter() - t0:.1f} s)")
            name = tag if seed == 0 else f"{tag}_seed{seed}"
            with open(os.path.join(OUT, f"{name}.json"), "w") as f:
                json.dump(r, f, indent=2, default=float)
            results[name] = r
    print(f"\nresults written to {OUT}/ "
          f"({time.perf_counter() - start:.1f} s)")
    return results


if __name__ == "__main__":
    main()
