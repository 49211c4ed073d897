"""The readings the check's limits are set from, for one cell, on the card.

    python3 swarmbench/calibrate.py --workload <cell> --program 101-112 \\
        --control 201-203 --faults 301-303 [--out FILE]

For each ``--program`` seed: the port's first round (as a run's set-up
drives it) judged by the reference. For each ``--control`` seed: the
reference in the port's place one precision below the configuration's
(``bf16`` for a float32 configuration, ``fp8`` for a bfloat16 one). For
each ``--faults`` seed: the reference in the port's place with each fault
of `swarmbench.standin` planted (``frozen`` reads 1 by its measure and
is not run). One JSON line a reading (seed, kind, the numbers); the
benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str):
    if not text:
        return []
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from swarmbench import harness, observe, standin

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    control = "bf16" if config["model"].get("param_dtype",
                                            "float32") == "float32" else "fp8"
    runs = ([(s, "program", "f32", ()) for s in seeds(args.program)]
            + [(s, "control", control, ()) for s in seeds(args.control)]
            + [(s, "half_batch", "f32", ()) for s in seeds(args.faults)]
            + [(s, "sound", "f32", standin.DERIVED)
               for s in seeds(args.faults)])
    out = open(args.out, "a") if args.out else None
    for seed, kind, policy, derived in runs:
        t = time.perf_counter()
        cell = harness.build(config, workload, seed, "cuda")
        batches = cell.traffic.draw(cell.steps)
        if kind == "program":
            obs = observe.first_round(cell, batches)
        else:
            cell.session = None
            gc.collect()
            torch.cuda.empty_cache()
            obs = standin.first_round(
                cell, batches, "cuda", policy,
                fault=kind if kind == "half_batch" else "")
        first = harness.keep(cell, batches, obs)
        traffic, ref = cell.traffic, cell.ref
        del cell, batches, obs
        gc.collect()
        torch.cuda.empty_cache()
        start = harness.follow(first, ref, workload["swarm"],
                               workload["train"], "cuda")
        readings = [(kind, first["obs"])] + [
            (f, standin.derive(first["obs"], f)) for f in derived]
        for name, obs in readings:
            numbers = harness.judge(dict(first, obs=obs), traffic, ref,
                                    workload["swarm"], workload["train"],
                                    workload["limits"], "cuda",
                                    start=start)
            row = {"cell": args.workload, "seed": seed, "kind": name,
                   "policy": policy, "numbers": numbers,
                   "seconds": time.perf_counter() - t}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del first, traffic, ref, start, readings
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
