"""One run of one cell: set-up, the checked first round, the measured
window, the check, the result line.

Everything that belongs to one configuration, cell or per-layer metric
is a file of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py`` and
``reference/<reference>.py`` (named by the configuration),
``traffic/<kind>.py`` and ``reference/sync/<sync_reference>.py`` (named
by the cell), and ``metrics/<metric>.py``.

Set-up builds the cell's session from the seed (weights and data made on
the device), then runs its first round through ``SwarmSession.round``
with the check's observations (`swarmbench.observe`); that round also
builds and warms every kernel and shape the window uses. The window then
runs whole rounds, each on batches drawn on the device, a
``torch.cuda.synchronize`` closing each, until ``seconds`` have passed.
With ``trace`` it runs four stretches inside those seconds: plain rounds
(for ``mfu``), rounds with synchronised spans around the engine's local
steps and sync, ``profiled_rounds`` rounds under ``torch.profiler``
tracing the device alone (busy time, kernels), and one round tracing the
host's ops too (to name the idle gaps).
After the window the memory peak is read, the program is released and the
reference judges the first round (`swarmbench.check`).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

import torch

from swarmbench import check, observe, rates

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"swarmbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(name: str):
    """The plain reference module ``reference/<name>.py``."""
    try:
        return importlib.import_module(f"swarmbench.reference.{name}")
    except ModuleNotFoundError as err:
        raise SystemExit(f"no reference named {name!r}") from err


def load_sync(workload: dict):
    """The cell's sync reference (``reference/sync/<name>.py``), refusing
    a sync it cannot compute."""
    name = workload["sync_reference"]
    mod = load_reference(f"sync.{name}")
    why = mod.refuse(workload["swarm"])
    if why:
        raise SystemExit(f"cell {workload['name']!r}: {why}")
    return mod


@dataclass
class Cell:
    """What a driver builds for one run of a cell."""
    session: Any
    layout: Any
    init: Dict[str, torch.Tensor]       # the weights both sides start from
    traffic: Any                        # `swarmbench.traffic.Traffic`
    ref: Any                            # loss / gate_metric / store / sync
    swarm: dict
    train: dict
    round_flops: float                  # model operations of one round
    peak_flops: float                   # the stated precision's peak
    kernels: dict = field(default_factory=dict)
    device_notes: dict = field(default_factory=dict)

    @property
    def steps(self) -> int:
        return self.swarm["sync_every"]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Rounds:
    """Whole rounds of the cell, each on freshly drawn batches."""

    def __init__(self, cell: Cell, device):
        self.cell, self.device = cell, device
        self.rounds, self.failed = 0, 0

    def one(self):
        c = self.cell
        log = c.session.round(c.traffic.draw(c.steps), c.traffic.val)
        _sync(self.device)
        self.rounds += 1
        if not bool(torch.isfinite(log["train"]["loss"]).all()):
            self.failed += 1

    def until(self, t_end: float, least: int = 1) -> tuple:
        """Rounds until ``t_end`` (at least ``least``): (rounds, wall)."""
        r0, t0 = self.rounds, time.perf_counter()
        while self.rounds - r0 < least or time.perf_counter() < t_end:
            self.one()
        return self.rounds - r0, time.perf_counter() - t0


def _spans(cell: Cell, device, rounds: _Rounds, t_end: float) -> dict:
    steps, syncs = [], []

    def timed(bucket):
        def wrap(fn):
            def call(*args, **kw):
                _sync(device)
                t = time.perf_counter()
                out = fn(*args, **kw)
                _sync(device)
                bucket.append(time.perf_counter() - t)
                return out
            return call
        return wrap

    with observe.wrapped(cell.session.engine, local_steps=timed(steps),
                         sync=timed(syncs)):
        rounds.until(t_end)
    return {"local_steps_s": steps, "sync_s": syncs}


def _profile(cell: Cell, device, rounds: _Rounds, count: int) -> dict:
    """``count`` rounds traced on the device alone (between two markers),
    then one round traced on host and device for the idle gaps' names."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from swarmbench import trace
    from repro_torch.kernels import LAUNCHES
    before = dict(LAUNCHES)
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.mark()
        for _ in range(count):
            rounds.one()
        trace.mark()
        _sync(device)
    red = trace.reduce_marked(prof)
    red["launches"] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    red["rounds"] = count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("swarmbench.rounds"):
            rounds.one()
    red["idle_gaps"] = trace.reduce(
        prof, *trace.window_of(prof, "swarmbench.rounds"))["idle_gaps"]
    return red


def per_layer(bench: dict, cell_name: str, ctx: dict) -> Dict[str, dict]:
    """The cell's per-layer metrics that found something to read; none
    off the card (a CPU run's times are not the device's)."""
    out = {}
    if ctx["kind"] == "cpu":
        return out
    for spec in bench["per_layer"]:
        if "workloads" in spec and cell_name not in spec["workloads"]:
            continue
        value = load_module("metrics", spec["name"]).read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def build(config: dict, workload: dict, seed: int, device) -> Cell:
    """The cell as its driver builds it, with its sync reference."""
    sync = load_sync(workload)
    cell: Cell = load_module("drivers", config["driver"]).build(
        config, workload, seed, device)
    cell.ref.sync = sync
    return cell


def keep(cell: Cell, batches, obs: dict) -> dict:
    """What the check needs of a first round once the program is gone:
    the observations, each node's batches of steps 1-3 and the weights,
    on the host; the cell lets go of its weights."""
    n = cell.swarm["n_nodes"]
    first = {"obs": obs,
             "batches": [[_to_cpu(cell.traffic.batch(batches, k, i))
                          for k in range(3)] for i in range(n)],
             "init": {k: v.cpu() for k, v in cell.init.items()}}
    cell.init = None
    return first


def first_round(config: dict, workload: dict, seed: int, device):
    """Build the cell and run its first round with the check's
    observations: ``(cell, first)`` (:func:`keep`)."""
    cell = build(config, workload, seed, device)
    batches = cell.traffic.draw(cell.steps)
    return cell, keep(cell, batches, observe.first_round(cell, batches))


def judge(first: dict, traffic, ref, swarm: dict, train: dict, limits: dict,
          device, start: dict = None) -> dict:
    """The reference's numbers for a first round (`swarmbench.check`);
    ``start``: the reference's first steps when already followed."""
    if start is None:
        start = follow(first, ref, swarm, train, device)
    return check.judge(first["obs"], start, traffic.val_of, ref, swarm,
                       traffic.data_sizes, limits, device)


def follow(first: dict, ref, swarm: dict, train: dict, device) -> dict:
    return check.follow(
        first["init"], lambda i: [_to(b, device) for b in first["batches"][i]],
        ref, swarm["n_nodes"], train, device)


def run(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, workload: dict = None,
        config: dict = None) -> tuple:
    """One run: (the result line's object, its ``check`` last; the lines
    that print each compared number beside its limit). ``workload`` and
    ``config`` stand in for the cell's files (the tests' small sizes)."""
    device = torch.device(device)
    workload = workload or load_json("workloads", cell_name)
    config = config or load_json("configs", workload["config"])
    cell, first = first_round(config, workload, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    rounds = _Rounds(cell, device)
    t0 = time.perf_counter()
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx: dict = {"cell": cell, "kind": kind}
    if not trace:
        count, wall = rounds.until(t0 + seconds)
        metrics = {"step_s": {"value": wall / (count * cell.steps),
                              "unit": "s"}}
    else:
        count, wall = rounds.until(t0 + seconds / 3)
        ctx["plain"] = {"rounds": count, "wall_s": wall}
        ctx["spans"] = _spans(cell, device, rounds, t0 + 2 * seconds / 3)
        ctx["profile"] = _profile(cell, device, rounds,
                                  workload["trace"]["profiled_rounds"])
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak), **cell.device_notes}
    if device.type == "cuda":
        dev["power_limit"] = rates.power_limit()
    if trace:
        metrics = per_layer(bench, cell_name, ctx)
        dev["busy_s"] = ctx["profile"]["busy_s"]
        dev["window_s"] = ctx["profile"]["window_s"]
    else:
        metrics["peak_mem_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    traffic, ref, swarm, train = cell.traffic, cell.ref, cell.swarm, cell.train
    attempted, failed = rounds.rounds, rounds.failed
    del cell, ctx["cell"], rounds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = workload["limits"]
    numbers = judge(first, traffic, ref, swarm, train, limits, device)
    out = {"correct": check.verdict(numbers, limits) and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if trace:
        prof = ctx["profile"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["check"] = {k: {"value": numbers[k],
                        "limit": limits.get(k, "not compared")}
                    for k in check.ORDER if k in numbers}
    return out, check.lines(numbers, limits)


def _to_cpu(batch):
    if isinstance(batch, dict):
        return {k: v.cpu() for k, v in batch.items()}
    return tuple(v.cpu() for v in batch)


def _to(batch, device):
    if isinstance(batch, dict):
        return {k: v.to(device) for k, v in batch.items()}
    return tuple(v.to(device) for v in batch)
