"""Every cell, configuration and per-layer metric of BENCHMARK.json is a
file of its own that the harness finds by name, and the file keeps to
the benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

from swarmbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["swarmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("spec", BENCH["workloads"], ids=lambda s: s["name"])
def test_cell_loads_by_name(spec):
    wl = harness.load_json("workloads", spec["name"])
    assert wl["config"] == spec["config"]
    cfg = harness.load_json("configs", wl["config"])
    assert harness.HERE.joinpath("drivers", cfg["driver"] + ".py").is_file()
    assert set(wl["limits"]) <= set(__import__("swarmbench.check").check.ORDER)
    assert len(spec["why"]) <= 200 and spec["chips"] in (1, 4)


@pytest.mark.parametrize("spec", BENCH["workloads"], ids=lambda s: s["name"])
def test_cell_pieces_load_by_name(spec):
    """The cell's traffic kind, sync reference and its configuration's
    reference are modules found by name."""
    from swarmbench.traffic import kind_module
    wl = harness.load_json("workloads", spec["name"])
    kind = kind_module(wl["traffic"]["kind"])
    assert all(callable(getattr(kind, f)) for f in ("make", "batch",
                                                     "val_of"))
    assert harness.load_sync(wl).refuse(wl["swarm"]) is None
    cfg = harness.load_json("configs", wl["config"])
    ref = harness.load_reference(cfg["reference"])
    assert all(callable(getattr(ref, f)) for f in ("init", "loss",
                                                    "gate_metric"))


def test_a_sync_the_reference_cannot_compute_is_refused():
    wl = harness.load_json("workloads", BENCH["workloads"][0]["name"])
    wl["swarm"] = dict(wl["swarm"], merge="fisher", wire_dtype="int8")
    with pytest.raises(SystemExit, match="fisher"):
        harness.load_sync(wl)
    with pytest.raises(SystemExit):
        harness.load_reference("no_such_reference")


@pytest.mark.parametrize("spec", BENCH["configs"], ids=lambda s: s["name"])
def test_config_loads_by_name(spec):
    cfg = harness.load_json("configs", spec["name"])
    assert (ROOT / spec["file"]).is_file()
    assert cfg["source"] == spec["source"] and cfg["reduced"] == spec["reduced"]


@pytest.mark.parametrize("spec", BENCH["per_layer"], ids=lambda s: s["name"])
def test_metric_loads_by_name(spec):
    mod = harness.load_module("metrics", spec["name"])
    assert mod.UNIT == spec["unit"] and mod.MOVES == spec["moves"]
    assert spec["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(mod.read)


def test_names_and_bounds():
    names = [s["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for s in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_metrics_read_nothing_without_their_source():
    """A reader that finds nothing returns None, never 0."""
    ctx = {"cell": None, "kind": "cpu"}
    for spec in BENCH["per_layer"]:
        mod = harness.load_module("metrics", spec["name"])
        if spec["name"] in ("commit_roofline", "ssd_roofline", "mfu"):
            continue
        assert mod.read(ctx) is None


def test_run_refuses_without_a_card(capsys):
    import importlib.util

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    spec = importlib.util.spec_from_file_location(
        "swarmbench_run", ROOT / "swarmbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    cell = BENCH["workloads"][0]["name"]
    assert run.main(["--workload", cell, "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""
