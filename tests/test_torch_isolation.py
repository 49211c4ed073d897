"""The port stands alone: it imports neither jax nor anything of the
reference package ``repro``, nor the ``msgpack`` package (the card's
machine has none) — checked at run time in a fresh interpreter that drives
one small CPU round on the int8 wire, a checkpoint round trip, a
one-round fault plan with a corrupt sender, one host-loop round, a gossip
round on a one-rank gloo world with its checkpoint round trip and the
two-level mesh's size check, one small model-zoo scenario, one small LM
serve and one rank of a small dry run in a fake world, and statically
over every
source file, the jax-free test of the captured programs and the example
twins (``examples/torch_*.py``)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
# every source file of the package (`core/swarm.py`, the host loop, and
# `models/remat.py` among them) and the example twins
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
    ROOT / "tests" / "test_torch_capture.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))

_PROBE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.configs.base import SwarmConfig
from repro_torch.core.flat import FlatLayout
from repro_torch.core.session import SwarmSession
from repro_torch.experiments import histo
from repro_torch.optim import adamw_init

ecfg = histo.HistoExperimentConfig(steps=2, growth=4, stem=8, feat_dim=32,
                                   hidden=16, n_blocks=1, layers_per_block=2)
cfg = SwarmConfig(n_nodes=2, sync_every=2, topology="full", merge="fedavg",
                  lora_only=False, wire_dtype="int8", wire_block=128)
model = histo._model(ecfg)
layout = FlatLayout.of_module(model)
step, _ = histo._make_model_fns(ecfg, model, layout)
flat = layout.flatten(histo._init_params(ecfg, model))
sess = SwarmSession(cfg, step, histo._make_eval_fn(cfg, model, layout),
                    params=flat, opt_state=adamw_init(flat), layout=layout,
                    device="cpu")
rng = np.random.default_rng(0)
xs = rng.normal(0, 1, (2, 2, 4, 16, 16, 3)).astype(np.float32)
ys = rng.integers(0, 3, (2, 2, 4))
val = (rng.normal(0, 1, (2, 6, 16, 16, 3)).astype(np.float32),
       rng.integers(0, 3, (2, 6)), np.ones((2, 6), bool))
log = sess.round((xs, ys), val)
assert log["gates"].shape == (2,)
import tempfile, os
path = os.path.join(tempfile.mkdtemp(), "s.msgpack")
sess.save(path)
assert torch.equal(sess.load(path).state.wire, sess.state.wire)
from repro_torch.faults import FaultPlan, run_plan
_, logs = run_plan(sess, FaultPlan(2, 1, seed=3).corrupt(1, at=0),
                   (xs, ys), val)
assert logs[0]["wire_ok"].tolist() == [True, False]
host = SwarmSession(SwarmConfig(n_nodes=2, sync_every=1, merge="fisher",
                                topology="full", lora_only=False),
                    lambda p, o, b, s: (p - 0.1 * (p - b), o, {}),
                    lambda p, v: 1.0, params=torch.zeros(3),
                    backend="host", device="cpu")
assert host.round([[torch.ones(3), torch.zeros(3)]], [1, 1])["gates"] \
    == [True, True]
import torch.distributed as dist
from repro_torch.launch.mesh import make_swarm_mesh, make_two_level_swarm_mesh
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    tempfile.mkdtemp(), "rdv"), rank=0, world_size=1)
try:
    mesh, axis = make_swarm_mesh(2)
    gsess = SwarmSession(cfg, step, histo._make_eval_fn(cfg, model, layout),
                         params=flat, opt_state=adamw_init(flat),
                         layout=layout, device="cpu", backend="gossip",
                         mesh=mesh, axis=axis)
    gsess.round((xs, ys), val)
    gsess.save(path)
    assert torch.equal(gsess.load(path).state.wire["cres"],
                       gsess.state.wire["cres"])
    try:
        make_two_level_swarm_mesh(2, 2)
    except RuntimeError as e:
        assert "need 4 devices" in str(e)
    else:
        raise AssertionError("a two-level mesh on one rank")
finally:
    dist.destroy_process_group()
from repro_torch.experiments import scenarios
rcfg = scenarios.ScenarioRunConfig(n_train=64, n_test=16, feat_dim=8,
                                   hidden=8, steps=6)
row = scenarios.run_scenario(scenarios.scenario_grid()[2], rcfg,
                             device="cpu")
assert row["payload_class"] == "lora" and len(row["per_site"]) == 4
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.serve import BucketPolicy, ServeEngine
lm = build_model(smoke_variant(get_config("hymba-1.5b")))
ens = torch.stack([lm.init(torch.Generator().manual_seed(i), "cpu")
                   for i in range(2)])
eng = ServeEngine(lm, ens, max_len=24, max_slots=1, device="cpu",
                  policy=BucketPolicy(batch_buckets=(1,), seq_buckets=(16,)))
req = eng.submit(np.arange(1, 17), max_new=3)
eng.drain()
assert req.status == "done" and len(req.tokens) == 3
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
rec = dryrun.play("mamba2-370m", None,
                  cfg=smoke_variant(get_config("mamba2-370m")),
                  shape=ShapeConfig("s", 32, 4, "train"),
                  sizes={"data": 2, "model": 2})
assert rec["kernels"]["ssd_scan"] > 0 and not dist.is_initialized()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "msgpack" or m.startswith("msgpack.")
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""


def test_port_runs_without_jax_or_reference_modules():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists()
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
            f"{path}: imports {mod}"
