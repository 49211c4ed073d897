"""The port's twins of the reference's examples against the reference, on
the CPU: ``examples/torch_engine_swarm.py`` against the body of
``examples/engine_swarm.py`` run through the JAX package (same initial
params, losses and gates), ``examples/torch_histopathology_swarm.py``'s
scenario table and configs against ``examples/histopathology_swarm.py``'s
(both with ``run_experiment`` stubbed), ``run_experiment`` under scarcity in
both packages, ``examples/torch_serve_demo.py``'s token streams against the
reference's ``generate``, decode loop and ``ServeEngine`` from the same
params, and the flash kernel's head dims against every head dim the
reference's configs and examples use. The twins' smoke runs as scripts are
``tests/test_torch_host.py::test_example_twin_runs_on_cpu``."""
import ast
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.core.session import SwarmSession as JSession  # noqa: E402
from repro.experiments import histo as jh  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.launch.serve import serve_step_for as jserve_step_for  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.encdec import encode as jencode  # noqa: E402
from repro.serve import BucketPolicy as JBucketPolicy  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.convert import (from_reference,  # noqa: E402
                                 lm_params_from_reference)
from repro_torch.experiments import histo as th  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_apply  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
tp.torch_cpu()


def _load(script):
    """An example script as a module (its ``main`` not run)."""
    name = "example_" + Path(script).stem
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the engine twin
# ---------------------------------------------------------------------------

def test_engine_twin_matches_reference_example():
    """The reference example's ``main`` runs as written, its session
    recording the initial params and each ``run_rounds`` log; the twin's
    ``run`` starts from those params carried across. Every local step's
    node losses within rtol 1e-4 (15 steps at lr 3e-3 and 15 more after
    ``leave(3)``), the gates equal before and after the leave."""
    ref = _load("engine_swarm.py")
    seen = {"logs": []}

    class Recording(JSession):
        def __init__(self, *a, params=None, **kw):
            seen["params"] = _np_tree(params)
            super().__init__(*a, params=params, **kw)

        def run_rounds(self, batches, val):
            out = super().run_rounds(batches, val)
            seen["logs"].append(_np_tree(out))
            return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "SwarmSession", Recording)
    try:
        ref.main()
    finally:
        mp.undo()
    twin = _load("torch_engine_swarm.py")
    cfg = twin.CFG
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JModelConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256))
    assert cfg.head_dim == 16 and cfg.head_dim in HEAD_DIMS
    layout = build_model(cfg).layout
    got = twin.run(lm_params_from_reference(layout, seen["params"]), "cpu")
    first, left = seen["logs"]
    for want, have in ((first, got), (left, got["left"])):
        jl = np.asarray(want["train"]["loss"])
        assert jl.shape == (twin.ROUNDS, twin.SYNC_EVERY, twin.N_NODES)
        np.testing.assert_allclose(have["losses"], jl, rtol=1e-4)
        np.testing.assert_array_equal(
            have["gates"], np.asarray(want["gates"]).astype(bool))
    assert not got["left"]["gates"][:, 3].any()
    assert got["session"].active.all()
    assert int(got["session"].state.round) == 2 * twin.ROUNDS


# ---------------------------------------------------------------------------
# the histopathology twin
# ---------------------------------------------------------------------------

def _stub_run(module, argv, monkeypatch, tmp):
    """``module.main`` under ``argv`` in ``tmp`` with ``run_experiment`` and
    ``summarize`` stubbed: returns the configs it built, in order, and the
    JSON files it wrote."""
    cfgs = []

    def fake_run(cfg, **kw):
        cfgs.append(cfg)
        return {"recovery": [0.5, 0.25, 0.125, 1.0], "seed": cfg.seed}

    tmp.mkdir()
    with monkeypatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(module, "run_experiment", fake_run)
        mp.setattr(module, "summarize", lambda r: "")
        mp.setattr(sys, "argv", [module.__name__] + argv)
        module.main()
    files = {p.relative_to(tmp).as_posix(): json.loads(p.read_text())
             for p in sorted(Path(tmp).rglob("*.json"))}
    return cfgs, files


def test_histo_twin_scenarios_and_configs_match_reference(tmp_path,
                                                          monkeypatch):
    """Both examples with ``run_experiment`` stubbed (nothing trains): the
    same scenarios in the same order, each config equal field by field
    (the swarm config too), the same JSON names under each output folder
    and the same content."""
    ref = _load("histopathology_swarm.py")
    twin = _load("torch_histopathology_swarm.py")
    argv = ["--steps", "7", "--n-train", "99", "--seeds", "2"]
    jcfgs, jfiles = _stub_run(ref, argv, monkeypatch, tmp_path / "ref")
    tcfgs, tfiles = _stub_run(twin, argv + ["--device", "cpu"], monkeypatch,
                              tmp_path / "twin")
    assert len(tcfgs) == len(jcfgs) == 3 * 2
    for j, t in zip(jcfgs, tcfgs):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.steps == 7 and t.n_train == 99 and t.noise == 0.8
    assert [c.scarcity for c in tcfgs[::2]] == [None, {2: 0.25}, {3: 0.05}]
    assert twin.OUT == "experiments/histo_torch" and ref.OUT == \
        "experiments/histo"
    names = {k.split("/", 2)[-1] for k in jfiles}
    assert names == {"unbalanced.json", "unbalanced_seed1.json",
                     "scarcity25.json", "scarcity25_seed1.json",
                     "scarcity5.json", "scarcity5_seed1.json"}
    assert {k.replace("histo_torch/", "histo/") for k in tfiles} == \
        set(jfiles)
    for k, v in tfiles.items():
        assert v == jfiles[k.replace("histo_torch/", "histo/")]
    # the twin's table is the reference's
    assert list(twin.SCENARIOS) == ["unbalanced", "scarcity25", "scarcity5"]


def _keys(tree):
    """The key layout of a JSON value: dicts by key, lists by length."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return type(tree).__name__


def test_run_experiment_under_scarcity_matches_reference():
    """``run_experiment`` at the TINY protocol with ``scarcity={3: 0.05}``
    and batch 16: nodes 0 and 3 keep 8 training rows, below the batch, so
    their streams resample with replacement each step. The port from the
    reference's init carried across: the shard sizes, every report row
    within 2e-3 (test_torch_histo's tolerance) and the JSON layout of the
    result the same. Recovery is not held to a tolerance at this length:
    the centralized AUC sits near 0.5, where it divides by almost 0."""
    swarm = dict(n_nodes=4, sync_every=3, topology="full", merge="fedavg",
                 lora_only=False, val_threshold=0.8)
    kw = dict(tp.TINY, batch_size=16, scarcity={3: 0.05}, seed=0)
    jcfg = jh.HistoExperimentConfig(swarm=JSwarmConfig(**swarm), **kw)
    tcfg = th.HistoExperimentConfig(swarm=SwarmConfig(**swarm), **kw)
    init = _np_tree(jh._init_params(jcfg, jax.random.key(jcfg.seed + 42)))

    def carried_init(ecfg, model):
        layout = th.FlatLayout.of_module(model)
        return layout.unflatten(from_reference(layout, init))

    mp = pytest.MonkeyPatch()
    mp.setattr(th, "_init_params", carried_init)
    try:
        port = th.run_experiment(tcfg, device="cpu")
    finally:
        mp.undo()
    want = jh.run_experiment(jcfg)
    assert port["config"] == want["config"]
    assert port["config"]["sizes"] == [16, 48, 48, 16]
    keys = ("auc", "accuracy", "sensitivity", "specificity", "f1", "dbi")
    rows = [(port["centralized"], want["centralized"])]
    rows += list(zip(port["local"] + port["swarm"],
                     want["local"] + want["swarm"]))
    assert len(rows) == 9
    for got, ref in rows:
        np.testing.assert_allclose([got[k] for k in keys],
                                   [ref[k] for k in keys], rtol=2e-3,
                                   atol=2e-3)
    assert [s["gates"] for s in port["sync_log"]] == \
        [list(map(bool, s["gates"])) for s in want["sync_log"]]
    dump = lambda r: json.loads(json.dumps(r, indent=2, default=float))
    assert _keys(dump(port)) == _keys(dump(want))


# ---------------------------------------------------------------------------
# the serving twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m",
                                  "phi3.5-moe-42b-a6.6b",
                                  "seamless-m4t-medium"])
def test_serve_twin_tokens_equal_reference(arch):
    """``demo(arch)`` from the reference demo's own init (key 0) carried
    across: its 4 × 16 greedy tokens equal the reference's ``generate``
    on the same prompt (seamless: the reference's decode loop over the
    same ``enc_out``, zero start tokens)."""
    twin = _load("torch_serve_demo.py")
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tree = jm.init(jax.random.key(0))
    out = twin.demo(arch, lm_params_from_reference(tm.layout,
                                                   _np_tree(tree)), "cpu")
    got = out["tokens"].numpy()
    assert got.shape == (twin.BATCH, twin.MAX_NEW)
    if jcfg.is_encdec:
        caches = dict(jm.init_cache(twin.BATCH, twin.MAX_LEN),
                      enc_out=jencode(tree, jcfg, jnp.asarray(out["frames"])))
        step = jserve_step_for(jm)
        tok, outs = jnp.zeros((twin.BATCH, 1), jnp.int32), []
        for i in range(twin.MAX_NEW):
            tok, caches = step(tree, tok, caches, jnp.int32(i))
            outs.append(tok)
        want = np.concatenate([np.asarray(t) for t in outs], axis=1)
    else:
        want = np.asarray(jgenerate(jm, tree, jnp.asarray(
            out["prompt"], jnp.int32), twin.MAX_NEW, twin.MAX_LEN))
    np.testing.assert_array_equal(got, want)


def test_serve_twin_ensemble_equals_reference_engine():
    """``demo_ensemble`` from the reference demo's stacked init (keys split
    from key 0) carried across: the same warm-up, then the 6 requests'
    tokens equal the reference engine's, request by request."""
    twin = _load("torch_serve_demo.py")
    jcfg = jconfigs.smoke_variant(jconfigs.get_config("minicpm-2b")).replace(
        vocab_size=256)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("minicpm-2b")).replace(
        vocab_size=256)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tree = jax.vmap(jm.init)(jax.random.split(jax.random.key(0), 4))
    out = twin.demo_ensemble(lm_params_from_reference(
        tm.layout, _np_tree(tree), lead=1), "cpu")
    eng = JServeEngine(jm, tree, mode="consensus", max_len=48, max_slots=4,
                       policy=JBucketPolicy(batch_buckets=(1, 2, 4),
                                            seq_buckets=(16,)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, size=int(n), dtype=np.int32)
               for n in rng.integers(4, 12, size=6)]
    for p in prompts[:4]:
        eng.submit(p, max_new=2)
    eng.drain()
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    eng.drain()
    assert len(out["requests"]) == 6
    assert all(r.status == "done" for r in out["requests"])
    assert [list(r.tokens) for r in out["requests"]] == \
        [list(r.tokens) for r in reqs]


# ---------------------------------------------------------------------------
# the flash kernel's head dims
# ---------------------------------------------------------------------------

def _literal_model_configs(path):
    """``ModelConfig(...)`` calls with constant keyword arguments only."""
    out = []
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "ModelConfig" and not node.args):
            try:
                kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
            except ValueError:
                continue
            if None not in kw:
                out.append((Path(path).name, JModelConfig(**kw)))
    return out


def test_head_dims_cover_every_reference_config_and_example():
    """The kernel's head dims hold the head dim of every reference config,
    every smoke variant and every ``ModelConfig`` literal of the
    reference's examples and tests; so no model the reference runs falls
    outside the kernel on the card."""
    seen = {}
    for name in jconfigs.ARCH_IDS:
        cfg = jconfigs.get_config(name)
        seen[name] = cfg.head_dim
        seen[name + "-smoke"] = jconfigs.smoke_variant(cfg).head_dim
    refs = [p for d in ("examples", "tests")
            for p in sorted((ROOT / d).glob("*.py"))
            if not p.name.startswith(("torch_", "test_torch_"))]
    literals = [lit for p in refs for lit in _literal_model_configs(p)]
    assert any(f == "engine_swarm.py" for f, _ in literals)
    for f, cfg in literals:
        seen[f"{f}:{cfg.name}"] = cfg.head_dim
    assert 16 in seen.values()
    missing = {k: d for k, d in seen.items() if d not in HEAD_DIMS}
    assert not missing, missing


def test_flash_at_head_dim_16_matches_reference_kernel():
    """The engine twin's attention shape, q [32, 4, 32, 16] over K/V
    [32, 2, 32, 16] (the node axis folded into the batch): the port's
    differentiable entry point on the CPU against the reference's Pallas
    kernel in interpret mode, causal and without the mask, within 2e-5
    (the reference's f32 sweep tolerance)."""
    rng = np.random.default_rng(16)
    q = rng.normal(0, 1, (32, 4, 32, 16)).astype(np.float32)
    k = rng.normal(0, 1, (32, 2, 32, 16)).astype(np.float32)
    v = rng.normal(0, 1, (32, 2, 32, 16)).astype(np.float32)
    for causal in (True, False):
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  interpret=True))
        got = flash_apply(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
