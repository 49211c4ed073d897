"""The check of cell `histo-densenet224-n4.local` at a small size on the CPU: a sound run
comes out correct; the control (the reference in the port's place one
precision below the configuration's) and each fault planted under the
timed path (a step that leaves its state unchanged, half of each batch
left out, the exchange between nodes left out, a committed answer or a
gate metric altered) come out not correct against the cell's own
limits."""
import time

import pytest

from swarmbench import check, harness, standin
from swarmbench_smoke import control_policy, small

CELL = "histo-densenet224-n4.local"


def _run():
    wl, cfg = small(CELL)
    out, _ = harness.run({"per_layer": []}, CELL, 2 ** 31 + 77, 0.2, False,
                         "cpu", time.perf_counter(), workload=wl, config=cfg)
    return out


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "cpu" and out["failed"] == 0
    assert list(out)[-1] == "check"


def test_control_is_not_correct():
    wl, cfg = small(CELL)
    cell = harness.build(cfg, wl, 2 ** 31 + 78, "cpu")
    cell.session = None
    batches = cell.traffic.draw(cell.steps)
    obs = standin.first_round(cell, batches, "cpu", control_policy(cfg))
    first = harness.keep(cell, batches, obs)
    numbers = harness.judge(first, cell.traffic, cell.ref, wl["swarm"],
                            wl["train"], wl["limits"], "cpu")
    assert not check.verdict(numbers, wl["limits"]), numbers


def _frozen(orig):
    def steps(self, params, opt_state, *args, **kw):
        keep = params.clone()
        out = orig(self, params, opt_state, *args, **kw)
        out[0].copy_(keep)
        return out
    return steps


def _half(orig):
    def steps(self, params, opt_state, batches, *args, **kw):
        def cut(v):
            return v[:, :, : v.shape[2] // 2]
        if isinstance(batches, dict):
            batches = {k: cut(v) for k, v in batches.items()}
        else:
            batches = tuple(cut(v) for v in batches)
        return orig(self, params, opt_state, batches, *args, **kw)
    return steps


def _altered(orig, what):
    def sync(self, *args, **kw):
        committed, log = orig(self, *args, **kw)
        if what == "params":
            committed = committed.clone()
            committed[0] = committed[0] * 1.01
        else:
            log = dict(log, metric_local=log["metric_local"].clone())
            log["metric_local"][0] += 0.01
        return committed, log
    return sync


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "no_exchange",
                                   "altered", "altered_metric"])
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core import engine
    eng = engine.SwarmEngine
    if fault == "frozen":
        monkeypatch.setattr(eng, "local_steps", _frozen(eng.local_steps))
    elif fault == "half_batch":
        monkeypatch.setattr(eng, "local_steps", _half(eng.local_steps))
    elif fault == "no_exchange":
        monkeypatch.setattr(engine, "fused_merge_all",
                            lambda x, W, gates, imp=None: x.clone())
    elif fault == "altered":
        monkeypatch.setattr(eng, "sync", _altered(eng.sync, "params"))
    else:
        monkeypatch.setattr(eng, "sync", _altered(eng.sync, "metric"))
    out = _run()
    assert not out["correct"], out["check"]
