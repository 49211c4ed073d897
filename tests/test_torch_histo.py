"""End to end: the paper's protocol (``run_experiment``, TINY config) in both
packages from the same init — the port's ``_init_params`` is patched to hand
back the reference's init carried across — with the centralized, local and
swarm report rows and the sync logs compared at 2e-3, on the f32 wire and
on the int8 error-feedback wire."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import SwarmConfig as JSwarmConfig  # noqa: E402
from repro.experiments import histo as jh  # noqa: E402
from repro_torch.configs.base import SwarmConfig  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.experiments import histo as th  # noqa: E402

tp.torch_cpu()
TOL = dict(rtol=2e-3, atol=2e-3)
KEYS = ("auc", "accuracy", "sensitivity", "specificity", "f1", "dbi")


def _both_reports(**wire):
    swarm = dict(n_nodes=4, sync_every=3, topology="full", merge="fedavg",
                 lora_only=False, val_threshold=0.8, **wire)
    jcfg = jh.HistoExperimentConfig(seed=0, swarm=JSwarmConfig(**swarm),
                                    **tp.TINY)
    tcfg = th.HistoExperimentConfig(seed=0, swarm=SwarmConfig(**swarm),
                                    **tp.TINY)
    init = jax.tree.map(np.asarray, jh._init_params(
        jcfg, jax.random.key(jcfg.seed + 42)))

    def carried_init(ecfg, model):
        layout = th.FlatLayout.of_module(model)
        return layout.unflatten(from_reference(layout, init))

    mp = pytest.MonkeyPatch()
    mp.setattr(th, "_init_params", carried_init)
    try:
        port = th.run_experiment(tcfg, device="cpu")
    finally:
        mp.undo()
    return jh.run_experiment(jcfg), port


@pytest.fixture(scope="module")
def both_reports():
    return _both_reports()


@pytest.fixture(scope="module")
def int8_reports():
    return _both_reports(wire_dtype="int8", wire_block=128)


def _row(rep):
    return np.asarray([rep[k] for k in KEYS])


def test_report_rows_match(both_reports):
    _check_rows(*both_reports)


def test_int8_wire_report_and_sync_logs_match(int8_reports):
    ref, port = int8_reports
    _check_rows(ref, port)
    _check_sync_logs(ref, port)


def _check_rows(ref, port):
    assert port["config"] == ref["config"]
    np.testing.assert_allclose(_row(port["centralized"]),
                               _row(ref["centralized"]), **TOL)
    for setting in ("local", "swarm"):
        assert len(port[setting]) == len(ref[setting]) == 4
        for a, b in zip(port[setting], ref[setting]):
            np.testing.assert_allclose(_row(a), _row(b), **TOL)
    np.testing.assert_allclose(port["recovery"], ref["recovery"], rtol=2e-2,
                               atol=2e-2)


def test_sync_logs_match(both_reports):
    _check_sync_logs(*both_reports)


def _check_sync_logs(ref, port):
    assert len(port["sync_log"]) == len(ref["sync_log"]) == 2
    for a, b in zip(port["sync_log"], ref["sync_log"]):
        assert a["step"] == b["step"] and a["gates"] == b["gates"]
        np.testing.assert_allclose(a["metric_local"], b["metric_local"], **TOL)
        np.testing.assert_allclose(a["metric_merged"], b["metric_merged"], **TOL)
        assert a["spectral_gap"] == pytest.approx(b["spectral_gap"])


def test_summarize_format_matches(both_reports):
    ref, port = both_reports
    a, b = th.summarize(port).splitlines(), jh.summarize(ref).splitlines()
    assert len(a) == len(b) == 10 and a[0] == b[0]
    assert [ln.split(",")[:2] for ln in a] == [ln.split(",")[:2] for ln in b]
