"""The plain reference against the port at small sizes on the CPU: the
CNN's logits and loss, the Mamba-2 LM's loss, the SSD scan, AdamW and its
schedule, the gate's AUC and the mixing matrices; and the parameter
paths the benchmark makes weights under against the port's layouts."""
import numpy as np
import pytest
import torch

from swarmbench.reference import cnn, mamba2, optim, precision
from swarmbench.reference.sync import mixing
from swarmbench.traffic import generator

SMALL_CNN = dict(image_size=32, n_classes=3, growth=4, stem=8, feat_dim=32,
                 hidden=16, n_blocks=2, layers_per_block=2)
SMALL_LM = dict(name="m", family="ssm", n_layers=2, d_model=64, n_heads=1,
                n_kv_heads=1, d_ff=0, vocab_size=500, head_dim=64,
                tie_embeddings=True, ssm_state=16, ssm_head_dim=16,
                ssm_expand=2, ssm_chunk=16, ssm_groups=1, conv_width=4,
                norm_eps=1e-5, vocab_pad_to=256, param_dtype="float32",
                compute_dtype="float32")


def _program_cnn(m):
    from repro_torch.core.flat import FlatLayout
    from repro_torch.models.cnn import HistoCNN
    model = HistoCNN(growth=m["growth"], stem=m["stem"], feat_dim=m["feat_dim"],
                     hidden=m["hidden"], n_blocks=m["n_blocks"],
                     layers_per_block=m["layers_per_block"])
    return model, FlatLayout.of_module(model)


def test_cnn_paths_logits_and_loss_match_the_port():
    from repro_torch.models.cnn import bce_loss, forward_cnn, one_hot
    model, layout = _program_cnn(SMALL_CNN)
    p = cnn.init(SMALL_CNN, generator(3, 2, "cpu"), "cpu")
    assert sorted(p) == sorted(leaf.path for leaf in layout.leaves)
    assert {k: tuple(v.shape) for k, v in p.items()} == cnn.shapes(SMALL_CNN)
    x = torch.randn(6, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1, 2, 0, 1, 2])
    got = forward_cnn(model, layout.unflatten(layout.flatten(p)), x)
    want = cnn.logits(p, x, SMALL_CNN)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bce_loss(got, one_hot(y, 3)),
                               cnn.loss(p, (x, y), SMALL_CNN), rtol=1e-6,
                               atol=1e-6)


def test_mamba2_paths_and_loss_match_the_port():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build_model
    model = build_model(ModelConfig(**SMALL_LM))
    p = mamba2.init(SMALL_LM, generator(5, 2, "cpu"), "cpu", torch.float32)
    assert sorted(p) == sorted(leaf.path for leaf in model.layout.leaves)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 500, (2, 40), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = model.layout.flatten(p)
    got, _ = model.loss_fn(model.layout.unflatten(flat), batch, remat=False)
    torch.testing.assert_close(got, mamba2.loss(p, batch, SMALL_LM),
                               rtol=1e-5, atol=1e-5)


def test_ssd_matches_the_ports_plain_scan():
    from repro_torch.kernels.ref import ssd_scan_plain
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 64, 4, 8, generator=g)
    dt = torch.rand(2, 64, 4, generator=g) * 0.5
    a_log = torch.randn(4, generator=g)
    bm = torch.randn(2, 64, 2, 16, generator=g)
    cm = torch.randn(2, 64, 2, 16, generator=g)
    want, _ = ssd_scan_plain(x, dt, a_log, bm, cm, chunk=16)
    torch.testing.assert_close(mamba2.ssd(x, dt, a_log, bm, cm, 16), want,
                               rtol=1e-4, atol=1e-4)


def test_adamw_and_schedule_match_the_port():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_init, adamw_update, make_schedule
    tr = dict(lr=1e-3, warmup_steps=3, max_steps=10)
    tc = TrainConfig(lr=1e-3, warmup_steps=3, max_steps=10)
    sched = make_schedule(tc)
    for c in range(12):
        assert optim.lr_at(c, tr) == pytest.approx(float(sched(c)), rel=1e-6)
    g = torch.Generator().manual_seed(4)
    p = torch.randn(50, generator=g)
    state = adamw_init(p)
    ref = optim.AdamW({"w": p.clone()}, tr, lambda k, t: t)
    q = {"w": p.clone()}
    for _ in range(4):
        grad = torch.randn(50, generator=g) * 3
        p, state = adamw_update(p, grad, state, tc, sched(state["count"]))
        _, q = ref.step(q, {"w": grad})
    torch.testing.assert_close(p, q["w"], rtol=1e-5, atol=1e-6)


def test_auc_matches_the_ports_gate_metric():
    from repro_torch.metrics import macro_auc_traced
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 5, (40, 3)).astype(np.float32) / 4  # ties
    labels = rng.integers(0, 3, 40)
    got = float(macro_auc_traced(torch.from_numpy(probs),
                                 torch.from_numpy(labels)))
    assert cnn.macro_auc(probs, labels) == pytest.approx(got, abs=1e-6)


@pytest.mark.parametrize("topology", ["full", "ring"])
def test_mixing_matrix_matches_the_port(topology):
    from repro_torch.core.topology import build_matrix, fedavg_weights
    sizes = [200, 600, 600, 600]
    sw = dict(n_nodes=4, topology=topology, merge="fedavg", self_weight=0.5,
              wire_dtype="f32")
    want = build_matrix(topology, 4, weights=sizes if topology == "full"
                        else None, self_weight=0.5)
    np.testing.assert_allclose(mixing.mixing_matrix(sw, sizes), want)
    assert fedavg_weights(sizes).sum() == pytest.approx(1.0)


def test_rounding_policies():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(7))
    assert torch.equal(precision.round_to(x, "f32"), x)
    e16 = (precision.round_to(x, "bf16") - x).abs().max() / x.abs().max()
    e8 = (precision.round_to(x, "fp8") - x).abs().max() / x.abs().max()
    assert 0 < e16 < 2 ** -8 < e8 < 2 ** -3


@pytest.mark.parametrize("change", [dict(merge="fisher"),
                                    dict(wire_dtype="int8"),
                                    dict(topology="dynamic")])
def test_mixing_reference_refuses_what_it_cannot_compute(change):
    sw = dict(n_nodes=4, topology="ring", merge="fedavg", wire_dtype="f32",
              self_weight=0.5)
    assert mixing.refuse(sw) is None
    sw.update(change)
    assert mixing.refuse(sw)
    with pytest.raises(ValueError):
        mixing.mixing_matrix(sw, [1, 1, 1, 1])
