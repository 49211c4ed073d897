"""The yardstick's formulas against the numbers on record (PERF.md's
kernel table: the commit's bound 0.01566 ms at [4, 1,639,705] f32, the
SSD kernel's 0.0482 ms at Mamba2-370M's (1, 2048, 32, 64, 128, 256))."""
import pytest

from swarmbench import rates, work
from swarmbench.reference import cnn, mamba2


def test_commit_bound_matches_the_record():
    bw = rates.H100["hbm_bytes_per_s"]
    assert work.commit_bytes(4, 1_639_705) / bw * 1e3 == pytest.approx(
        0.01566, abs=5e-6)


def test_ssd_bound_matches_the_record():
    pk = rates.H100
    sec, by, _, _ = work.ssd_bound(1, 2048, 32, 64, 128, 256, 1,
                                   pk["hbm_bytes_per_s"], pk["float32"],
                                   pk["bfloat16"])
    assert sec * 1e3 == pytest.approx(0.0482, abs=5e-5)
    assert by == "operations"


PAPER = dict(image_size=224, n_classes=3, growth=32, stem=64, feat_dim=1152,
             hidden=512, n_blocks=4, layers_per_block=4)


def test_cnn_flops_and_params_at_paper_width():
    f = work.cnn_forward_flops(PAPER)
    assert f["total"] == pytest.approx(1.592e9, rel=1e-3)
    n = sum(int(__import__("math").prod(s)) for s in cnn.shapes(PAPER).values())
    assert n == 1_639_705


def test_mamba2_flops_per_token():
    m = dict(d_model=1024, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
             ssm_state=128, ssm_chunk=256, conv_width=4, n_layers=48,
             vocab_size=50280)
    per_token = mamba2.forward_flops(m, 2048) / 2048
    # about 2 x 368M params, plus the SSD scan's chunked work
    assert 7.5e8 < per_token < 8.5e8


def test_peaks_refuse_an_unknown_card():
    assert rates.peaks("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    with pytest.raises(RuntimeError):
        rates.peaks("NVIDIA A100-SXM4-80GB")


def test_trace_reduction_counts_overlaps_once_and_names_gaps():
    from swarmbench import trace
    dev = [(10, 30, "k1"), (20, 40, "k2"), (60, 70, "k1"), (95, 120, "k3")]
    host = [(0, 100, "swarmbench.rounds"), (40, 60, "aten::copy_"),
            (45, 50, "cudaLaunchKernel"), (70, 95, "aten::mm")]
    red = trace.reduce_events(dev, host, 0, 100)
    assert red["busy_s"] == pytest.approx((30 + 10 + 5) / 1e9)
    assert red["window_s"] == pytest.approx(100 / 1e9)
    assert red["kernels"]["k1"] == (2, pytest.approx(30 / 1e9))
    assert red["idle_gaps"][0] == ["aten::mm", pytest.approx(25 / 1e9)]
    assert [g[0] for g in red["idle_gaps"]] == ["aten::mm", "aten::copy_",
                                                "swarmbench.rounds"]
    assert red["device_ops"][0][0] == "k1"


def test_marked_trace_counts_between_the_markers_only():
    """The device-only trace's window runs from the first marker's start
    to the last's; the markers and what lies outside are no work."""
    import types

    import torch

    from swarmbench import trace
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(a, b, name, dev=cuda):
        return types.SimpleNamespace(
            start_ns=lambda: a, end_ns=lambda: b, name=lambda: name,
            device_type=lambda: dev, is_user_annotation=lambda: False)
    mark = f"at::cuda::(anonymous namespace)::{trace.MARKER}(long)"
    events = [ev(0, 5, "early"), ev(100, 101, mark),
              ev(110, 150, "k1"), ev(140, 160, "k2"),
              ev(120, 130, "cudaLaunchKernel", cpu),
              ev(200, 201, mark), ev(300, 310, "late")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    red = trace.reduce_marked(prof)
    assert red["window_s"] == pytest.approx(100 / 1e9)
    assert red["busy_s"] == pytest.approx(50 / 1e9)
    assert set(red["kernels"]) == {"k1", "k2"}
