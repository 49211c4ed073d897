"""The port's CUDA kernels (the f32 commit, the quantized-wire commit, the
fused LoRA matmul, the one-node commit, flash attention and the SSD scan)
against their plain versions, and the wrappers' dispatch, input checks and
(LoRA) gradient. Imports neither jax nor the reference, so it also runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py

Card-only cases skip without a CUDA device (decided inside the test)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import comms  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.kernels import fused_merge as fm  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ref import (attention_ref,  # noqa: E402
                                     flash_attention_plain,
                                     fused_merge_all_plain, fused_merge_ref,
                                     fused_quant_merge_all_plain,
                                     lora_matmul_plain, lora_matmul_ref,
                                     ssd_scan_plain, ssd_scan_ref)

torch.set_num_threads(2)
CASES = [(4, 100_003, torch.float32, False), (4, 100_003, torch.float32, True),
         (2, 512, torch.float32, False), (8, 4096, torch.float32, True),
         (64, 777, torch.float32, False), (64, 777, torch.float32, True),
         (5, 1000, torch.float32, True), (4, 2048, torch.bfloat16, False),
         (4, 2048, torch.bfloat16, True), (1, 1, torch.float32, False)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, d, dtype, with_imp, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32))
    W = torch.from_numpy(rng.dirichlet(np.ones(n), size=n).astype(np.float32))
    f = (torch.from_numpy(np.abs(rng.normal(1, 0.4, (n, d))).astype(np.float32))
         if with_imp else None)
    x = x.to(dtype)
    return (x.to(device), W.to(device),
            None if f is None else f.to(device), rng)


def test_plain_form_semantics_on_cpu():
    """out[i] = gate ? Σ_j W[i,j] θ_j : θ_i, and the ratio form."""
    x, W, f, _ = _inputs(3, 50, torch.float32, True, "cpu")
    g = torch.tensor([True, False, True])
    out = fm.fused_merge_all(x, W, g)
    np.testing.assert_allclose(out[0].numpy(), (W[0] @ x).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(out[1], x[1])
    out = fm.fused_merge_all(x, W, g, f)
    want = (W[2] @ (f * x)) / (W[2] @ f)
    np.testing.assert_allclose(out[2].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(out[1], x[1])


def test_cpu_tensor_never_counts_a_launch():
    x, W, _, _ = _inputs(4, 10, torch.float32, False, "cpu")
    before = dict(fm.LAUNCHES)
    fm.fused_merge_all(x, W, torch.ones(4, dtype=torch.bool))
    assert fm.LAUNCHES == before


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        fm.fused_merge_all(torch.zeros(8), torch.ones(1, 1), torch.ones(1))


@pytest.mark.parametrize("n,d,dtype,with_imp", CASES)
def test_kernel_matches_plain_on_card(n, d, dtype, with_imp):
    dev = _cuda()
    x, W, f, rng = _inputs(n, d, dtype, with_imp, dev, seed=n + d)
    for gates in (torch.ones(n, dtype=torch.bool),
                  torch.zeros(n, dtype=torch.bool),
                  torch.from_numpy(rng.random(n) > 0.5)):
        gates = gates.to(dev)
        before = fm.LAUNCHES["fused_merge_all_imp" if with_imp
                             else "fused_merge_all"]
        got = fm.fused_merge_all(x, W, gates, f)
        want = fused_merge_all_plain(x, W, gates, f)
        torch.cuda.synchronize()
        assert got.dtype == x.dtype and got.shape == x.shape
        # same arithmetic in the same order: equal bit for bit
        assert torch.equal(got, want)
        assert torch.equal(got[~gates], x[~gates])
        after = fm.LAUNCHES["fused_merge_all_imp" if with_imp
                            else "fused_merge_all"]
        assert after == before + 1


def test_kernel_input_checks_on_card():
    dev = _cuda()
    x, W, f, _ = _inputs(4, 100, torch.float32, True, dev)
    g = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_merge_all(x.t().contiguous().t(), W, g)
    with pytest.raises(TypeError, match="dtype"):
        fm.fused_merge_all(x.double(), W, g)
    with pytest.raises(ValueError, match="imp"):
        fm.fused_merge_all(x, W, g, f.double())
    with pytest.raises(ValueError, match="W must be"):
        fm.fused_merge_all(x, W[:2], g)
    big = torch.zeros(65, 8, device=dev)
    with pytest.raises(ValueError, match="N <= 64"):
        fm.fused_merge_all(big, torch.eye(65, device=dev),
                           torch.ones(65, dtype=torch.bool, device=dev))


# -- the quantized-wire commit ------------------------------------------------

# leaves off the 128 grid, so segments end at leaf boundaries, and a conv
# leaf whose blocks (HWIO order) are scattered over its OIHW storage
LAYOUT = FlatLayout([("b", (300,)), ("conv", (16, 8, 3, 3)), ("a", (6, 9)),
                     ("c", (3, 5, 2))], convs=["conv"])
# (N, layout, wire_block): the cases above on the 128 grid, then the paper
# CNN's own layout at the main path's 512 (the four 3x3 convs that cannot
# be cut are whole-leaf tiles over many blocks), a wide 1x1 conv, and at
# N = 64 a conv that cannot be cut: one tile of 122 segments, whose maxima
# (x 64 rows) fill nearly the most shared memory a maxima block takes,
# merged across many blocks
WIDE = FlatLayout([("w", (96, 40, 1, 1)), ("b", (96,))], convs=["w"])
BIG = FlatLayout([("conv", (32, 216, 3, 3)), ("bias", (32,))],
                 convs=["conv"])
QCASES = [(4, LAYOUT, 128), (4, 100_003, 128), (64, 777, 128),
          (5, LAYOUT, 128), (2, 128, 128), (4, "paper", 512),
          (5, WIDE, 512), (64, BIG, 512)]


def _paper_layout():
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.experiments import histo
    return FlatLayout.of_module(histo._model(PAPER_FULL))


def _quant_inputs(n, layout, wire, with_imp, device, seed=0, block=128):
    rng = np.random.default_rng(seed)
    d = layout.size if isinstance(layout, FlatLayout) else layout
    x = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 0.5, (n, d)).astype(np.float32))
    W = torch.from_numpy(rng.dirichlet(np.ones(n), size=n).astype(np.float32))
    f = (torch.from_numpy(np.abs(rng.normal(1, 0.4, (n, d))).astype(np.float32))
         if with_imp else None)
    grid = comms.wire_grid(layout, wire, block, device=device)
    return (x.to(device), r.to(device), W.to(device),
            None if f is None else f.to(device), grid, rng)


def test_quant_plain_form_semantics_on_cpu():
    """r' = r + deq(q(x − r)) on the grid; committed = gate ? W·r' : x."""
    x, r, W, _, grid, _ = _quant_inputs(4, LAYOUT, "int8", False, "cpu")
    g = torch.tensor([True, False, True, True])
    before = dict(fm.LAUNCHES)
    got, rp = fm.fused_quant_merge_all(x, r, W, g, grid=grid)
    assert fm.LAUNCHES == before
    assert torch.equal(rp, comms.wire_effective(x, r, grid))
    assert torch.equal(got[1], x[1])
    np.testing.assert_allclose(got[0].numpy(), (W[0] @ rp).numpy(), rtol=1e-6,
                               atol=1e-6)
    # the EF step transmits most of x − r: r' is within one int8 step of x
    assert float((rp - x).abs().max()) <= float((x - r).abs().max()) / 127
    xf, rf, Wf, _, fgrid, _ = _quant_inputs(4, 300, "f32", False, "cpu")
    _, rp32 = fm.fused_quant_merge_all(xf, rf, Wf, g, grid=fgrid)
    assert torch.equal(rp32, rf + (xf - rf))
    with pytest.raises(ValueError, match="grid covers"):
        fm.fused_quant_merge_all(xf, rf, Wf, g, grid=grid)


@pytest.mark.parametrize("wire", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("with_imp", [False, True])
@pytest.mark.parametrize("n,layout,block", QCASES,
                         ids=lambda v: "layout" if isinstance(v, FlatLayout)
                         else str(v))
def test_quant_kernel_matches_plain_on_card(n, layout, wire, with_imp, block):
    dev = _cuda()
    if layout == "paper":
        layout = _paper_layout()
    x, r, W, f, grid, rng = _quant_inputs(n, layout, wire, with_imp, dev,
                                          seed=n, block=block)
    name = "fused_quant_merge_all_imp" if with_imp else "fused_quant_merge_all"
    for gates in (torch.ones(n, dtype=torch.bool),
                  torch.zeros(n, dtype=torch.bool),
                  torch.from_numpy(rng.random(n) > 0.5)):
        gates = gates.to(dev)
        before = fm.LAUNCHES[name]
        got, rp = fm.fused_quant_merge_all(x, r, W, gates, f, grid=grid)
        want, wrp = fused_quant_merge_all_plain(x, r, W, gates, f, grid=grid)
        torch.cuda.synchronize()
        # same arithmetic in the same order: equal bit for bit
        assert torch.equal(rp, wrp)
        assert torch.equal(got, want)
        assert torch.equal(got[~gates], x[~gates])
        assert fm.LAUNCHES[name] == before + 1


def test_quant_kernel_input_checks_on_card():
    dev = _cuda()
    x, r, W, f, grid, _ = _quant_inputs(4, 1000, "int8", True, dev)
    g = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="r must be"):
        fm.fused_quant_merge_all(x, r.double(), W, g, grid=grid)
    with pytest.raises(ValueError, match="imp must be"):
        fm.fused_quant_merge_all(x, r, W, g, f[:, :10], grid=grid)
    with pytest.raises(ValueError, match="grid.segments"):
        fm.fused_quant_merge_all(
            x, r, W, g, grid=comms.wire_grid(1000, "int8", 128))


# -- the fused LoRA matmul ------------------------------------------------------

# (M, K, N, r, dtype): the zoo head's train, validation and test shapes, the
# reference's sweep shapes (tests/test_kernels.py), ragged edges, r = 128
LORA_CASES = [(8, 16, 16, 4, torch.float32), (20, 16, 16, 4, torch.float32),
              (160, 16, 16, 4, torch.float32),
              (128, 256, 128, 8, torch.float32),
              (256, 512, 384, 16, torch.float32),
              (128, 1024, 256, 64, torch.float32),
              (256, 256, 256, 16, torch.bfloat16),
              (37, 70, 45, 3, torch.float32), (33, 65, 31, 128, torch.float32),
              (37, 70, 45, 5, torch.bfloat16), (1, 1, 1, 1, torch.float32),
              # the small body's bounds (K <= 16, r <= 4, N <= 32) and one
              # step past each, several row blocks, bf16 at the zoo shape;
              # the large body with more column tiles than a cluster's 8,
              # and with fewer xa columns than blocks
              (64, 16, 32, 4, torch.float32), (300, 16, 16, 4, torch.float32),
              (8, 16, 16, 4, torch.bfloat16), (64, 17, 16, 4, torch.float32),
              (64, 16, 33, 4, torch.float32), (64, 16, 16, 5, torch.float32),
              (40, 64, 600, 8, torch.float32), (37, 70, 300, 3, torch.float32)]


def _lora_tol(dtype):
    # the reference's _tol (tests/test_kernels.py)
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _lora_inputs(m, k, n, r, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(0, 1, shape) * scale).astype(np.float32)).to(
                device=device, dtype=dtype)

    return (t(m, k), t(k, n, scale=k ** -0.5), t(k, r, scale=k ** -0.5),
            t(r, n, scale=r ** -0.5),
            torch.tensor(1.5, dtype=torch.float32, device=device))


def test_lora_plain_form_semantics_on_cpu():
    """y = x@W + s·(x@A)@B; the plain form rounds x@A to x's dtype, the
    oracle does not (they agree for f32); a CPU call counts no launch."""
    x, w, a, b, s = _lora_inputs(9, 12, 7, 3, torch.float32, "cpu")
    before = dict(lm.LAUNCHES)
    got = lm.lora_matmul(x, w, a, b, s)
    assert lm.LAUNCHES == before
    want = x.double() @ w.double() + 1.5 * (x.double() @ a.double()) @ b.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, lora_matmul_plain(x, w, a, b, s))
    np.testing.assert_allclose(got.numpy(),
                               lora_matmul_ref(x, w, a, b, s).numpy(),
                               rtol=1e-6, atol=1e-6)
    xb, wb, ab, bb, _ = (v.to(torch.bfloat16) if v.dim() else v
                         for v in (x, w, a, b, s))
    xa = (xb.float() @ ab.float()).to(torch.bfloat16).float()
    want_b = (xb.float() @ wb.float() + 1.5 * (xa @ bb.float())).to(
        torch.bfloat16)
    assert torch.equal(lm.lora_matmul(xb, wb, ab, bb, s), want_b)


def test_lora_wrapper_rejects_bad_shapes():
    x, w, a, b, s = _lora_inputs(4, 6, 5, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="2-D"):
        lm.lora_matmul(x[0], w, a, b, s)
    with pytest.raises(ValueError, match="compose"):
        lm.lora_matmul(x, w, a, b.T.contiguous(), s)


def _lora_grads(fn, x, w, a, b, s, gy):
    return torch.func.grad(lambda *v: (fn(*v) * gy).sum(),
                           argnums=(0, 1, 2, 3, 4))(x, w, a, b, s)


def test_lora_apply_gradient_on_cpu():
    """The autograd Function's backward against autograd through the plain
    form, for every input."""
    x, w, a, b, s = _lora_inputs(7, 9, 5, 3, torch.float32, "cpu")
    gy = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (7, 5)).astype(np.float32))
    got = _lora_grads(lm.lora_apply, x, w, a, b, s, gy)
    want = _lora_grads(lora_matmul_plain, x, w, a, b, s, gy)
    for g, h in zip(got, want):
        assert g.shape == h.shape and g.dtype == h.dtype
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,k,n,r,dtype", LORA_CASES)
def test_lora_kernel_matches_plain_on_card(m, k, n, r, dtype):
    dev = _cuda()
    x, w, a, b, s = _lora_inputs(m, k, n, r, dtype, dev, seed=m + k + r)
    before = lm.LAUNCHES["lora_matmul"]
    got = lm.lora_matmul(x, w, a, b, s)
    want = lora_matmul_plain(x, w, a, b, s)
    torch.cuda.synchronize()
    assert lm.LAUNCHES["lora_matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_lora_tol(dtype))
    # zero B: exactly the base product's f32 sum
    zb = lm.lora_matmul(x, w, a, torch.zeros_like(b), s)
    np.testing.assert_allclose(zb.float().cpu().numpy(),
                               (x.float() @ w.float()).to(dtype).float()
                               .cpu().numpy(), **_lora_tol(dtype))


def test_lora_kernel_gradient_on_card():
    """grad_and_value through the Function on the card (the forward gets
    plain tensors and launches the kernel) against autograd through the
    plain form, at 1e-5."""
    dev = _cuda()
    x, w, a, b, s = _lora_inputs(20, 16, 16, 4, torch.float32, dev, seed=3)
    gy = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (20, 16)).astype(np.float32)).to(dev)
    before = lm.LAUNCHES["lora_matmul"]
    got = _lora_grads(lm.lora_apply, x, w, a, b, s, gy)
    assert lm.LAUNCHES["lora_matmul"] == before + 1
    want = _lora_grads(lora_matmul_plain, x, w, a, b, s, gy)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), h.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_lora_kernel_input_checks_on_card():
    dev = _cuda()
    x, w, a, b, s = _lora_inputs(8, 16, 16, 4, torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lora_matmul(x.t().contiguous().t(), w, a, b, s)
    with pytest.raises(TypeError, match="dtype"):
        lm.lora_matmul(x.double(), w.double(), a.double(), b.double(), s)
    with pytest.raises(ValueError, match="W must be"):
        lm.lora_matmul(x, w.to(torch.bfloat16), a, b, s)
    big = torch.zeros(16, 129, device=dev)
    with pytest.raises(ValueError, match="rank"):
        lm.lora_matmul(x, w, big, torch.zeros(129, 16, device=dev), s)


# -- the one-node commit ------------------------------------------------------

def test_merge_one_plain_semantics_on_cpu():
    x, _, _, rng = _inputs(5, 300, torch.float32, False, "cpu")
    w = torch.from_numpy(rng.dirichlet(np.ones(5)).astype(np.float32))
    before = dict(fm.LAUNCHES)
    for gate in (True, False, torch.tensor(True)):
        got = fm.fused_merge(x, w, 3, gate)
        want = w @ x if bool(gate) else x[3]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(fm.fused_merge(x, w, torch.tensor(3), False), x[3])
    assert fm.LAUNCHES == before
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        fm.fused_merge(torch.zeros(8), w, 0, True)


@pytest.mark.parametrize("n,d,dtype", [(4, 100_003, torch.float32),
                                       (64, 777, torch.float32),
                                       (4, 2048, torch.bfloat16),
                                       (1, 1, torch.float32)])
def test_merge_one_kernel_matches_plain_on_card(n, d, dtype):
    dev = _cuda()
    x, _, _, rng = _inputs(n, d, dtype, False, dev, seed=n + d)
    w = torch.from_numpy(rng.dirichlet(np.ones(n)).astype(np.float32)).to(dev)
    for gate in (True, False, torch.tensor(True, device=dev)):
        before = fm.LAUNCHES["fused_merge"]
        got = fm.fused_merge(x, w, n - 1, gate)
        want = fused_merge_ref(x, w, n - 1, gate)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["fused_merge"] == before + 1
        assert got.dtype == dtype and got.shape == (d,)
        assert torch.equal(got, want)        # the same arithmetic, in order
    assert torch.equal(fm.fused_merge(x, w, 0, False), x[0])
    # self_idx and gate by value (Python) and read on the device (0-d)
    for gate in (False, torch.tensor(False, device=dev)):
        for idx in (n - 1, torch.tensor(n - 1, device=dev)):
            assert torch.equal(fm.fused_merge(x, w, idx, gate), x[n - 1])
    with pytest.raises(ValueError, match="self_idx"):
        fm.fused_merge(x, w, n, True)


# -- flash attention ----------------------------------------------------------

# (B, H, Hkv, S, T, D, causal, window, dtype): the reference's sweep, the
# bf16 case, ragged S and T (a prompt in a deeper cache), D = 32, bf16
# without the causal mask; then the moe, vlm and enc-dec models' shapes:
# granite-moe's GQA group of 3 (24/8 heads), internvl2's group of 7 (14/2)
# and seamless's bidirectional encoder at S = T = 1024 (16/16); then head
# dim 16 (the engine example's model, d_model 64 over 4 heads, 2 KV heads):
# its training shape (the node axis folded into the batch), GQA with a
# window and a ragged T, and without the causal mask, in f32 and bf16
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True, 0, torch.float32),
    (2, 4, 2, 256, 256, 64, True, 0, torch.float32),
    (1, 8, 2, 256, 256, 64, True, 64, torch.float32),
    (1, 4, 1, 128, 128, 128, True, 0, torch.float32),
    (2, 2, 2, 128, 128, 64, False, 0, torch.float32),
    (1, 2, 2, 128, 128, 64, True, 0, torch.bfloat16),
    (1, 5, 1, 100, 133, 64, True, 0, torch.float32),
    (2, 6, 3, 77, 77, 32, True, 20, torch.float32),
    (1, 25, 5, 200, 211, 64, True, 64, torch.bfloat16),
    (2, 4, 2, 150, 170, 64, False, 0, torch.bfloat16),
    (1, 24, 8, 256, 272, 64, True, 0, torch.bfloat16),
    (2, 14, 2, 300, 300, 64, True, 0, torch.bfloat16),
    (2, 16, 16, 1024, 1024, 64, False, 0, torch.bfloat16),
    (32, 4, 2, 32, 32, 16, True, 0, torch.float32),
    (2, 6, 3, 77, 90, 16, True, 20, torch.float32),
    (2, 4, 2, 150, 170, 16, False, 0, torch.float32),
    (1, 4, 2, 2048, 2048, 16, True, 64, torch.float32),
    (32, 4, 2, 32, 32, 16, True, 0, torch.bfloat16),
    (2, 6, 3, 77, 90, 16, True, 20, torch.bfloat16),
    (2, 4, 2, 150, 170, 16, False, 0, torch.bfloat16)]


def _flash_tol(dtype):
    # the reference's sweep tolerances (tests/test_kernels.py)
    return (dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _flash_inputs(b, h, hkv, s, t, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    def f(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dtype).to(device)

    return f(b, h, s, d), f(b, hkv, t, d), f(b, hkv, t, d)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_plain_semantics_on_cpu(d):
    """At every head dim the kernel takes (16: d_model 64 over 4 heads), on
    a CPU tensor the wrapper and the differentiable entry point compute the
    plain version and count no launch."""
    q, k, v = _flash_inputs(1, 4, 2, 24, 24, d, torch.float32, "cpu")
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, window=5)
    assert torch.equal(got, attention_ref(q, k, v, window=5))
    # one query row by hand: GQA head 3 reads KV head 1, window of 5 keys
    i = 10
    sc = (q[0, 3, i] @ k[0, 1, i - 4:i + 1].T) / math.sqrt(d)
    want = torch.softmax(sc, -1) @ v[0, 1, i - 4:i + 1]
    np.testing.assert_allclose(got[0, 3, i].numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)
    # a window at least as long as the sequence is full causal attention
    torch.testing.assert_close(fa.flash_attention(q, k, v, window=24),
                               fa.flash_attention(q, k, v), rtol=1e-6,
                               atol=1e-6)
    # GQA 2:1 with a ragged T, causal, windowed and without the mask
    q, k, v = _flash_inputs(2, 6, 3, 19, 23, d, torch.float32, "cpu",
                            seed=d)
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        want = attention_ref(q, k, v, causal=causal, window=window)
        assert torch.equal(fa.flash_attention(q, k, v, causal=causal,
                                              window=window), want)
        assert torch.equal(fa.flash_apply(q, k, v, causal=causal,
                                          window=window), want)
    assert fa.LAUNCHES == before
    with pytest.raises(ValueError, match="causal"):
        flash_attention_plain(q, k, v, causal=False, window=3)
    with pytest.raises(ValueError, match="compose"):
        fa.flash_attention(q, k[:, :, :, :8], v[:, :, :, :8])


@pytest.mark.parametrize("b,h,hkv,s,t,d,causal,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(b, h, hkv, s, t, d, causal,
                                            window, dtype):
    dev = _cuda()
    q, k, v = _flash_inputs(b, h, hkv, s, t, d, dtype, dev, seed=s + t)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_flash_tol(dtype))


def test_flash_kernel_takes_strided_views_on_card():
    """q as [B,S,H,D] and K/V as a [B,T,Hkv,D] cache, passed transposed
    (no copy), give what the contiguous tensors give."""
    dev = _cuda()
    q, k, v = _flash_inputs(2, 4, 2, 70, 90, 64, torch.float32, dev, seed=7)
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    ks = k.transpose(1, 2).contiguous().transpose(1, 2)
    vs = v.transpose(1, 2).contiguous().transpose(1, 2)
    got = fa.flash_attention(qs, ks, vs, window=16)
    want = fa.flash_attention(q, k, v, window=16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_flash_kernel_input_checks_on_card():
    dev = _cuda()
    q, k, v = _flash_inputs(1, 2, 2, 16, 16, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="must be a"):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    q48, k48, v48 = _flash_inputs(1, 2, 2, 16, 16, 48, torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q48, k48, v48)
    q8, k8, v8 = _flash_inputs(1, 2, 2, 16, 16, 8, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q8, k8, v8)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, v, causal=False, window=4)


# (H, Hkv, S, T, D, window) in bf16 at the model's tolerance: Hymba's
# prefill shapes at both served prompt lengths (S and T not multiples of
# the 192-row / 64-key tiles), a window edge inside a tile, GQA groups of
# 1, 5 and 8, D of 16, 32, 64 and 128 (D = 16: the engine example's heads
# at a long prompt, causal and windowed, and GQA groups of 2 and 3 with
# ragged S and T)
FLASH_BF16_CASES = [(25, 5, 200, 2064, 64, 0), (25, 5, 2048, 2064, 64, 0),
                    (25, 5, 2048, 2064, 64, 1024), (25, 5, 256, 2064, 64, 0),
                    (25, 5, 256, 2064, 64, 1024), (8, 8, 300, 300, 64, 100),
                    (10, 2, 333, 400, 32, 100), (40, 5, 256, 300, 128, 0),
                    (16, 2, 130, 130, 128, 100), (5, 1, 77, 90, 32, 0),
                    (4, 2, 2048, 2048, 16, 0), (4, 2, 2048, 2048, 16, 64),
                    (6, 3, 333, 400, 16, 100), (4, 2, 77, 90, 16, 0)]


@pytest.mark.parametrize("h,hkv,s,t,d,window", FLASH_BF16_CASES)
def test_flash_bf16_within_one_ulp_on_card(h, hkv, s, t, d, window):
    """Both sides work in f32 on the same bf16 inputs and round once, so
    they differ by at most one bf16 ulp (atol 2e-4, rtol 8e-3, as
    chip_smoke holds Hymba's shape). The first rows of a causal prefill
    average a few keys, where a P rounded to bf16 would miss: they are
    checked on their own."""
    dev = _cuda()
    q, k, v = _flash_inputs(1, h, hkv, s, t, d, torch.bfloat16, dev,
                            seed=s + d + window)
    got = fa.flash_attention(q, k, v, window=window).float().cpu()
    want = flash_attention_plain(q, k, v, window=window).float().cpu()
    tol = dict(atol=2e-4, rtol=8e-3)
    np.testing.assert_allclose(got[:, :, :4].numpy(),
                               want[:, :, :4].numpy(), **tol)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_flash_kernel_deterministic_on_card():
    """Two calls on the same inputs give the same bits, in both forms."""
    dev = _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _flash_inputs(1, 25, 5, 300, 2064, 64, dtype, dev, seed=3)
        a = fa.flash_attention(q, k, v, window=100)
        b = fa.flash_attention(q, k, v, window=100)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_flash_bf16_rejects_unaligned_rows_on_card():
    dev = _cuda()
    q, k, v = _flash_inputs(1, 2, 2, 16, 17, 64, torch.bfloat16, dev)
    k1 = torch.zeros(1, 2, 17 * 64 + 1, dtype=torch.bfloat16,
                     device=dev)[..., 1:].view(1, 2, 17, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k1, v)


# -- the SSD scan ---------------------------------------------------------------

# (B, S, H, P, N, chunk, G, dtype): the reference's sweep, a group
# broadcast, a short final chunk count, bf16
SSD_CASES = [(1, 64, 2, 32, 16, 16, 2, torch.float32),
             (2, 128, 3, 32, 16, 32, 3, torch.float32),
             (1, 256, 4, 64, 128, 64, 4, torch.float32),
             (2, 96, 2, 32, 8, 32, 2, torch.float32),
             (1, 512, 6, 64, 16, 256, 1, torch.float32),
             (1, 48, 4, 16, 8, 24, 2, torch.float32),
             (1, 256, 5, 64, 16, 128, 1, torch.bfloat16),
             # one chunk (Hymba's 256-token prefill), sixteen chunks,
             # G < H, Mamba2's N = 128 in bf16
             (1, 256, 50, 64, 16, 256, 1, torch.bfloat16),
             (1, 256, 8, 64, 16, 256, 1, torch.bfloat16),
             (1, 4096, 4, 64, 16, 256, 1, torch.bfloat16),
             (2, 512, 8, 64, 16, 128, 2, torch.bfloat16),
             (1, 512, 4, 64, 128, 256, 1, torch.bfloat16),
             (1, 512, 6, 32, 64, 256, 3, torch.float32)]


def _ssd_tol(dtype):
    # the reference's 1e-4 for f32; bf16 outputs hold 8 bits
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-4, atol=1e-4))


def _ssd_inputs(b, s, h, p, n, g, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = t(rng.normal(0, 1, (b, s, h, p))).to(dtype)
    dt = t(np.abs(rng.normal(0.1, 0.05, (b, s, h))))
    alog = t(np.log(np.linspace(1, 8, h)))
    bm = t(rng.normal(0, 0.5, (b, s, g, n))).to(dtype)
    cm = t(rng.normal(0, 0.5, (b, s, g, n))).to(dtype)
    return x, dt, alog, bm, cm


def test_ssd_plain_semantics_on_cpu():
    """The chunked plain version against the exact sequential recurrence,
    B/C per group against the reference's pre-broadcast form."""
    x, dt, alog, bm, cm = _ssd_inputs(2, 48, 4, 8, 6, 2, torch.float32, "cpu")
    before = dict(ss.LAUNCHES)
    y, st = ss.ssd_scan(x, dt, alog, bm, cm, chunk=16)
    assert ss.LAUNCHES == before
    def rep(t):
        return t.repeat_interleave(2, dim=2)

    yr, sr = ssd_scan_ref(x, dt, alog, rep(bm), rep(cm))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), sr.numpy(), rtol=1e-4, atol=1e-4)
    yb, sb = ssd_scan_plain(x, dt, alog, rep(bm), rep(cm), chunk=16)
    assert torch.equal(y, yb) and torch.equal(st, sb)
    with pytest.raises(ValueError, match="divide"):
        ss.ssd_scan(x, dt, alog, bm, cm, chunk=20)
    with pytest.raises(ValueError, match="compose"):
        ss.ssd_scan(x, dt, alog, bm[:, :, :1].expand(2, 48, 3, 6).contiguous()
                    [:, :, :3], cm[:, :, :1].expand(2, 48, 3, 6)
                    .contiguous(), chunk=16)


@pytest.mark.parametrize("b,s,h,p,n,chunk,g,dtype", SSD_CASES)
def test_ssd_kernel_matches_plain_on_card(b, s, h, p, n, chunk, g, dtype):
    dev = _cuda()
    x, dt, alog, bm, cm = _ssd_inputs(b, s, h, p, n, g, dtype, dev, seed=s)
    before = ss.LAUNCHES["ssd_scan"]
    y, st = ss.ssd_scan(x, dt, alog, bm, cm, chunk=chunk)
    yw, sw = ssd_scan_plain(x, dt, alog, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yw.float().cpu().numpy(), **_ssd_tol(dtype))
    # the final state is f32 on both sides, whatever x's dtype
    np.testing.assert_allclose(st.cpu().numpy(), sw.cpu().numpy(),
                               **_ssd_tol(torch.float32))


def test_ssd_kernel_takes_strided_views_on_card():
    """x, B and C as column slices of one [B, S, C] buffer (the module's
    split of its conv output) give what contiguous copies give."""
    dev = _cuda()
    b, s, h, p, n = 1, 128, 4, 32, 16
    buf = torch.randn(b, s, h * p + 2 * n, device=dev)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm = buf[..., h * p:h * p + n].reshape(b, s, 1, n)
    cm = buf[..., h * p + n:].reshape(b, s, 1, n)
    dt = torch.rand(b, s, h, device=dev) * 0.2
    alog = torch.zeros(h, device=dev)
    got = ss.ssd_scan(x, dt, alog, bm, cm, chunk=64)
    want = ss.ssd_scan(x.contiguous(), dt, alog, bm.contiguous(),
                       cm.contiguous(), chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_kernel_input_checks_on_card():
    dev = _cuda()
    x, dt, alog, bm, cm = _ssd_inputs(1, 32, 2, 16, 8, 1, torch.float32, dev)
    with pytest.raises(ValueError, match="dt"):
        ss.ssd_scan(x, dt.double(), alog, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, alog,
                    bm, cm, chunk=16)
    with pytest.raises(TypeError, match="dtype"):
        ss.ssd_scan(x.double(), dt, alog, bm.double(), cm.double(), chunk=16)
    xb, dtb, alb, bmb, cmb = _ssd_inputs(1, 32, 2, 160, 8, 1, torch.float32,
                                         dev)
    with pytest.raises(ValueError, match="range"):
        ss.ssd_scan(xb, dtb, alb, bmb, cmb, chunk=16)


@pytest.mark.parametrize("n", [16, 12])
def test_ssd_kernel_on_conv_output_views_on_card(n):
    """x, B and C as column slices of one bf16 [B, S, H·P + 2·G·N] buffer
    (the module's split of its conv output) against the plain version;
    N = 12 leaves B and C rows off 16-byte alignment, so their tiles are
    loaded element by element."""
    dev = _cuda()
    b, s, h, p, g, chunk = 1, 512, 8, 64, 1, 256
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.normal(0, 0.5, (b, s, h * p + 2 * g * n))
                           .astype(np.float32)).to(torch.bfloat16).to(dev)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = buf[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.from_numpy(np.abs(rng.normal(0.1, 0.05, (b, s, h)))
                          .astype(np.float32)).to(dev)
    alog = torch.log(torch.linspace(1, 8, h, device=dev))
    y, st = ss.ssd_scan(x, dt, alog, bm, cm, chunk=chunk)
    yw, sw = ssd_scan_plain(x, dt, alog, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yw.float().cpu().numpy(),
                               **_ssd_tol(torch.bfloat16))
    np.testing.assert_allclose(st.cpu().numpy(), sw.cpu().numpy(),
                               **_ssd_tol(torch.float32))


def test_ssd_kernel_deterministic_on_card():
    """Two calls on the same inputs give the same bits, in both forms."""
    dev = _cuda()
    for dtype in (torch.bfloat16, torch.float32):
        args = _ssd_inputs(1, 1024, 8, 64, 16, 1, dtype, dev, seed=5)
        y1, s1 = ss.ssd_scan(*args, chunk=256)
        y2, s2 = ss.ssd_scan(*args, chunk=256)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(s1, s2)


# ---------------------------------------------------------------------------
# the flash and SSD autograd Functions (the LM trainer's path)
# ---------------------------------------------------------------------------

def _fn_inputs(device, dtype=torch.float32, n=3, seed=0):
    """Per-node flash (q, k, v) and SSD (x, dt, a_log, B, C) inputs with a
    leading node axis of ``n``; a_log differs per node."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(0, scale, shape))
                                .astype(np.float32)).to(device)

    b, h, hkv, s, d = 2, 4, 2, 64, 64
    flash = (t(n, b, h, s, d).to(dtype), t(n, b, hkv, s, d).to(dtype),
             t(n, b, hkv, s, d).to(dtype))
    sh, p, st = 4, 32, 16
    ssd = (t(n, b, s, sh, p).to(dtype),
           torch.nn.functional.softplus(t(n, b, s, sh)),
           t(n, sh, scale=0.5), t(n, b, s, 1, st).to(dtype),
           t(n, b, s, 1, st).to(dtype))
    return flash, ssd


def _fn_grads(flash_fn, ssd_fn, flash, ssd, window=16, chunk=32):
    """vmap(grad) over the node axis of a linear loss (fixed weights, so
    the gradients do not depend on the forward's rounding) through each
    function."""
    gen = torch.Generator(device=flash[0].device).manual_seed(1)

    def weights(*shape):
        return torch.randn(shape, generator=gen, device=flash[0].device)

    n, b, h, s, d = flash[0].shape
    wf = weights(b, h, s, d)
    x = ssd[0]
    wy, ws = weights(*x.shape[1:]), weights(b, x.shape[3], x.shape[4],
                                             ssd[3].shape[-1])

    def fl(q, k, v):
        out = flash_fn(q, k, v, causal=True, window=window)
        return torch.sum(out.float() * wf)

    def sl(x, dt, a_log, bm, cm):
        y, state = ssd_fn(x, dt, a_log, bm, cm, chunk=chunk)
        return torch.sum(y.float() * wy) + torch.sum(state * ws)

    gf = torch.func.vmap(torch.func.grad(fl, argnums=(0, 1, 2)))(*flash)
    gs = torch.func.vmap(torch.func.grad(sl, argnums=(0, 1, 2, 3, 4)))(*ssd)
    return gf, gs


def test_kernel_functions_grad_matches_plain_autograd_on_cpu():
    """On CPU tensors the Functions' plain backwards under vmap(grad) equal
    autograd through the plain versions (flash 1e-5: its backward's f32
    formulas round differently; SSD bit for bit: the same recomputation)."""
    flash, ssd = _fn_inputs("cpu")
    before = dict(ss.LAUNCHES)
    gf, gs = _fn_grads(fa.flash_apply, ss.ssd_apply, flash, ssd)
    assert ss.LAUNCHES == before
    wf, ws = _fn_grads(flash_attention_plain, ssd_scan_plain, flash, ssd)
    for got, want in zip(gf, wf):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for got, want in zip(gs, ws):
        assert torch.equal(got, want)


def test_ssd_takes_a_log_per_batch_row_on_cpu():
    """a_log [B, H] gives row b what a_log[b] alone gives it; [H] is every
    row's."""
    x, dt, alog, bm, cm = _ssd_inputs(3, 32, 4, 8, 6, 1, torch.float32,
                                      "cpu")
    rows = torch.stack([alog, alog * 0.5, alog + 0.3])
    y, st = ss.ssd_scan(x, dt, rows, bm, cm, chunk=16)
    for i in range(3):
        yi, si = ss.ssd_scan(x[i:i + 1], dt[i:i + 1], rows[i], bm[i:i + 1],
                             cm[i:i + 1], chunk=16)
        assert torch.equal(y[i:i + 1], yi) and torch.equal(st[i:i + 1], si)
    with pytest.raises(ValueError, match="compose"):
        ss.ssd_scan(x, dt, rows[:2], bm, cm, chunk=16)


def test_flat_layout_parts_and_values():
    """A wide layout: the parts are views of the slots, join inverts them,
    values/from_values round-trip, the value vector unflattens to the
    slots' leaves, and a loss over unflatten_parts reaches both parts."""
    layout = FlatLayout([("a", (3,)), ("b", (2, 2)), ("c", (5,))],
                        wide=("a",))
    assert (layout.n_wide, layout.n_rest, layout.n_values) == (3, 9, 12)
    assert layout.size == 16 and layout.pad == 1
    vals = torch.arange(12, dtype=torch.float32) / 7
    flat = layout.from_values(vals, torch.bfloat16)
    assert flat.shape == (16,) and flat.dtype == torch.bfloat16
    wide, rest = layout.parts(flat)
    assert wide.dtype == torch.float32 and torch.equal(wide, vals[:3])
    assert torch.equal(layout.join((wide, rest)), flat)
    back = layout.values(flat)
    assert torch.equal(back[:3], vals[:3])
    assert torch.equal(back[3:], vals[3:].to(torch.bfloat16).float())
    assert torch.equal(layout.from_values(back, torch.bfloat16), flat)
    by_slots, by_values = layout.unflatten(flat), layout.unflatten(back)
    for path in by_slots:
        assert torch.equal(by_slots[path].float(), by_values[path])
    assert [lf.path for lf in layout.value_layout.leaves] == ["a", "b", "c"]
    g = torch.func.grad(lambda parts: sum(
        v.float().sum() * (i + 1) for i, v in enumerate(
            layout.unflatten_parts(parts).values())))((wide, rest))
    assert torch.equal(g[0], torch.ones(3))
    assert torch.equal(g[1], torch.tensor([2.0] * 4 + [3.0] * 5).to(
        torch.bfloat16))
    plain = FlatLayout([("a", (3,)), ("c", (5,))])
    f32 = torch.arange(8, dtype=torch.float32)
    assert plain.value_layout is plain and plain.parts(f32)[0] is f32
    assert plain.values(f32) is f32


def test_adamw_over_parts_updates_each_part_in_its_dtype():
    """AdamW over (f32 prefix, bf16 rest) parts: moments over the values,
    the prefix updated as f32 numbers, the rest in f32 and cast back, the
    clipping norm over both, as the reference's per-leaf update."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw_init, adamw_update
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.normal(0, 1, 5).astype(np.float32))
    rest = torch.from_numpy(rng.normal(0, 1, 7).astype(np.float32)).to(
        torch.bfloat16)
    gw = torch.from_numpy(rng.normal(0, 3, 5).astype(np.float32))
    gr = torch.from_numpy(rng.normal(0, 3, 7).astype(np.float32)).to(
        torch.bfloat16)
    cfg = TrainConfig(grad_clip=1.0)
    state = adamw_init((wide, rest))
    assert state["mu"].shape == (12,)
    (nw, nr), st = adamw_update((wide, rest), (gw, gr), state, cfg, 1e-2)
    assert nw.dtype == torch.float32 and nr.dtype == torch.bfloat16
    norm = torch.sqrt((gw ** 2).sum() + (gr.float() ** 2).sum())
    scale = min(1.0, 1.0 / float(norm))
    g = torch.cat([gw * scale, (gr.float() * scale).to(torch.bfloat16)
                   .float()])
    p = torch.cat([wide, rest.float()])
    mu, nu = 0.1 * g, 0.05 * g * g
    step = (mu / 0.1) / (torch.sqrt(nu / 0.05) + cfg.eps)
    want = p - 1e-2 * (step + cfg.weight_decay * p)
    torch.testing.assert_close(nw, want[:5], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(nr, want[5:].to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(st["mu"], mu, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_functions_grad_on_card(dtype):
    """On the card, vmap(grad) through the Functions launches the kernels
    (one call per vmapped forward, the node axis folded into the batch)
    and gives the plain versions' autograd gradients: f32 at 1e-4, bf16 at
    the kernels' bf16 output tolerances."""
    dev = _cuda()
    flash, ssd = _fn_inputs(dev, dtype)
    before = dict(ss.LAUNCHES)
    gf, gs = _fn_grads(fa.flash_apply, ss.ssd_apply, flash, ssd)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ss.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    wf, ws = _fn_grads(flash_attention_plain, ssd_scan_plain, flash, ssd)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=5e-2, atol=5e-2))
    for got, want in list(zip(gf, wf)) + list(zip(gs, ws)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


def test_kernel_functions_vmap_fold_equals_node_loop_on_card():
    """The vmap rules' folded launch (a_log per batch row for the SSD)
    gives each node what its own launch gives, bit for bit."""
    dev = _cuda()
    for dtype in (torch.float32, torch.bfloat16):
        flash, ssd = _fn_inputs(dev, dtype, seed=3)
        with torch.no_grad():
            fo = torch.func.vmap(lambda q, k, v: fa.flash_apply(
                q, k, v, causal=True, window=16))(*flash)
            so = torch.func.vmap(lambda *a: ss.ssd_apply(*a, chunk=32))(*ssd)
            for i in range(3):
                f1 = fa.flash_attention(*(t[i] for t in flash), causal=True,
                                        window=16)
                s1 = ss.ssd_scan(*(t[i] for t in ssd), chunk=32)
                assert torch.equal(fo[i], f1)
                assert torch.equal(so[0][i], s1[0])
                assert torch.equal(so[1][i], s1[1])


def test_kernel_wrappers_refuse_wrapped_tensors_on_card():
    """Called directly inside torch.func.grad, the wrappers raise instead of
    reading a wrapped tensor's storage; the Functions unwrap."""
    dev = _cuda()
    flash, ssd = _fn_inputs(dev)
    q, k, v = (t[0] for t in flash)
    with pytest.raises(TypeError, match="flash_apply"):
        torch.func.grad(lambda q: fa.flash_attention(q, k, v).sum())(q)
    x, dt, alog, bm, cm = (t[0] for t in ssd)
    with pytest.raises(TypeError, match="ssd_apply"):
        torch.func.grad(lambda x: ss.ssd_scan(x, dt, alog, bm, cm,
                                              chunk=32)[0].sum())(x)


@pytest.mark.parametrize("merge,name", [("fedavg", "fused_merge_all"),
                                        ("fisher", "fused_merge_all_imp")])
def test_host_loop_commits_through_one_launch_a_sync(merge, name):
    """The host backend's commit (`core.swarm`, ``SwarmEngine.
    commit_host``) on the card: one ``fused_merge_all`` launch a sync, in
    the plain form for fedavg and the importance form for fisher."""
    dev = _cuda()
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.core.session import SwarmSession
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = SwarmConfig(n_nodes=4, sync_every=2, topology="ring", merge=merge,
                      lora_only=False, val_threshold=0.0)
    sess = SwarmSession(cfg, lambda p, o, b, s: (p - 0.1 * (p - b), o, {}),
                        lambda p, v: float(torch.sigmoid(p.mean())),
                        params=torch.zeros(1000), backend="host", device=dev)
    targets = [torch.full((1000,), float(i), device=dev) for i in range(4)]
    reset_launches()
    for _ in range(3):
        sess.round([targets] * 2, [1] * 4)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {name: 3}


def test_remat_step_launches_each_kernel_twice_a_layer():
    """A Hymba smoke train step on the card: one flash and one SSD launch a
    layer without remat, two with it (the forward and the recompute; the
    Functions' own backwards are plain PyTorch), the same loss, and the
    same gradient: AdamW's first moment (0.1·g) of every leaf within 1e-3
    of the leaf's largest magnitude, as the card-vs-CPU train parity holds
    it."""
    dev = _cuda()
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import build_model

    model = build_model(smoke_variant(get_config("hymba-1.5b")))
    layers = model.cfg.n_layers
    p, o = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                            dev)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 65), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses, mu = {}, {}
    for remat, per_layer in ((False, 1), (True, 2)):
        step = make_train_step(model, TrainConfig(remat=remat))
        reset_launches()
        _, o2, m = step(p.clone(), {k: v.clone() for k, v in o.items()},
                        batch)
        torch.cuda.synchronize()
        assert {k: v for k, v in LAUNCHES.items() if v} == {
            "flash_attention": per_layer * layers,
            "ssd_scan": per_layer * layers}
        losses[remat] = m["loss"]
        mu[remat] = model.layout.value_layout.unflatten(o2["mu"])
    assert torch.equal(losses[True], losses[False])
    for path, want in mu[False].items():
        err = (mu[True][path] - want).abs().max()
        assert err <= 1e-3 * want.abs().max(), (path, float(err))
