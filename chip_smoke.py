#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device      the card's name and power limit (``nvidia-smi``), torch/CUDA
                 versions, both TF32 flags;
  2. build       nvcc build of every kernel source, in seconds, with the
                 registers of every variant and any that spill;
  3. kernel      each kernel against its plain PyTorch version on the card
                 (the f32 commit: accepted rows within rtol = atol = 1e-6 for
                 f32 or one bf16 ulp; the quantized-wire commit: r' and every
                 row bit-equal; rejected rows bit-equal for both), and at the
                 main-path shape its time beside the plain version, a
                 one-call library yardstick where one exists, and the card's
                 bound;
  4. histo       the main path: ``run_experiment`` at the paper's full width
                 (224 px, P = 1,639,705 params per node, N = 4) — centralized,
                 local and swarm rows; every commit must launch the fedavg
                 kernel once;
  5. fisher      a fisher/ring ``SwarmSession`` at the same width for 2
                 rounds; every commit must launch the importance-weighted
                 kernel once; then one profiled round;
  6. histo_int8  ``run_experiment`` at the same width on the int8
                 error-feedback wire (``wire_block`` 512): every commit must
                 launch the quantized-wire kernel once, the f32 kernel never;
  7. fisher_int8 the fisher/ring session on the int8 wire for 2 rounds; every
                 commit must launch the quantized importance form once; then
                 one profiled round;
  8. checkpoint  that session saved at paper width and restored into a fresh
                 one; one more round on both must agree bit for bit (cuDNN
                 set deterministic for the round);
  9. parity      one small round on the card against the same round on the
                 CPU (plain commit, CPU convs), TF32 off, params at 1e-4;
 10. lora_kernel the fused LoRA matmul against its plain version on the card
                 (the reference's tolerance: 2e-5 f32, 2e-2 bf16) at the
                 zoo head's train, validation and test shapes, the
                 reference's four sweep shapes and ragged ones, a zero-B
                 case equal to x @ W, and the autograd Function's
                 gradients (x, W, A, B, scale) against autograd through the
                 plain version at 1e-5; times at the zoo shape and at
                 (M, K, N, r) = (128, 1024, 256, 64) beside the plain
                 version, the unfused cuBLAS form (three calls, never used
                 by the port) and the card's bound: device time per call
                 from the profiler, and the host clock's time per call;
 11. hetero      the heterogeneous model-zoo swarm: ``run_scenario`` over
                 the five cells of ``scenario_grid`` at the
                 ``ScenarioRunConfig`` defaults (N = 4, 16 px, feat 16,
                 hidden 16, rank 4, 24 steps, int8 wire); per cell the LoRA
                 kernel must launch, the quantized commit once per sync and
                 the f32 commit never, 180 payload values per node, the wire
                 at most 5 % of a full f32 sync, finite per-site AUCs and the
                 reference's row keys; then one profiled zoo round and a
                 card-vs-CPU parity of one zoo round (TF32 off, payload rows
                 at 1e-4);
 12. kernels     the per-kernel summary line, then the ``ok`` line.

Exits non-zero, printing no result, without a CUDA device or without the
repository's sources beside it. Imports nothing of the JAX package.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# memory rate (bytes/s) and f32 non-tensor-core peak (flop/s) by card, from
# NVIDIA's data sheets (dense, at the full power limit)
CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))
SOURCES = {"fused_merge": "src/repro_torch/csrc/fused_merge.cu",
           "fused_quant_merge": "src/repro_torch/csrc/fused_quant_merge.cu",
           "lora_matmul": "src/repro_torch/csrc/lora_matmul.cu"}
# kernel → (source stem, the TPU kernel body it replaces)
KERNELS = {
    "fused_merge_all": ("fused_merge",
                        "src/repro/kernels/fused_merge.py:114"),
    "fused_merge_all_imp": ("fused_merge",
                            "src/repro/kernels/fused_merge.py:126"),
    "fused_quant_merge_all": ("fused_quant_merge",
                              "src/repro/kernels/fused_merge.py:206"),
    "fused_quant_merge_all_imp": ("fused_quant_merge",
                                  "src/repro/kernels/fused_merge.py:226"),
    "lora_matmul": ("lora_matmul", "src/repro/kernels/lora_matmul.py:26")}
N, P = 4, 1_639_705
WIRE_BLOCK = 512


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_rates(name):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no memory/flop rates on record for {name!r}")


def time_ms(fn, iters=50, warm=20, repeats=7):
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, from CUDA events, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def device_ms(fn, iters=200, warm=20):
    """Device time per call: the CUDA kernels' own time summed over
    ``iters`` calls under ``torch.profiler``, over ``iters``. Where one call
    takes microseconds, CUDA events around back-to-back calls measure the
    host's rate of enqueueing them (the Python wrapper), not the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / iters


def check_commit(got, want, x, gates):
    """Max |got − want| over accepted rows; raises outside the tolerance or
    when a rejected row is not the input row ``x`` bit for bit."""
    import torch
    g = gates.to(torch.bool)
    if not torch.equal(got[~g], x[~g]):
        raise AssertionError("rejected rows differ from the input rows")
    if not g.any():
        return 0.0
    a, b = got[g].float(), want[g].float()
    err = (a - b).abs()
    if got.dtype == torch.bfloat16:
        limit = b.abs() * 2.0 ** -7          # one bf16 ulp bounds the spacing
    else:
        limit = 1e-6 + 1e-6 * b.abs()
    if bool((err > limit).any()):
        raise AssertionError(f"kernel disagrees with plain: max err "
                             f"{float(err.max())}")
    return float(err.max())


def phase_kernels(dev, bw, peak):
    import torch
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels.ref import fused_merge_all_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {}
    for form in ("fused_merge_all", "fused_merge_all_imp"):
        imp_form = form.endswith("imp")
        max_err = 0.0
        for n, d, dtype in ((N, P, torch.float32), (64, 777, torch.float32),
                            (4, 2048, torch.bfloat16)):
            x = torch.randn(n, d, device=dev, generator=gen).to(dtype)
            W = torch.rand(n, n, device=dev, generator=gen)
            W = W / W.sum(1, keepdim=True)
            f = (torch.rand(n, d, device=dev, generator=gen) + 0.1
                 if imp_form else None)
            for name, gates in (("accept", torch.ones(n, dtype=torch.bool)),
                                ("reject", torch.zeros(n, dtype=torch.bool)),
                                ("mixed", torch.arange(n) % 2 == 0)):
                gates = gates.to(dev)
                got = fm.fused_merge_all(x, W, gates, f)
                want = fused_merge_all_plain(x, W, gates, f)
                torch.cuda.synchronize()
                max_err = max(max_err, check_commit(got, want, x, gates))
        # time at the main-path shape, every gate accepting
        x = torch.randn(N, P, device=dev, generator=gen)
        W = torch.full((N, N), 1.0 / N, device=dev)
        f = torch.rand(N, P, device=dev, generator=gen) + 0.1 if imp_form else None
        g = torch.ones(N, dtype=torch.bool, device=dev)
        ms = time_ms(lambda: fm.fused_merge_all(x, W, g, f))
        plain_ms = time_ms(lambda: fused_merge_all_plain(x, W, g, f), iters=20)
        if imp_form:
            lib = lambda: torch.where(g[:, None], (W @ (f * x))
                                      / (W @ f).clamp_min(1e-30), x)
            nbytes = 3 * N * P * 4 + N * N * 4 + N
            flops = N * N * P * 4 + N * P
        else:
            lib = lambda: torch.where(g[:, None], W @ x, x)
            nbytes = 2 * N * P * 4 + N * N * 4 + N
            flops = N * N * P * 2
        library_ms = time_ms(lib, iters=20)
        bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
        stats[form] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms,
                           bound_ms=max(bytes_ms, flops_ms),
                           bound_by="bytes" if bytes_ms >= flops_ms
                           else "operations")
        emit("kernel", name=form, shape=[N, P], kernel_ms=ms,
             **{k: v for k, v in stats[form].items() if k != "ms"})
    return stats


def phase_quant_kernels(dev, bw, peak):
    """The quantized-wire commit against its plain version: r' and every
    committed row bit-equal. Main-path shape with the paper CNN's real block
    grid (conv leaves gathered through ``perm``), and N = 64 at D = 777."""
    import torch
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.core import comms
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels.ref import fused_quant_merge_all_plain

    layout = FlatLayout.of_module(histo._model(PAPER_FULL))
    if layout.size != P:
        raise AssertionError(f"{layout.size} params per node, want {P}")
    gen = torch.Generator(device=dev).manual_seed(1)
    stats = {}
    for form in ("fused_quant_merge_all", "fused_quant_merge_all_imp"):
        imp_form = form.endswith("imp")
        for wire in ("int8", "bf16"):
            for n, shape in ((N, layout), (64, 777)):
                d = P if shape is layout else shape
                grid = comms.wire_grid(shape, wire, WIRE_BLOCK, device=dev)
                x = torch.randn(n, d, device=dev, generator=gen)
                r = x + 0.01 * torch.randn(n, d, device=dev, generator=gen)
                W = torch.rand(n, n, device=dev, generator=gen)
                W = W / W.sum(1, keepdim=True)
                f = (torch.rand(n, d, device=dev, generator=gen) + 0.1
                     if imp_form else None)
                for gates in (torch.ones(n, dtype=torch.bool),
                              torch.zeros(n, dtype=torch.bool),
                              torch.arange(n) % 2 == 0):
                    gates = gates.to(dev)
                    got, rp = fm.fused_quant_merge_all(x, r, W, gates, f,
                                                       grid=grid)
                    want, wrp = fused_quant_merge_all_plain(x, r, W, gates, f,
                                                            grid=grid)
                    torch.cuda.synchronize()
                    if not torch.equal(rp, wrp):
                        raise AssertionError(
                            f"{form} {wire} N={n}: r' differs from plain, "
                            f"max err {float((rp - wrp).abs().max())}")
                    check_commit(got, want, x, gates)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{form} {wire} N={n}: committed differs from "
                            f"plain, max err {float((got - want).abs().max())}")
            # time at the main-path shape, every gate accepting
            grid = comms.wire_grid(layout, wire, WIRE_BLOCK, device=dev)
            x = torch.randn(N, P, device=dev, generator=gen)
            r = x + 0.01 * torch.randn(N, P, device=dev, generator=gen)
            W = torch.full((N, N), 1.0 / N, device=dev)
            f = (torch.rand(N, P, device=dev, generator=gen) + 0.1
                 if imp_form else None)
            g = torch.ones(N, dtype=torch.bool, device=dev)
            ms = time_ms(lambda: fm.fused_quant_merge_all(x, r, W, g, f,
                                                          grid=grid))
            plain_ms = time_ms(lambda: fused_quant_merge_all_plain(
                x, r, W, g, f, grid=grid), iters=10)
            # x and r (and f) read once, committed and r' written once; the
            # quantize step (int8: |v|, max, v/s, rint, 2 clamps, q·s, the
            # sub and the add) is ~10 f32 operations per element
            nbytes = (5 if imp_form else 4) * N * P * 4 + N * N * 4 + N
            flops = (4 * N * N * P + N * P if imp_form
                     else 2 * N * N * P) + 10 * N * P
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms
                       else "operations")
            emit("kernel", name=form, wire=wire, shape=[N, P],
                 segments=int(grid.segments.shape[0]),
                 gathered=grid.perm is not None, kernel_ms=ms,
                 **{k: v for k, v in row.items() if k != "ms"})
            if wire == "int8":      # the main path's wire
                stats[form] = row
    return stats


def phase_histo(dev, wire=None):
    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.kernels import fused_merge as fm

    round_s = []

    class TimedSession(histo.SwarmSession):
        """Synchronized wall time of every round the experiment runs: each
        sync of the engine is followed by a device sync and a time mark."""

        def run_rounds(self, batches, val):
            sync = self.engine.sync
            marks = []

            def timed_sync(*args, **kw):
                out = sync(*args, **kw)
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                return out

            self.engine.sync = timed_sync
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return super().run_rounds(batches, val)
            finally:
                del self.engine.sync
                round_s.extend(b - a for a, b in zip([t0] + marks, marks))

    swarm = SwarmConfig(n_nodes=4, sync_every=5, topology="full",
                        merge="fedavg", lora_only=False, val_threshold=0.8,
                        **(wire or {}))
    ecfg = histo.HistoExperimentConfig(
        n_train=512, n_test=128, image_size=PAPER_FULL.image_size,
        batch_size=16, steps=10, swarm=swarm, growth=PAPER_FULL.growth,
        stem=PAPER_FULL.stem, feat_dim=PAPER_FULL.feat_dim,
        hidden=PAPER_FULL.hidden, n_blocks=PAPER_FULL.n_blocks,
        layers_per_block=PAPER_FULL.layers_per_block)
    torch.cuda.reset_peak_memory_stats()
    plain_session = histo.SwarmSession
    histo.SwarmSession = TimedSession
    try:
        fm.reset_launches()
        t0 = time.perf_counter()
        result = histo.run_experiment(ecfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fm.LAUNCHES)
    finally:
        histo.SwarmSession = plain_session
    print(histo.summarize(result), flush=True)
    rows = [result["centralized"], *result["local"], *result["swarm"]]
    if len(rows) != 9:
        raise AssertionError("expected 1 centralized + 4 local + 4 swarm rows")
    for rep in rows:
        vals = [rep[k] for k in ("auc", "sensitivity", "specificity", "f1",
                                 "dbi")]
        if not all(v == v and abs(v) != float("inf") for v in vals):
            raise AssertionError(f"non-finite report row {rep}")
        if not 0.0 <= rep["auc"] <= 1.0:
            raise AssertionError(f"AUC out of range {rep['auc']}")
    log = result["sync_log"]
    if len(log) != 2 or any(len(s["gates"]) != 4 for s in log):
        raise AssertionError(f"expected 2 sync rounds of 4 gates, got {log}")
    form = "fused_quant_merge_all" if wire else "fused_merge_all"
    if launches != {k: 2 if k == form else 0 for k in fm.LAUNCHES}:
        raise AssertionError(f"commit launches {launches}, want 2 {form}")
    size = FlatLayout.of_module(histo._model(ecfg)).size
    if size != P:
        raise AssertionError(f"{size} params per node, want {P}")
    emit("histo_int8" if wire else "histo", params_per_node=size,
         nodes=swarm.n_nodes, wire=swarm.wire_dtype,
         image_size=ecfg.image_size,
         gates=[s["gates"] for s in log], round_seconds=round_s,
         total_seconds=seconds,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return launches


def _session(dev, cfg, ecfg, shards):
    """A SwarmSession built as the experiment builds its swarm."""
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.optim import adamw_init

    model = histo._model(ecfg)
    layout = FlatLayout.of_module(model)
    step, _ = histo._make_model_fns(ecfg, model, layout)
    flat = layout.flatten(histo._init_params(ecfg, model))
    return histo.SwarmSession(
        cfg, step, histo._make_eval_fn(cfg, model, layout), params=flat,
        opt_state=adamw_init(flat), data_sizes=[len(y) for _, y in shards],
        layout=layout, device=dev)


def _round_data(ecfg, shards, rounds, t):
    import torch
    from repro_torch.experiments import histo
    vals, trains = [], []
    for x, y in shards:
        n_val = max(8, int(len(y) * ecfg.val_frac))
        vals.append((x[:n_val], y[:n_val]))
        trains.append((x[n_val:], y[n_val:]))
    xs, ys = histo._batch_stream(ecfg, trains)
    xs = torch.from_numpy(xs).reshape((rounds, t) + xs.shape[1:])
    ys = torch.from_numpy(ys.astype("int64")).reshape((rounds, t)
                                                      + ys.shape[1:])
    return xs, ys, histo._stack_vals(vals)


def phase_fisher(dev, wire=None):
    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.data import make_histo_dataset, paper_splits, shard_to_nodes
    from repro_torch.experiments import histo
    from repro_torch.kernels import fused_merge as fm

    cfg = SwarmConfig(n_nodes=4, sync_every=5, topology="ring",
                      merge="fisher", lora_only=False, val_threshold=0.8,
                      **(wire or {}))
    ecfg = histo.HistoExperimentConfig(
        n_train=256, image_size=224, batch_size=16, steps=10, swarm=cfg,
        growth=PAPER_FULL.growth, stem=PAPER_FULL.stem,
        feat_dim=PAPER_FULL.feat_dim, hidden=PAPER_FULL.hidden)
    x, y = make_histo_dataset(ecfg.n_train, size=224, noise=ecfg.noise,
                              class_probs=ecfg.class_probs, seed=1)
    shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=1)
    xs, ys, val = _round_data(ecfg, shards, 2, 5)
    xs, ys = xs.to(dev), ys.to(dev)
    val = tuple(torch.from_numpy(v).to(dev) for v in val)
    sess = _session(dev, cfg, ecfg, shards)
    fm.reset_launches()
    round_s, gates = [], []
    for r in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = sess.round((xs[r], ys[r]), val)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        gates.append(log["gates"].tolist())
    launches = dict(fm.LAUNCHES)
    form = "fused_quant_merge_all_imp" if wire else "fused_merge_all_imp"
    if launches != {k: 2 if k == form else 0 for k in fm.LAUNCHES}:
        raise AssertionError(f"commit launches {launches}, want 2 {form}")
    if not bool(torch.isfinite(sess.state.params).all()):
        raise AssertionError("non-finite params after the fisher rounds")
    emit("fisher_int8" if wire else "fisher", gates=gates,
         round_seconds=round_s, launches=launches)
    phase_profile(sess, (xs[1], ys[1]), val, "fisher_int8" if wire
                  else "fisher")
    return launches, (sess, cfg, ecfg, shards, (xs[0], ys[0]), val)


def phase_profile(sess, batch, val, path):
    """One more round under ``torch.profiler``: device time by kernel, the
    device's busy share of the round's wall time, the commit kernel's time
    and that of the scatter/gather/index kernels (on the int8 wire, the
    per-block max-abs and scale gathers of ``comms.wire_effective``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sess.round(batch, val)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((us, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    def ms_of(*words):
        return sum(us for us, _, k in kernels
                   if any(w in k for w in words)) / 1e3

    emit("profile", path=path, round_wall_s=wall, device_busy_s=busy,
         device_busy_share=busy / wall,
         commit_kernel_ms=ms_of("merge_all_kernel", "quant_merge_kernel"),
         lora_kernel_ms=ms_of("lora_kernel"),
         lora_kernel_calls=sum(c for _, c, k in kernels
                               if "lora_kernel" in k),
         scatter_gather_ms=ms_of("scatter", "gather", "index"),
         top=[{"kernel": k, "ms": us / 1e3, "calls": c}
              for us, c, k in kernels[:12]])


def phase_checkpoint(dev, run):
    """Save the int8 fisher session at paper width, restore it into a fresh
    session, run one more round on both, and hold them equal bit for bit
    (params, AdamW moments, statistics, wire reference, counters, rng)."""
    import os
    import tempfile

    import torch

    sess, cfg, ecfg, shards, batch, val = run
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "swarm.msgpack")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.save(path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            fresh = _session(dev, cfg, ecfg, shards)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh.load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        a, b = sess.state, fresh.state
        for field in ("params", "stats", "wire", "active"):
            if not torch.equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"restored {field} differs")
        sess.round(batch, val)
        fresh.round(batch, val)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    a, b = sess.state, fresh.state
    same = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
            for f in ("params", "stats", "wire", "active")}
    same.update({f"opt_{k}": bool(torch.equal(a.opt_state[k], b.opt_state[k]))
                 for k in a.opt_state})
    same["counters"] = ((a.round, a.step, a.rng.tolist())
                        == (b.round, b.step, b.rng.tolist()))
    emit("checkpoint", bytes=size, save_seconds=save_s,
         load_seconds=load_s, round=b.round, bit_identical=same)
    if not all(same.values()):
        raise AssertionError(f"resumed session diverged: {same}")


def phase_parity(dev):
    """One small fedavg round and one fisher/ring round on the card against
    the same rounds on the CPU, with cuDNN TF32 off for the comparison."""
    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.data import make_histo_dataset, paper_splits, shard_to_nodes
    from repro_torch.experiments import histo

    ecfg = histo.HistoExperimentConfig(
        n_train=160, image_size=16, batch_size=8, steps=3, growth=4, stem=8,
        feat_dim=32, hidden=16, n_blocks=1, layers_per_block=2)
    x, y = make_histo_dataset(ecfg.n_train, size=16, noise=0.6, seed=0)
    shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=0)
    xs, ys, val = _round_data(ecfg, shards, 1, 3)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for merge, topology in (("fedavg", "full"), ("fisher", "ring")):
            cfg = SwarmConfig(n_nodes=4, sync_every=3, topology=topology,
                              merge=merge, lora_only=False, val_threshold=0.8)
            res = {}
            for d in (dev, "cpu"):
                sess = _session(d, cfg, ecfg, shards)
                log = sess.round((xs[0], ys[0]), val)
                res[d] = (sess.state.params.cpu(), log["gates"].cpu())
            err = float((res[dev][0] - res["cpu"][0]).abs().max())
            if err > 1e-4 or not torch.equal(res[dev][1], res["cpu"][1]):
                raise AssertionError(f"{merge}: card vs CPU params err {err}, "
                                     f"gates {res[dev][1]} vs {res['cpu'][1]}")
            out[merge] = err
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    emit("parity", max_abs_err=out)


# (M, K, N, r, dtype name): the zoo head's train, validation and test
# shapes, the reference's sweep shapes (tests/test_kernels.py), ragged ones
LORA_SHAPES = ((8, 16, 16, 4, "float32"), (24, 16, 16, 4, "float32"),
               (160, 16, 16, 4, "float32"), (128, 256, 128, 8, "float32"),
               (256, 512, 384, 16, "float32"),
               (128, 1024, 256, 64, "float32"),
               (256, 256, 256, 16, "bfloat16"), (37, 70, 45, 3, "float32"),
               (33, 65, 31, 128, "float32"), (37, 70, 45, 5, "bfloat16"))
LORA_ZOO = (8, 16, 16, 4)
LORA_SWEEP = (128, 1024, 256, 64)


def _lora_inputs(dev, gen, m, k, n, r, dtype):
    import torch
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(dt)

    return (t(m, k), t(k, n, scale=k ** -0.5), t(k, r, scale=k ** -0.5),
            t(r, n, scale=r ** -0.5),
            torch.tensor(1.5, dtype=torch.float32, device=dev))


def _lora_bound(m, k, n, r, bw, peak, itemsize=4):
    """(bound_ms, bound_by): each input read once (and the f32 scale), the
    output written once; 2·M·N·K + 2·M·K·r + 2·M·r·N f32 operations."""
    nbytes = (m * k + k * n + k * r + r * n + m * n) * itemsize + 4
    flops = 2 * m * n * k + 2 * m * k * r + 2 * m * r * n
    bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def phase_lora_kernel(dev, bw, peak):
    """The fused LoRA matmul against its plain version on the card, its
    gradient, and its times beside the plain version, the unfused cuBLAS
    form and the bound."""
    import torch
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels.ref import lora_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    max_err = 0.0
    for m, k, n, r, dtype in LORA_SHAPES:
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        x, w, a, b, s = _lora_inputs(dev, gen, m, k, n, r, dtype)
        for bb, want in ((b, lora_matmul_plain(x, w, a, b, s)),
                         (torch.zeros_like(b),
                          (x.float() @ w.float()).to(x.dtype))):
            got = lm.lora_matmul(x, w, a, bb, s)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if bool((err > tol + tol * want.float().abs()).any()):
                raise AssertionError(f"lora_matmul {(m, k, n, r, dtype)}: "
                                     f"max err {float(err.max())}")
            if dtype == "float32":
                max_err = max(max_err, float(err.max()))
    # the autograd Function (kernel forward) against autograd through the
    # plain version, at the zoo's train shape with a live low-rank path
    x, w, a, b, s = _lora_inputs(dev, gen, *LORA_ZOO, "float32")
    gy = torch.randn(LORA_ZOO[0], LORA_ZOO[2], device=dev, generator=gen)

    def grads(fn):
        return torch.func.grad(lambda *v: (fn(*v) * gy).sum(),
                               argnums=(0, 1, 2, 3, 4))(x, w, a, b, s)

    before = lm.LAUNCHES["lora_matmul"]
    got = grads(lm.lora_apply)
    if lm.LAUNCHES["lora_matmul"] != before + 1:
        raise AssertionError("the gradient's forward did not launch the "
                             "kernel")
    want = grads(lora_matmul_plain)
    grad_err = {}
    for name, g, h in zip(("x", "w", "a", "b", "scale"), got, want):
        if not torch.allclose(g, h, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"lora grad {name}: max err "
                                 f"{float((g - h).abs().max())}")
        grad_err[name] = float((g - h).abs().max())

    # device time per call (profiler) and, beside it, the host clock's
    # time per call of back-to-back calls (CUDA events)
    out = {}
    for label, (m, k, n, r) in (("zoo", LORA_ZOO), ("sweep", LORA_SWEEP)):
        x, w, a, b, s = _lora_inputs(dev, gen, m, k, n, r, "float32")
        fns = {"kernel": lambda: lm.lora_matmul(x, w, a, b, s),
               "plain": lambda: lora_matmul_plain(x, w, a, b, s),
               "unfused_cublas": lambda: torch.addmm(x @ w, x @ a, b,
                                                     alpha=1.5)}
        bound_ms, bound_by = _lora_bound(m, k, n, r, bw, peak)
        out[label] = dict(shape=[m, k, n, r], bound_ms=bound_ms,
                          bound_by=bound_by)
        for name, fn in fns.items():
            out[label][f"{name}_ms"] = device_ms(fn)
            out[label][f"{name}_host_ms"] = time_ms(fn)
    emit("lora_kernel", shapes=[list(t) for t in LORA_SHAPES],
         max_abs_err_f32=max_err, grad_max_abs_err=grad_err,
         timings=out, tolerance={"float32": 2e-5, "bfloat16": 2e-2,
                                 "grad": 1e-5})
    zoo = out["zoo"]
    return {"lora_matmul": dict(
        max_abs_err=max_err, ms=zoo["kernel_ms"], plain_ms=zoo["plain_ms"],
        library_ms=None, bound_ms=zoo["bound_ms"],
        bound_by=zoo["bound_by"])}


ROW_KEYS = {"scenario", "partition", "families", "shard_sizes", "n_synth",
            "schedule", "payload_class", "payload_params",
            "wire_bytes_per_sync", "full_f32_bytes_per_sync", "retraces",
            "rounds", "per_site", "site_auc_spread",
            "site_sensitivity_spread", "worst_site_auc", "oracle",
            "oracle_gap_auc", "gates_last", "wire_fraction_of_full",
            "fairness_ok_last", "worst_site_gate_metric"}


def phase_hetero(dev):
    """``run_scenario`` over the five cells at the defaults, with the
    launch counts set to 0 just before each cell and read just after."""
    import math

    import torch
    from repro_torch.experiments import scenarios
    from repro_torch.kernels import LAUNCHES, reset_launches

    rcfg = scenarios.ScenarioRunConfig()
    rounds = rcfg.steps // rcfg.swarm.sync_every
    total = {}
    cells = []
    for scn in scenarios.scenario_grid():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = scenarios.run_scenario(scn, rcfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want = {k: 0 for k in LAUNCHES}
        want.update(fused_quant_merge_all=rounds,
                    lora_matmul=launches["lora_matmul"])
        if launches["lora_matmul"] < 1 or launches != want:
            raise AssertionError(f"{scn.name}: launches {launches}, want "
                                 f"{rounds} quantized commits, the LoRA "
                                 "kernel, nothing else")
        if set(row) != ROW_KEYS:
            raise AssertionError(f"{scn.name}: row keys "
                                 f"{sorted(set(row) ^ ROW_KEYS)} differ")
        aucs = [r["auc"] for r in row["per_site"]]
        if row["payload_params"] != 180 or row["rounds"] != rounds:
            raise AssertionError(f"{scn.name}: payload "
                                 f"{row['payload_params']}, rounds "
                                 f"{row['rounds']}")
        if not row["wire_fraction_of_full"] <= 0.05:
            raise AssertionError(f"{scn.name}: wire fraction "
                                 f"{row['wire_fraction_of_full']}")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0
                   for v in aucs + [row["oracle"]["auc"]]):
            raise AssertionError(f"{scn.name}: per-site AUCs {aucs}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        cells.append(dict(scenario=scn.name, seconds=seconds,
                          launches={k: v for k, v in launches.items() if v},
                          site_auc=aucs, oracle_auc=row["oracle"]["auc"],
                          gates_last=row["gates_last"],
                          wire_fraction_of_full=row["wire_fraction_of_full"],
                          wire_bytes_per_sync=row["wire_bytes_per_sync"],
                          shard_sizes=row["shard_sizes"]))
    emit("hetero", nodes=rcfg.n_nodes, steps=rcfg.steps, rounds=rounds,
         payload_params=180, cells=cells,
         total_seconds=sum(c["seconds"] for c in cells), launches=total)

    # one profiled zoo round (the iid cell's session, first round)
    cell = scenarios.prepare(scenarios.scenario_grid()[0], rcfg, device=dev)
    t = rcfg.swarm.sync_every
    cell.session.round((cell.xs[:t], cell.ys[:t]), cell.val)
    phase_profile(cell.session, (cell.xs[t:2 * t], cell.ys[t:2 * t]),
                  cell.val, "hetero")
    return total


def phase_hetero_parity(dev):
    """One zoo round of the paper-split cell on the card against the same
    round on the CPU (plain kernels, CPU convs), cuDNN TF32 off."""
    import torch
    from repro_torch.experiments import scenarios

    rcfg = scenarios.ScenarioRunConfig()
    scn = scenarios.scenario_grid()[1]
    t = rcfg.swarm.sync_every
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {}
        for d in (dev, "cpu"):
            cell = scenarios.prepare(scn, rcfg, device=d)
            log = cell.session.round((cell.xs[:t], cell.ys[:t]), cell.val)
            res[d] = (cell.session.state.params.cpu(), log["gates"].cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((res[dev][0] - res["cpu"][0]).abs().max())
    if err > 1e-4 or not torch.equal(res[dev][1], res["cpu"][1]):
        raise AssertionError(f"zoo round: card vs CPU payload err {err}, "
                             f"gates {res[dev][1]} vs {res['cpu'][1]}")
    emit("hetero_parity", scenario=scn.name, max_abs_err=err,
         gates=res[dev][1].tolist())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, peak = card_rates(kind)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         memory_rate=bw, f32_peak=peak)

    t0 = time.perf_counter()
    build.build(list(SOURCES))
    variants = {}
    for stem in SOURCES:
        ptxas = build.BUILD_LOG.get(stem, {}).get("ptxas", "")
        variants[stem] = dict(
            registers=[int(ln.split("Used ")[1].split()[0])
                       for ln in ptxas.splitlines() if "registers" in ln],
            spilling=[ln.strip() for ln in ptxas.splitlines()
                      if "spill" in ln and "0 bytes spill stores, 0 bytes "
                      "spill loads" not in ln])
    emit("build", seconds=time.perf_counter() - t0,
         build_seconds={k: v["seconds"] for k, v in build.BUILD_LOG.items()},
         variants=variants)

    stats = phase_kernels(dev, bw, peak)
    stats.update(phase_quant_kernels(dev, bw, peak))
    stats.update(phase_lora_kernel(dev, bw, peak))
    # each path runs with the launch counts set to 0 just before it; a
    # kernel's launches are those of the first path that carries it
    launches = {}
    for counts in (phase_histo(dev), phase_fisher(dev)[0],
                   phase_histo(dev, dict(wire_dtype="int8",
                                         wire_block=WIRE_BLOCK))):
        launches.update({k: v for k, v in counts.items()
                         if v and k not in launches})
    counts, run = phase_fisher(dev, dict(wire_dtype="int8",
                                         wire_block=WIRE_BLOCK))
    launches.update({k: v for k, v in counts.items()
                     if v and k not in launches})
    phase_checkpoint(dev, run)
    phase_parity(dev)
    counts = phase_hetero(dev)
    launches.update({k: v for k, v in counts.items()
                     if v and k not in launches})
    phase_hetero_parity(dev)

    kernels = [dict(name=name, route="cuda", source=SOURCES[stem],
                    replaces=replaces, launches=launches.get(name, 0),
                    **stats[name])
               for name, (stem, replaces) in KERNELS.items()]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: {kernels}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
