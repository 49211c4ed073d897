#!/usr/bin/env python3
"""Times this tree's quantized-wire commit, LoRA matmul, flash attention and
SSD scan kernels, or its LM trainer, against an earlier tree's, in one run
on one GPU.

    mkdir -p _archive/parent
    git archive <rev> src/repro_torch | tar -x -C _archive/parent
    python3 kernel_ab.py --parent _archive/parent [--out ab.json]

``<rev>`` is the commit to compare with (``HEAD`` while the change is not
yet committed). Each tree's package is imported in turn and called through
its own wrappers (``kernels.fused_merge.fused_quant_merge_all`` on a wire
grid built by its own ``core.comms.wire_grid``,
``kernels.lora_matmul.lora_matmul``, ``kernels.flash_attention.
flash_attention`` and ``kernels.ssd_scan.ssd_scan``, whose signatures every
tree shares), so the earlier kernels run with their own C interfaces and
tables; each tree builds its kernels into its own ``csrc/build``. Shapes:
the quantized commit, both forms, at the paper CNN's layout (N = 4,
``wire_block`` 512) on the int8 and the bf16 grid and at the model zoo's
180-value payload (int8, ``wire_block`` 128); the LoRA matmul at the zoo
head's three shapes and the reference's sweep shape (f32); flash at
Hymba-1.5B's prefill shapes (the serve phase's 256- and 2048-token prompts
against its cache, bf16, both windows); SSD at Hymba's and Mamba2-370M's
(``chip_smoke.SSD_MODELS``). Both trees are held against this tree's plain
version (the commit bit for bit), then timed in turns earlier, current,
current, earlier: the kernel's own device time per call from
``torch.profiler`` (``chip_smoke.device_ms``). Prints the card's name and
power limit, then one JSON line per shape with the bound (``chip_smoke``'s);
``--kernels`` picks kernels; ``--out`` also writes the lines to a file.
Imports nothing of the JAX package.

    python3 kernel_ab.py --parent _archive/parent --train granite_plain,mamba2_int8_wire

compares the LM trainer's peak memory and step wall instead (no kernel is
timed unless ``--kernels`` is also given). Each run is a fresh process that
imports one tree's ``repro_torch`` (its kernels built into its own
``csrc/build``) and drives ``repro_torch.launch.train.run`` at full width
on the train phase's arguments (``chip_smoke.TRAIN_PATHS``, by name), in
turns earlier, current, current, earlier. Each run reports the peak
allocated and reserved GiB over the whole run, each train step's own
allocated peak (a swarm's vmapped step covers all its nodes; the sync is
outside it), what the run holds at its end, the last round's (step's)
wall per step, tokens/s and the launches; the runs' params must be
finite.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent


KERNELS = ("quant", "lora", "flash", "ssd")


def package(tree: Path):
    """The ``repro_torch`` package in ``tree`` as a namespace of the modules
    used here, with its kernels built. The package's modules are taken out
    of ``sys.modules`` before the import, so two trees load side by side:
    each wrapper keeps its own module's globals."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    src = str(tree / "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.configs.paper_histo import PAPER_FULL
        from repro_torch.core import comms
        from repro_torch.core.flat import FlatLayout
        from repro_torch.experiments import histo
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_merge as fm
        from repro_torch.kernels import lora_matmul as lm
        from repro_torch.kernels import ssd_scan as ss
        if Path(build.__file__).resolve().parents[2] != Path(src).resolve():
            raise RuntimeError(f"no repro_torch package under {src}")
        build.build(["fused_quant_merge", "lora_matmul", "flash_attention",
                     "ssd_scan"])
    finally:
        sys.path.remove(src)
    paper = FlatLayout.of_module(histo._model(PAPER_FULL))
    return SimpleNamespace(comms=comms, FlatLayout=FlatLayout, paper=paper,
                           fm=fm, lm=lm, fa=fa, ss=ss)


_WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[2])
from chip_smoke import TRAIN_PATHS     # puts this tree's src on the path
sys.path.insert(0, sys.argv[1] + "/src")
import torch
import repro_torch
from repro_torch.kernels import LAUNCHES, build, reset_launches
from repro_torch.launch import train

argv = dict((n, a) for n, a, _ in TRAIN_PATHS)[sys.argv[3]]
build.build(["flash_attention", "ssd_scan", "fused_merge",
             "fused_quant_merge"])
# each train step's own peak (the peak counter restarted at its call;
# the whole run's peak is the larger of those and the rest's)
step_peaks, rest_peak = [], [0]
make = train.make_train_step


def measured_make(model, tc):
    step = make(model, tc)

    def measured(*a):
        rest_peak[0] = max(rest_peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = step(*a)
        step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    return measured


train.make_train_step = measured_make
torch.cuda.reset_peak_memory_stats()
reset_launches()
args = train.parse_args(argv)
t0 = time.perf_counter()
res = train.run(args)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
peak = max(rest_peak[0], torch.cuda.max_memory_allocated()) / 2 ** 30
reserved = torch.cuda.max_memory_reserved() / 2 ** 30
held = torch.cuda.memory_allocated() / 2 ** 30
walls = res["walls"]
per_block = walls[-1][1] - walls[-2][1]
steps_block = walls[-1][0] - walls[-2][0]
sess = res.get("session")
params = sess.state.params if sess is not None else res["params"]
finite = bool(torch.isfinite(res["model"].layout.values(params)).all())
n = args.swarm_nodes or 1
print("RESULT " + json.dumps(dict(
    path=sys.argv[3], package=repro_torch.__file__, argv=argv, wall_s=wall,
    step_wall_s=per_block / steps_block,
    tokens_per_s=steps_block * n * args.batch * args.seq / per_block,
    peak_allocated_gib=peak, peak_reserved_gib=reserved,
    step_peak_allocated_gib=step_peaks, held_after_gib=held,
    params_finite=finite,
    launches={k: v for k, v in LAUNCHES.items() if v})), flush=True)
"""


def train_run(tree: Path, path: str) -> dict:
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", _WORKER, str(tree),
                          str(ROOT), path], capture_output=True, text=True,
                         env=env, timeout=900)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"{tree} {path}: exit {out.returncode}\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked earlier tree holding src/repro_torch")
    ap.add_argument("--out", type=Path, help="also write the lines here")
    ap.add_argument("--kernels",
                    help=f"comma-separated subset of {','.join(KERNELS)} "
                         f"(default: all of them, none with --train)")
    ap.add_argument("--train", default="",
                    help="comma-separated chip_smoke.TRAIN_PATHS names for "
                         "the trainer's comparison")
    args = ap.parse_args()
    if args.kernels is None:
        args.kernels = "" if args.train else ",".join(KERNELS)
    todo = set(filter(None, args.kernels.split(",")))
    if not todo <= set(KERNELS):
        ap.error(f"--kernels: choose from {KERNELS}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = [dict(card=smi)]
    print(json.dumps(lines[0]), flush=True)
    parent = args.parent.resolve()
    for path in filter(None, args.train.split(",")):
        for tree, label in ((parent, "parent"), (ROOT, "change"),
                            (ROOT, "change"), (parent, "parent")):
            row = dict(train_run(tree, path), label=label)
            if not row["params_finite"]:
                raise AssertionError(f"{label} {path}: non-finite params")
            lines.append(row)
            print(json.dumps(row), flush=True)
    if todo:
        kernels(parent, todo, lines)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


def kernels(parent: Path, todo, lines) -> None:
    """The kernels in ``todo`` of both trees held against the plain
    versions and timed in turns; a JSON line each, appended to
    ``lines``."""
    import torch
    old = package(parent)
    new = package(ROOT)
    old_fa, old_ss = old.fa.flash_attention, old.ss.ssd_scan
    new_fa, new_ss = new.fa.flash_attention, new.ss.ssd_scan
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (LORA_SHAPES, LORA_SWEEP, N, QUANT_KERNELS,
                            SERVE_MAX_LEN, SERVE_SEQ, SSD_MODELS, WIRE_BLOCK,
                            _flash_pairs,
                            _lora_bound, _lora_inputs, bound, card_rates,
                            device_ms, ssd_bound, tflops)
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         fused_quant_merge_all_plain,
                                         lora_matmul_plain, ssd_scan_plain)

    bw, peak, bf16_peak = card_rates(torch.cuda.get_device_name(0))
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)

    def compare(row, old, new, want, flops, match=None, exact=False,
                iters=30):
        """Errors of both against ``want`` (``exact``: raise unless equal
        bit for bit) and their times in turns."""
        errs = {}
        for tag, fn in (("parent", old), ("new", new)):
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            if exact and not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{tag} differs from plain: {row}")
            errs[tag] = [float((g.float() - w.float()).abs().max())
                         for g, w in zip(got, want)]
        t = [device_ms(f, iters=iters, warm=3, match=match)
             for f in (old, new, new, old)]
        row.update(max_abs_err=errs, parent_ms=[t[0], t[3]], ms=[t[1], t[2]],
                   tflops=tflops(flops, min(t[1:3])))
        lines.append(row)
        print(json.dumps(row), flush=True)

    if "quant" in todo:
        zoo = [("head/out/b", (3,)), ("head/out/w", (16, 3)),
               ("head/proj/lora_A", (16, 4)), ("head/proj/lora_B", (4, 16)),
               ("head/proj/lora_scale", ())]
        for label, wire, block in (("paper", "int8", WIRE_BLOCK),
                                   ("paper", "bf16", WIRE_BLOCK),
                                   ("zoo", "int8", 128)):
            grids = [pk.comms.wire_grid(
                pk.paper if label == "paper" else pk.FlatLayout(zoo), wire,
                block, device=dev) for pk in (old, new)]
            d = grids[1].size
            x = torch.randn(N, d, device=dev, generator=gen)
            r = x + 0.01 * torch.randn(N, d, device=dev, generator=gen)
            W = torch.full((N, N), 1.0 / N, device=dev)
            g = torch.ones(N, dtype=torch.bool, device=dev)
            for imp_form in (False, True):
                f = (torch.rand(N, d, device=dev, generator=gen) + 0.1
                     if imp_form else None)
                nbytes = (5 if imp_form else 4) * N * d * 4 + N * N * 4 + N
                flops = (4 * N * N * d + N * d if imp_form
                         else 2 * N * N * d) + 10 * N * d
                bms, by = bound(nbytes, flops, bw, peak)
                row = dict(kernel="fused_quant_merge_all"
                           + ("_imp" if imp_form else ""), payload=label,
                           wire=wire, wire_block=block, shape=[N, d],
                           bound_ms=bms, bound_by=by,
                           launch=new.fm.quant_launch_shape(grids[1], N))
                compare(row,
                        lambda: old.fm.fused_quant_merge_all(
                            x, r, W, g, f, grid=grids[0]),
                        lambda: new.fm.fused_quant_merge_all(
                            x, r, W, g, f, grid=grids[1]),
                        fused_quant_merge_all_plain(x, r, W, g, f,
                                                    grid=grids[1]),
                        flops, match=QUANT_KERNELS, exact=True,
                        iters=100)

    if "lora" in todo:
        for m, k, n, r in [s[:4] for s in LORA_SHAPES[:3]] + [LORA_SWEEP]:
            a5 = _lora_inputs(dev, gen, m, k, n, r, "float32")
            bms, by = _lora_bound(m, k, n, r, bw, peak)
            compare(dict(kernel="lora_matmul", shape=[m, k, n, r],
                         bound_ms=bms, bound_by=by),
                    lambda: old.lm.lora_matmul(*a5),
                    lambda: new.lm.lora_matmul(*a5),
                    (lora_matmul_plain(*a5),),
                    2 * m * n * k + 2 * m * k * r + 2 * m * r * n,
                    match="lora", iters=200)

    h, hkv, d, t = 25, 5, 64, SERVE_MAX_LEN
    for s in (SERVE_SEQ if "flash" in todo else ()):
        q = torch.randn(1, h, s, d, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(1, hkv, t, d, device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        for w in (0, 1024):
            flops = 4 * h * d * _flash_pairs(s, t, True, w)
            bms, by = bound(2 * (2 * h * s * d + 2 * hkv * t * d), flops, bw,
                            bf16_peak)
            compare(dict(kernel="flash_attention", q=[1, h, s, d],
                         kv=[1, hkv, t, d], window=w, bound_ms=bms,
                         bound_by=by),
                    lambda: old_fa(q, k, v, window=w),
                    lambda: new_fa(q, k, v, window=w),
                    (flash_attention_plain(q, k, v, window=w),), flops)

    for name, (b, s, hh, p, n, chunk) in (SSD_MODELS if "ssd" in todo
                                          else ()):
        x = torch.randn(b, s, hh, p, device=dev, generator=gen).bfloat16()
        dt = torch.rand(b, s, hh, device=dev, generator=gen) * 0.1 + 0.05
        alog = torch.log(torch.linspace(1, 16, hh, device=dev))
        bm, cm = ((torch.randn(b, s, 1, n, device=dev, generator=gen) * 0.5)
                  .bfloat16() for _ in range(2))
        a5 = (x, dt, alog, bm, cm)
        bms, by, flops, _ = ssd_bound(b, s, hh, p, n, chunk, 1, bw, peak,
                                      bf16_peak)
        compare(dict(kernel="ssd_scan", model=name,
                     shape=[b, s, hh, p, n, chunk], bound_ms=bms,
                     bound_by=by),
                lambda: old_ss(*a5, chunk=chunk),
                lambda: new_ss(*a5, chunk=chunk),
                ssd_scan_plain(*a5, chunk=chunk), flops)


if __name__ == "__main__":
    sys.exit(main())
