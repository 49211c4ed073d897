#!/usr/bin/env python3
"""Times this tree's flash attention and SSD scan kernels against an earlier
tree's, in one run on one GPU.

    mkdir -p _archive/parent
    git archive <rev> src/repro_torch | tar -x -C _archive/parent
    python3 kernel_ab.py --parent _archive/parent [--out ab.json]

``<rev>`` is the commit to compare with (``HEAD`` while the change is not
yet committed). Each tree's package is imported in turn and called through
its own wrappers (``kernels.flash_attention.flash_attention`` and
``kernels.ssd_scan.ssd_scan``, whose signatures every tree shares), so the
earlier kernels run with their own C interfaces; each tree builds its
kernels into its own ``csrc/build``. At Hymba-1.5B's prefill shapes (the
serve phase's 256- and 2048-token prompts against its cache, bf16, both
windows) and at Mamba2-370M's SSD shape (``chip_smoke.SSD_MODELS``), both
are held against this tree's plain version, then timed in turns earlier,
current, current, earlier: device time per call from ``torch.profiler``
(``chip_smoke.device_ms``). Prints the card's name and power limit, then
one JSON line per shape with the bound (``chip_smoke``'s); ``--out`` also
writes the lines to a file. Imports nothing of the JAX package.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def wrappers(tree: Path):
    """(flash_attention, ssd_scan) of the ``repro_torch`` package in
    ``tree``, with both kernels built. The package's modules are taken out of
    ``sys.modules`` before the import, so two trees load side by side: each
    wrapper keeps its own module's globals."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    src = str(tree / "src")
    sys.path.insert(0, src)
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as ss
        if Path(build.__file__).resolve().parents[2] != Path(src).resolve():
            raise RuntimeError(f"no repro_torch package under {src}")
        build.build(["flash_attention", "ssd_scan"])
    finally:
        sys.path.remove(src)
    return fa.flash_attention, ss.ssd_scan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked earlier tree holding src/repro_torch")
    ap.add_argument("--out", type=Path, help="also write the lines here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    old_fa, old_ss = wrappers(args.parent.resolve())
    new_fa, new_ss = wrappers(ROOT)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (SERVE_MAX_LEN, SERVE_SEQ, SSD_MODELS,
                            _flash_pairs, bound, card_rates, device_ms,
                            ssd_bound, tflops)
    from repro_torch.kernels.ref import flash_attention_plain, ssd_scan_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bw, peak, bf16_peak = card_rates(torch.cuda.get_device_name(0))
    lines = [dict(card=smi)]
    print(json.dumps(lines[0]), flush=True)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)

    def compare(row, old, new, want, flops):
        """Errors of both against ``want`` and their times in turns."""
        errs = {}
        for tag, fn in (("parent", old), ("new", new)):
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            errs[tag] = [float((g.float() - w.float()).abs().max())
                         for g, w in zip(got, want)]
        t = [device_ms(f, iters=30, warm=3) for f in (old, new, new, old)]
        row.update(max_abs_err=errs, parent_ms=[t[0], t[3]], ms=[t[1], t[2]],
                   tflops=tflops(flops, min(t[1:3])))
        lines.append(row)
        print(json.dumps(row), flush=True)

    h, hkv, d, t = 25, 5, 64, SERVE_MAX_LEN
    for s in SERVE_SEQ:
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

    for name, (b, s, hh, p, n, chunk) in SSD_MODELS:
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
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
