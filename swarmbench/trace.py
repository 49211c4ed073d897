"""Reduction of a ``torch.profiler`` trace of whole rounds (the yardstick).

The device's busy time is the union of its kernel, copy and set intervals
(overlapping records count once); the idle share is the rest of the
profiled rounds' wall. Kernel times are summed by name.

The busy time comes from a trace of the device's activity alone
(:func:`reduce_marked`): recording every host op would slow the host and
open gaps that the program does not have. Its window is set by two
marker launches (:func:`mark`) on an idle device, one right before the
rounds and one right after their last synchronisation. A second trace, of the host's ops
as well, names the longest idle gaps (:func:`reduce`): by the innermost
host op (not a CUDA runtime call) running at the middle of each gap.
"""
from __future__ import annotations

from collections import defaultdict

import torch


def _host_name(name: str) -> bool:
    return not (name.startswith("cuda") or name.startswith("cu")
                or name.startswith("ProfilerStep"))


def records(prof) -> tuple:
    """``(device, host)`` records ``(start_ns, end_ns, name)`` of a
    finished ``torch.profiler.profile``."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.is_user_annotation():
            # a range the host marked (its device-side copy spans the
            # kernels it holds, and is no device work of its own)
            continue
        if e.device_type() == cuda:
            dev.append((a, b, e.name()))
        elif b > a:
            host.append((a, b, e.name()))
    return dev, host


def reduce(prof, t0_ns: int, t1_ns: int, top: int = 10) -> dict:
    """``prof``: a finished ``torch.profiler.profile`` of host and device
    over the window ``[t0_ns, t1_ns]`` (its own clock:
    ``time.perf_counter_ns`` is not the profiler's, so the window is the
    span of the rounds' annotation, :func:`window_of`)."""
    return reduce_events(*records(prof), t0_ns, t1_ns, top)


MARKER = "spin_kernel"


def mark():
    """One marker on the device: a kernel of a few cycles
    (``torch.cuda._sleep``'s ``spin_kernel``, which no program path
    launches; the trace names it with its namespace and arguments)."""
    torch.cuda._sleep(1)


def reduce_marked(prof, top: int = 10) -> dict:
    """:func:`reduce_events` of a device-only trace between its first and
    last markers: the window runs from the start of the one to the start
    of the other, and the markers are no work."""
    dev = records(prof)[0]
    marks = sorted(a for a, _, name in dev if MARKER in name)
    if len(marks) < 2:
        names = sorted({name for _, _, name in dev})[:5]
        raise RuntimeError(f"a device trace without its two markers: "
                           f"{len(dev)} records, such as {names}")
    work = [d for d in dev if MARKER not in d[2]]
    return reduce_events(work, [], marks[0], marks[-1], top)


def reduce_events(dev, host, t0_ns: int, t1_ns: int, top: int = 10) -> dict:
    """:func:`reduce` over ``(start_ns, end_ns, name)`` records: ``dev``
    the device's, ``host`` the host's ops."""
    dev = [d for d in dev if d[1] > t0_ns and d[0] < t1_ns]
    host = [h for h in host if _host_name(h[2])]
    dev.sort()
    by_name = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += (b - a) / 1e9
    busy, gaps, cur = 0, [], t0_ns
    for a, b, _ in dev:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if a > cur:
            gaps.append((a - cur, cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1_ns > cur:
        gaps.append((t1_ns - cur, cur, t1_ns))
    busy /= 1e9
    gaps.sort(reverse=True)
    named = []
    for width, a, b in gaps[:top]:
        mid = (a + b) // 2
        inner = None
        for ha, hb, name in host:
            if ha <= mid <= hb and (inner is None or hb - ha < inner[1] - inner[0]):
                inner = (ha, hb, name)
        named.append([inner[2] if inner else "no host op", width / 1e9])
    ops = sorted(([k, v[1]] for k, v in by_name.items()), key=lambda r: -r[1])
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) / 1e9,
            "kernels": {k: (v[0], v[1]) for k, v in by_name.items()},
            "device_ops": ops[:top], "idle_gaps": named}


def window_of(prof, annotation: str):
    """(start, end) in the profiler's clock of the user annotation
    ``annotation`` (the profiled rounds)."""
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == annotation
             and e.device_type() != torch.autograd.DeviceType.CUDA]
    if not spans:
        raise RuntimeError(f"no {annotation!r} range in the trace")
    return min(a for a, _ in spans), max(b for _, b in spans)


def kernel_time(reduced: dict, *words: str) -> tuple:
    """(records, seconds) of the kernels whose name holds any of ``words``."""
    n, s = 0, 0.0
    for name, (count, sec) in reduced["kernels"].items():
        if any(w in name for w in words):
            n += count
            s += sec
    return n, s
