"""Reduction of a torch.profiler trace (Chrome trace JSON) to what the
per-layer metrics read: device time by kernel, the union of the intervals
in which the device ran an operation, kernel launches, and the idle gaps
named by the host span open across them."""

from __future__ import annotations

import json
import re

#: event categories of device operations in torch.profiler's Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's own span around each profiled prove
PROVE_SPAN = "benchmark.prove"


def kernel_base(name: str) -> str:
    """A kernel's symbol without return type, namespaces, template
    arguments or parameters: "void (anonymous namespace)::k<true>(int)" and
    "ns::k(int)" -> "k"."""
    head = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else name


def union_length(intervals: list) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: list, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] in which no interval runs."""
    gaps, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans: list, t: float) -> str:
    """The name of the shortest span (start, end, name) open at t."""
    open_spans = [s for s in spans if s[0] <= t < s[1]]
    return min(open_spans, key=lambda s: s[1] - s[0])[2] if open_spans else "outside any prove phase"


def reduce(path: str) -> dict:
    """Seconds and counts of the profiled proves in one Chrome trace.

    window_s: from the first profiled prove's start to the last one's end;
    busy_s: the union of device operations inside it; kernels: device
    seconds by kernel_base name; launches: kernels inside it; ops: device
    seconds by operation name (memory copies by kind); gaps: idle seconds
    by the innermost host span open across them (a gap is cut where a span
    opens or closes)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    proves = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == PROVE_SPAN]
    if not proves:
        raise ValueError("the trace holds no profiled prove")
    lo, hi = min(a for a, _ in proves), max(b for _, b in proves)
    device, kernels, ops, launches = [], {}, {}, 0
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        device.append((a, b))
        seconds = (b - a) * 1e-6
        name = kernel_base(e["name"]) if e["cat"] == "kernel" else e["name"]
        ops[name] = ops.get(name, 0.0) + seconds
        if e["cat"] == "kernel":
            kernels[name] = kernels.get(name, 0.0) + seconds
            launches += 1
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") != PROVE_SPAN]
    gaps: dict = {}
    for a, b in idle_gaps(device, lo, hi):
        cuts = sorted({a, b} | {t for s in spans for t in s[:2] if a < t < b})
        for u, v in zip(cuts, cuts[1:]):
            name = innermost(spans, (u + v) / 2)
            gaps[name] = gaps.get(name, 0.0) + (v - u) * 1e-6
    return {
        "proves": len(proves),
        "window_s": (hi - lo) * 1e-6,
        "busy_s": union_length(device) * 1e-6,
        "kernels": kernels,
        "launches": launches,
        "ops": ops,
        "gaps": gaps,
    }
