"""Reductions of the traced window: the device's busy union, its idle gaps
named by what the host was doing, and the heaviest device operations.

Device intervals come from ``torch.profiler`` (CUPTI) in the profiler's
clock (nanoseconds of the Unix epoch); the program's spans come from its
tracer in ``time.perf_counter`` microseconds. ``offset_ns`` carries the
second into the first.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(MEMORY_OPS)


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int   # in the profiler's clock
    end_ns: int


def device_ops(prof) -> List[DeviceOp]:
    """Every device activity the profiler recorded, sorted by start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = [DeviceOp(e.name(), int(e.start_ns()),
                    int(e.start_ns()) + int(e.duration_ns()))
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    out.sort(key=lambda o: o.start_ns)
    return out


def program_spans(events: Sequence[dict], offset_ns: int) -> List[Span]:
    """The program tracer's complete events, moved to the profiler's clock."""
    return sorted((Span(e["name"], int(e["ts"] * 1e3) + offset_ns,
                        int((e["ts"] + e["dur"]) * 1e3) + offset_ns)
                   for e in events if e.get("ph") == "X"),
                  key=lambda s: (s.start_ns, -s.end_ns))


def busy_intervals(ops: Sequence[DeviceOp]) -> List[Tuple[int, int]]:
    """The union of the device intervals, merged and sorted."""
    out: List[List[int]] = []
    for op in ops:
        if out and op.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end_ns)
        else:
            out.append([op.start_ns, op.end_ns])
    return [(a, b) for a, b in out]


def busy_seconds(intervals) -> float:
    return sum(b - a for a, b in intervals) / 1e9


def innermost(spans: Sequence[Span]) -> List[Tuple[int, int, str]]:
    """The timeline of the innermost open span: (start, end, name)."""
    bounds = sorted({s.start_ns for s in spans} | {s.end_ns for s in spans})
    out: List[Tuple[int, int, str]] = []
    stack: List[Span] = []
    i = 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i].start_ns <= a:
            stack.append(spans[i])
            i += 1
        stack = [s for s in stack if s.end_ns > a]
        if stack:
            top = min(stack, key=lambda s: s.end_ns - s.start_ns)
            if out and out[-1][2] == top.name and out[-1][1] == a:
                out[-1] = (out[-1][0], b, top.name)
            else:
                out.append((a, b, top.name))
    return out


def idle_by_host(intervals, spans: Sequence[Span], lo: int, hi: int,
                 outside: str = "engine_loop") -> Dict[str, float]:
    """Seconds the device sat idle in [lo, hi], by the innermost program
    span open at the time (``outside`` where none was)."""
    gaps: List[Tuple[int, int]] = []
    cur = lo
    for a, b in intervals:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    line = innermost(spans)
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in gaps:
        if b <= a:
            continue
        while j < len(line) and line[j][1] <= a:
            j += 1
        t, k = a, j
        while t < b:
            if k < len(line) and line[k][0] <= t:
                end = min(line[k][1], b)
                out[line[k][2]] += (end - t) / 1e9
                t = end
                k += 1
            else:
                end = min(line[k][0], b) if k < len(line) else b
                out[outside] += (end - t) / 1e9
                t = end
    return dict(out)


def top_ops(ops: Sequence[DeviceOp], n: int = 10) -> List[List]:
    """The n device operations that took most time: [name, seconds]."""
    total: Dict[str, float] = defaultdict(float)
    for op in ops:
        total[op.name] += (op.end_ns - op.start_ns) / 1e9
    best = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], sec] for name, sec in best]


def self_seconds(spans: Sequence[Span], names: Sequence[str]) -> float:
    """Summed self time of the spans named ``names``: each one's length
    less what the spans nested in it cover."""
    total = 0
    wanted = set(names)
    for i, s in enumerate(spans):
        if s.name not in wanted:
            continue
        covered, cur = 0, s.start_ns
        for c in spans[i + 1:]:
            if c.start_ns >= s.end_ns:
                break
            if c.end_ns <= s.end_ns and c.start_ns >= cur:
                covered += c.end_ns - c.start_ns
                cur = c.end_ns
        total += (s.end_ns - s.start_ns) - covered
    return total / 1e9
