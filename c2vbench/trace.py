"""The traced window: ``torch.profiler`` over the device and the host, and
its reduction to device-busy time, kernel times by name and by the
benchmark's own marks, and a breakdown of device operations and idle gaps.

The benchmark marks its calls into a layer itself (:meth:`Profiler.mark`:
a name and the call's start and end on the host's wall clock), from
whatever thread makes them: the profiler records host ranges only on the
thread that started it, and not at all with host operators off. Its
timestamps are wall-clock nanoseconds too, but its clock ran 0.05-4.4 ms
off ``time.time_ns()`` on the H100 machines, so the marks are moved by the
gap between the two clocks, read at the start edge's launch. A device
operation belongs to the mark whose interval holds its start: a marked
serving call waits for its device work (it copies its results back). The
raw kineto events are read once; the profiler's own per-event objects are
never built. Host ranges mirrored on the device's timeline (GPU user
annotations) are not device work and are left out.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from dataclasses import dataclass, field

# how many of the longest idle gaps are traced back to what the host did
GAPS_ATTRIBUTED = 400


class Profiler:
    """``torch.profiler`` over the device and the CUDA calls of the host,
    started and stopped around a window. The profiler records no host
    operator (recording them slowed the host enough, on one H100 machine,
    to idle the card 26% of a traced top11 window against 2-3% elsewhere);
    the window's edges are two one-element kernels launched on a drained
    device, so both lie on the device's clock. ``idle_label`` names what
    the host does in a gap no CUDA call or mark covers."""

    def __init__(self, idle_label: str = "host idle"):
        self._prof = None
        self._edge = None
        self._lock = threading.Lock()
        self.marks: list = []  # (start ns, end ns, name)
        self.idle_label = idle_label
        self.started_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        # drained first: the traced window holds only the work enqueued in it
        torch.cuda.synchronize()
        self._edge = torch.zeros(1, device="cuda")
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.started_ns = time.time_ns()
        self._edge.add_(1.0)

    def mark(self, name: str, start_ns: int, end_ns: int) -> None:
        with self._lock:
            self.marks.append((start_ns, end_ns, name))

    def stop(self) -> "TraceSummary":
        import torch

        torch.cuda.synchronize()
        self._edge.add_(1.0)
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        return reduce_events(events, self.marks, self.idle_label, self.started_ns)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # (short name, seconds, mark or None) of every device operation in the window
    ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds], ...]
    clock_skew_us: float = 0.0  # the window's start: the profiler's clock less the host's

    def time_of(self, pattern: str) -> tuple[float, int]:
        """Seconds and count of the device operations whose name matches
        ``pattern`` (a regex)."""
        rx = re.compile(pattern)
        sec, n = 0.0, 0
        for name, s, _ in self.ops:
            if rx.search(name):
                sec += s
                n += 1
        return sec, n

    def tagged(self, pattern: str, tag_prefix: str) -> dict:
        """``{mark: (seconds, count)}`` of the matching operations by the
        mark they ran in."""
        rx = re.compile(pattern)
        out: dict = {}
        for name, s, t in self.ops:
            if t is not None and t.startswith(tag_prefix) and rx.search(name):
                sec, n = out.get(t, (0.0, 0))
                out[t] = (sec + s, n + 1)
        return out

    def breakdown(self) -> dict:
        by_name: dict = {}
        for name, s, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": self.idle_gaps[:10]}


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its trailing argument list."""
    name = name[5:] if name.startswith("void ") else name
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if i > 0 else name
    return name


def _union(intervals: list) -> tuple[float, list]:
    """Total covered length of ``[(start, end)]`` and the merged intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class _Intervals:
    """Named host intervals, the innermost (latest started) holding a time."""

    def __init__(self, spans: list):
        self.spans = sorted(spans)  # (start, end, name)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: int, limit: int = 64):
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(i - 1 - limit, -1), -1):
            s, e, name = self.spans[j]
            if e >= t:
                return name
        return None


def reduce_events(events, marks: list, idle_label: str = "host idle",
                  started_ns: int = 0) -> TraceSummary:
    """The window runs from the first device operation (the start edge) to
    the end of the last (the stop edge)."""
    from torch.autograd import DeviceType

    device, host, launches, runtime = [], {}, {}, {}
    for ev in events:
        dt = ev.device_type()
        if dt == DeviceType.CUDA:
            if not ev.is_user_annotation():  # a host range mirrored on the device's timeline
                device.append((ev.start_ns(), ev.end_ns(), ev.name(), ev.correlation_id()))
            continue
        if dt != DeviceType.CPU:
            continue
        name, tid = ev.name(), ev.start_thread_id()
        if name.startswith("cu"):
            launches[tid] = launches.get(tid, 0) + 1
            runtime[ev.correlation_id()] = ev.start_ns()
        host.setdefault(tid, []).append((ev.start_ns(), ev.end_ns(), name))
    if not device:
        raise RuntimeError("the trace holds no device operation")
    first = min(device)
    w0, w1 = first[0], max(e for _, e, _, _ in device)
    # the marks on the profiler's clock: the start edge's launch, read on both
    launched = runtime.get(first[3])
    skew = launched - started_ns if launched is not None and started_ns else 0
    marked = _Intervals([(s + skew, e + skew, n) for s, e, n in marks])
    ops, intervals = [], []
    for s, e, name, _ in device:
        intervals.append((s, e))
        ops.append((short_name(name), (e - s) / 1e9, marked.at(s)))
    busy, merged = _union(intervals)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    # what the host did in a gap: the CUDA call of the thread that made the
    # most of them, else the benchmark's mark
    main = max(launches, key=launches.get) if launches else None
    calls_of_main = _Intervals(host.get(main, []))
    by_activity: dict = {}
    for length, s, e in gaps[:GAPS_ATTRIBUTED]:
        mid = (s + e) // 2
        what = calls_of_main.at(mid, limit=4096) or marked.at(mid) or idle_label
        by_activity[what] = by_activity.get(what, 0.0) + length / 1e9
    rest = sum(g[0] for g in gaps[GAPS_ATTRIBUTED:]) / 1e9
    if rest:
        by_activity["shorter gaps"] = rest
    idle = sorted(([k, v] for k, v in by_activity.items()), key=lambda kv: -kv[1])
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops, idle_gaps=idle,
                        clock_skew_us=skew / 1e3)
