"""The device side of a traced stretch of the run, from ``torch.profiler``.

``union_us``, ``idle_share`` and ``Trace`` are frozen copies of
``idocp_tpu_torch/tools/runtime_profile.py`` (the union of the profiler's
kernel, memcpy and memset intervals over a window that starts at the first
launch); the benchmark keeps its own so that the program cannot change the
yardstick. Added here: the host launches that fall inside named host ranges,
the device time of named kernels, the top device operations and the longest
idle gaps labelled with the host operation running during each.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def idle_share(intervals, window_start):
    """1 - (union of the device's busy intervals) / (the window from
    ``window_start``, the first launch, to the end of the last interval)."""
    intervals = list(intervals)
    if not intervals:
        raise ValueError("no device activity in the window")
    window = max(end for _, end in intervals) - window_start
    return 1.0 - union_us(intervals) / window


@dataclasses.dataclass
class Trace:
    """Device spans (name, start, end) in µs, the host launches (start µs,
    name), host ranges (name, start, end) of the names asked for, and every
    host operation (name, start, end) for labelling idle gaps."""
    device: list
    launches: list
    ranges: list
    host_ops: list

    @classmethod
    def from_events(cls, events, range_names=()):
        spans = [e for e in events if e.get("ph") == "X"]
        device = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in spans if e.get("cat") in DEVICE_CATS]
        launches = [(float(e["ts"]), e["name"]) for e in spans
                    if e.get("cat") in LAUNCH_CATS
                    and any(w in e["name"] for w in LAUNCH_WORDS)]
        ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in spans if e.get("cat") == "user_annotation"
                  and e["name"] in range_names]
        host = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in spans if e.get("cat") in HOST_CATS]
        return cls(sorted(device, key=lambda d: d[1]), sorted(launches),
                   ranges, host)

    def intervals(self):
        return [(start, end) for _, start, end in self.device]

    @property
    def first_launch_us(self):
        return min((t for t, _ in self.launches), default=float("nan"))

    @property
    def busy_us(self):
        return union_us(self.intervals())

    @property
    def window_us(self):
        return max(end for _, end in self.intervals()) - self.first_launch_us

    def idle_share(self):
        return idle_share(self.intervals(), self.first_launch_us)

    def launches_in(self, name):
        """Host launches of kernels, copies and sets inside the ranges
        called ``name``, and the number of those ranges."""
        spans = [(s, e) for n, s, e in self.ranges if n == name]
        count = sum(1 for t, _ in self.launches
                    if any(s <= t <= e for s, e in spans))
        return count, len(spans)

    def device_us_of(self, words):
        """Device µs and count of the spans whose name holds any of
        ``words``."""
        hits = [(s, e) for n, s, e in self.device if any(w in n for w in words)]
        return sum(e - s for s, e in hits), len(hits)

    def top_ops(self, k=10):
        """The k device operations that took most time: [name, seconds]."""
        out = {}
        for name, start, end in self.device:
            out[name] = out.get(name, 0.0) + (end - start)
        rows = sorted(out.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], us * 1e-6] for name, us in rows]

    def idle_gaps(self, k=10):
        """Idle time between device spans grouped by the innermost host
        operation running at each gap's start: [name, seconds], the k
        largest."""
        gaps, reach = [], self.first_launch_us
        for _, start, end in self.device:
            if start > reach:
                gaps.append((reach, start))
            reach = max(reach, end)
        # sweep: the host operations open at a gap's start, innermost last
        ops = sorted(self.host_ops, key=lambda o: (o[1], -o[2]))
        by, stack, i = {}, [], 0
        for g0, g1 in sorted(gaps):
            while i < len(ops) and ops[i][1] <= g0:
                while stack and stack[-1][2] <= ops[i][1]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][2] <= g0:
                stack.pop()
            label = stack[-1][0][:120] if stack else "(no host op)"
            by[label] = by.get(label, 0.0) + (g1 - g0)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us * 1e-6] for name, us in rows]


def trace(fn, range_names=()):
    """fn() once under ``torch.profiler`` (CPU and CUDA activities), the
    queue drained before and after. Returns (fn's result, Trace)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Trace.from_events(events, range_names)
