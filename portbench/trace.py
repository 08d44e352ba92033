"""The traced run: ``torch.profiler`` over a short window, reduced to what
the per-layer readers and the result line need.

The benchmark's own spans (``portbench.window``, ``portbench.step``,
``portbench.embed``, ``portbench.copy``) mark what the host was doing; the
trace's device events (kernels, copies, fills) say what the card did. The
profiler records the operations of the thread that started it only, so the
spans are also kept in memory, from every thread, on the host's clock, and
placed on the trace's clock by the window span, which is in both. The
profiler writes its Chrome trace to a temporary file under ``TMPDIR``, which
is read back and deleted at once.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW_SPAN = "portbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


Span = Tuple[str, int, float, float]     # name, thread, start, end (host seconds)


class Tracer:
    """Spans cost nothing when the run is not traced."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.spans: List[Span] = []

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        import torch
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.spans.append((name, threading.get_ident(), t0, time.perf_counter()))

    def start(self) -> None:
        if self.enabled:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def stop(self) -> Optional["TraceView"]:
        if self._prof is None:
            return None
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return TraceView(events, self.spans)


class TraceView:
    """Device intervals and host spans of the traced window, in seconds."""

    def __init__(self, events: List[dict], spans: List[Span] = ()):
        windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
                   and e.get("cat") == "user_annotation"]
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        w = windows[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        own_start = [t0 for n, _, t0, _ in spans if n == WINDOW_SPAN]
        offset = self.t0 - 1e6 * own_start[0] if own_start else 0.0
        # the benchmark's spans of every thread, on the trace's clock (us)
        self.spans = [(n, 1e6 * a + offset, 1e6 * b + offset) for n, _, a, b in spans
                      if n != WINDOW_SPAN]
        self.device = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"]))
                       for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                       and self.t0 <= float(e["ts"]) < self.t1]
        self.device.sort(key=lambda d: d[2])
        self.host = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"]), e.get("tid"))
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("user_annotation", "cpu_op")
                     and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window, in microseconds."""
        merged: List[List[float]] = []
        for _, _, ts, dur in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, pattern: str) -> List[Tuple[str, float]]:
        """(name, seconds) of each kernel whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [(n, d / 1e6) for n, c, _, d in self.device if c == "kernel" and rx.search(n)]

    def kernel_seconds(self, pattern: str) -> float:
        return sum(s for _, s in self.kernels(pattern))

    def attributed_seconds(self, owner: str, follower: str, others: str) -> float:
        """Seconds of the kernels matching ``owner``, plus those matching
        ``follower`` (a kernel shared by several callers) whose latest
        preceding kernel matching ``owner`` or ``others`` is the owner's."""
        ro, rf, rx = re.compile(owner), re.compile(follower), re.compile(others)
        total, last = 0.0, None
        for n, c, _, d in self.device:
            if c != "kernel":
                continue
            if ro.search(n):
                total, last = total + d, "owner"
            elif rf.search(n):
                total += d if last == "owner" else 0.0
            elif rx.search(n):
                last = "other"
        return total / 1e6

    def copy_seconds(self, kind: str) -> float:
        """Seconds of the memcpy events whose name holds ``kind`` ('HtoD', ...)."""
        return sum(d for n, c, _, d in self.device if c == "gpu_memcpy" and kind in n) / 1e6

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host span or operation over each."""
        by_name: Dict[str, float] = {}
        for n, _, _, d in self.device:
            key = _short(n)
            by_name[key] = by_name.get(key, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                      reverse=True)[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[n, s / 1e6] for n, s in ops],
                "idle_gaps": [[self.host_label((a + b) / 2), g / 1e6] for g, a, b in gaps]}

    def host_label(self, t: float) -> str:
        """What the host was doing at time ``t``: the benchmark's spans open
        then, each with the number of threads in it, then the innermost
        annotation and operation the profiler recorded in its own thread."""
        open_spans = collections.Counter(n for n, a, b in self.spans if a <= t < b)
        parts = [" ".join(f"{n} x{c}" for n, c in sorted(open_spans.items()))] \
            if open_spans else []
        if self.host:
            ts = np.array([h[2] for h in self.host])
            te = ts + np.array([h[3] for h in self.host])
            idx = np.nonzero((ts <= t) & (t < te))[0]
            notes = [self.host[i] for i in idx if self.host[i][1] == "user_annotation"
                     and not self.host[i][0].startswith("portbench.")]
            ops = [self.host[i] for i in idx if self.host[i][1] == "cpu_op"]
            parts += [min(group, key=lambda h: h[3])[0] for group in (notes, ops) if group]
        return _short("/".join(parts)) if parts else "host: no span"


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."
