"""Spans recorded from the benchmark's side around the calls into each
layer of the program, and the reduction of the profiler's device trace
over a window to busy time, kernel time by name, and idle gaps named by
what the host was doing in them.

Spans are kept in memory (name, host start and end in ns, thread) and
also opened as ``torch.profiler.record_function`` ranges, so they show in
the trace under the same names. The window's own range maps the host
clock onto the trace's."""

from __future__ import annotations

import bisect
import contextlib
import threading
import time

import torch

WINDOW = "bench.window"


def sync() -> None:
    """Wait for the device, where the run has one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Spans:
    """A list of host spans, recorded only while ``on``."""

    def __init__(self):
        self.on = False
        self.items: list[tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                t1 = time.time_ns()
                with self._lock:
                    self.items.append((name, t0, t1, threading.get_ident()))

    def wrap(self, fn, name: str):
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped


class DeviceTrace:
    """``torch.profiler`` over the window: device operations on the CUDA
    side, the window's range on the host side."""

    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        self._cuda = device.startswith("cuda")
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # a first profiled pass pays the profiler's own imports and its
        # device tracer's start-up, here and not inside the window
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda" if self._cuda else "cpu").add_(1)
        self._prof = torch.profiler.profile(activities=acts)
        self._range = None
        self.host_start_ns = self.host_end_ns = 0

    def start(self):
        self._prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self.host_start_ns = time.time_ns()
        self._range.__enter__()

    def close_window(self):
        """End the window's range; the profiler records on until
        :meth:`stop`, and the summary reads the window alone."""
        if self._cuda:
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.host_end_ns = time.time_ns()

    def stop(self):
        self._prof.stop()

    def summary(self, spans: Spans, top: int = 10) -> dict:
        """``{"busy_s", "window_s", "kernel_s": {name: s}, "device_ops":
        [[name, s]...], "idle_gaps": [[host activity, s]...]}`` over the
        window, each device operation clipped to it. Busy time is the
        union of every device operation's interval (kernels, copies,
        sets)."""
        events = self._prof.profiler.kineto_results.events()
        w0 = w1 = None
        dev = []
        for ev in events:
            name = ev.name()
            on_cuda = str(ev.device_type()).endswith("CUDA")
            if name == WINDOW and not on_cuda:
                w0, w1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            elif on_cuda and not ev.is_user_annotation() \
                    and not name.startswith(("bench.", "engine.", "frontend.",
                                             "train.", "moe.", "adamw.")):
                dev.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                            name))
        if w0 is None:
            w0 = min((s for s, _, _ in dev), default=0)
            w1 = w0 + (self.host_end_ns - self.host_start_ns)
        offset = w0 - self.host_start_ns
        dev = [(max(s, w0), min(e, w1), name) for s, e, name in dev
               if e > w0 and s < w1]
        kernel_ns: dict[str, int] = {}
        for s, e, name in dev:
            kernel_ns[name] = kernel_ns.get(name, 0) + (e - s)
        clipped = sorted((s, e) for s, e, _ in dev)
        busy, gaps, cursor = 0, [], w0
        for s, e in clipped:
            if s > cursor:
                gaps.append((cursor, s))
            if e > cursor:
                busy += e - max(s, cursor)
                cursor = e
        if cursor < w1:
            gaps.append((cursor, w1))
        bounds, labels = _innermost([(s + offset, e + offset, name)
                                     for name, s, e, _ in spans.items])
        idle: dict[str, int] = {}
        for g0, g1 in gaps:
            i = bisect.bisect_right(bounds, (g0 + g1) // 2) - 1
            label = labels[i] if 0 <= i < len(labels) else None
            label = label or "host: no benchmark span"
            idle[label] = idle.get(label, 0) + (g1 - g0)
        ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:top]
        gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
                "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
                "device_ops": [[k, v / 1e9] for k, v in ops],
                "idle_gaps": [[k, v / 1e9] for k, v in gap_list]}


def _innermost(host: list) -> tuple[list, list]:
    """The boundaries of the host spans, sorted, and for each stretch
    between two of them the name of the shortest span covering it (None
    where none does)."""
    bounds = sorted({t for s, e, _ in host for t in (s, e)})
    labels = []
    for a, b in zip(bounds, bounds[1:]):
        mid = (a + b) / 2
        inner = [(e - s, name) for s, e, name in host if s <= mid < e]
        labels.append(min(inner)[1] if inner else None)
    return bounds, labels


def kernel_seconds(summary: dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any needle."""
    return sum(s for name, s in summary["kernel_s"].items()
               if any(n in name for n in needles))
