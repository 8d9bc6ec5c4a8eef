"""Tiny Prometheus-text-format metrics registry for the port's replica,
and the spans of a traced run.

The port's own copy of the part of ``tpushare/metrics.py`` the serving
replica uses (counters, histograms, scrape-time gauges), with the same
exposition text, so a scrape of a torch replica reads like one of a JAX
replica. :func:`span` records where the work happens while a
``torch.profiler`` session runs, and :func:`last_session` reads them.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Callable

import torch
from torch.autograd import profiler as _profiler


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


class Counter:
    def __init__(self, name: str, help_: str) -> None:
        self.name, self.help = name, help_
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def expose(self) -> str:
        return (f"# HELP {self.name} {_escape_help(self.help)}\n"
                f"# TYPE {self.name} counter\n"
                f"{self.name} {self.value}\n")


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, name: str, help_: str,
                 buckets: tuple[float, ...]) -> None:
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = next((i for i, b in enumerate(self.buckets) if v <= b),
                 len(self.buckets))
        with self._lock:
            self._sum += v
            self._counts[i] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    def expose(self) -> str:
        with self._lock:
            counts = list(self._counts)
            s = self._sum
        total = sum(counts)
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += counts[i]
            out.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {s}")
        out.append(f"{self.name}_count {total}")
        return "\n".join(out) + "\n"


class Registry:
    def __init__(self) -> None:
        self._metrics: list = []
        self._gauges: list[tuple[str, str,
                                 Callable[[], list[tuple[str, float]]]]] = []

    def counter(self, name: str, help_: str) -> Counter:
        c = Counter(name, help_)
        self._metrics.append(c)
        return c

    def histogram(self, name: str, help_: str,
                  buckets: tuple[float, ...]) -> Histogram:
        h = Histogram(name, help_, buckets)
        self._metrics.append(h)
        return h

    def gauge_func(self, name: str, help_: str,
                   fn: Callable[[], list[tuple[str, float]]]) -> None:
        """Gauge computed at scrape time; fn returns (labels, value) pairs
        where labels is the rendered label string ('' for none)."""
        self._gauges.append((name, help_, fn))

    def expose(self) -> str:
        parts = [m.expose() for m in self._metrics]
        for name, help_, fn in self._gauges:
            lines = [f"# HELP {name} {_escape_help(help_)}",
                     f"# TYPE {name} gauge"]
            try:
                for labels, value in fn():
                    lines.append(f"{name}{labels} {value}")
            except Exception:  # noqa: BLE001 — one gauge must not fail
                continue       # the whole scrape
            parts.append("\n".join(lines) + "\n")
        return "".join(parts)


# latency buckets of the reference registry (seconds)
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)


# -- spans ---------------------------------------------------------------------
# Program spans for a traced run, kept in memory on the host clock
# ``time.time_ns()``. They record only while a ``torch.profiler`` session
# runs in the process: ``torch.autograd.profiler._is_profiler_enabled`` is
# process-wide, so the serving engine's own thread sees it (the profiler's
# per-thread state and ``record_function`` do not reach that thread). Each
# session starts an empty store; :func:`last_session` reads it.

_store: list = []
_ids = itertools.count()
_local = threading.local()


def new_session() -> None:
    """Empty the store: the spans recorded from here on are the next
    :func:`last_session`. Every profiler session calls it as it starts."""
    global _store
    _store = []


def _reset_on_profiler_start() -> None:
    """Every profiler session (``torch.profiler.profile`` and the autograd
    profiler) starts by calling ``torch.autograd.profiler.
    _run_on_profiler_start``; wrap it so that it calls :func:`new_session`
    first. Where a torch release has no such hook, spans still record
    while a profiler runs, and only :func:`new_session` empties the
    store."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None:
        logging.getLogger(__name__).warning(
            "torch %s has no torch.autograd.profiler._run_on_profiler_start:"
            " program spans of successive profiler sessions are kept "
            "together until metrics.new_session()", torch.__version__)
        return
    if getattr(start, "resets_spans", False):
        return

    def run_on_profiler_start(*args, **kwargs):
        new_session()
        return start(*args, **kwargs)

    run_on_profiler_start.resets_spans = True
    _profiler._run_on_profiler_start = run_on_profiler_start


_reset_on_profiler_start()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """What :func:`span` returns while nothing records: every method is a
    no-op and the object is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def begin(self):
        return self

    def end(self) -> None:
        return None

    def add(self, **attrs) -> None:
        return None


OFF = _Off()


class Span:
    """One recorded span: ``name``, ``id``, ``parent`` (the id of the
    innermost span open on the thread that began it, or None), ``rid``
    (the request id its spans share across threads), ``thread``,
    ``start_ns`` and ``end_ns`` on ``time.time_ns()``, ``attrs``, and
    ``device_ms`` (the CUDA time between its two events, or None).

    Used as a context manager it is the innermost span of its thread
    while open; :meth:`begin` and :meth:`end` bracket a span that another
    thread may end."""

    __slots__ = ("name", "id", "parent", "rid", "thread", "start_ns",
                 "end_ns", "attrs", "device_ms", "_events", "_store")

    def __init__(self, name: str, rid, device: bool, attrs: dict):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.id = next(_ids)
        self.parent = self.thread = self.start_ns = self.end_ns = None
        self.device_ms = None
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if device else None)
        self._store = _store

    def __bool__(self) -> bool:
        return True

    def begin(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.current_thread().name
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def end(self) -> None:
        if self.end_ns is not None:
            return
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        self._store.append(self)

    def add(self, **attrs) -> None:
        """Attach counts as they become known; a 0-d device tensor is
        read when the records are."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self.begin()
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        self.end()

    def _resolve(self) -> None:
        if self._events is not None:
            self._events[1].synchronize()
            self.device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None
        for k, v in self.attrs.items():
            if isinstance(v, torch.Tensor):
                self.attrs[k] = v.item()


def span(name: str, rid=None, device: bool = False, **attrs):
    """A span of the program, recorded while a profiler session runs and
    :data:`OFF` otherwise (one attribute read). ``device=True`` on a CUDA
    path also records a CUDA timing event at its start and end, resolved
    by :func:`last_session`, with no synchronisation before."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name, rid, device, attrs)


def last_session() -> list:
    """The ended spans of the last profiler session, in the order they
    ended, their device times and device counts read (which waits for
    the device)."""
    spans = list(_store)
    for s in spans:
        s._resolve()
    return spans
