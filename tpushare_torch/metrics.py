"""Tiny Prometheus-text-format metrics registry for the port's replica.

The port's own copy of the part of ``tpushare/metrics.py`` the serving
replica uses (counters, histograms, scrape-time gauges), with the same
exposition text, so a scrape of a torch replica reads like one of a JAX
replica.
"""

from __future__ import annotations

import threading
from typing import Callable


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
