"""The one general generator of serving traffic, read from a traffic
file's parameters.

An open loop: requests are due on a schedule whatever the replica does.
Every seed gets the same set of sizes and arrival gaps, taken at fixed
quantiles of the mix's distributions, in another order: the seed
permutes the gaps, the prompt lengths and the output lengths apart, and
draws the prompts' token ids. So runs with different seeds do the same
work and differ in how it falls.

Distributions (``{"dist": ...}``): ``lognormal`` (``median``, ``sigma``),
``uniform`` (``min``, ``max``), ``fixed`` (``value``); lognormal and
uniform lengths are clipped to ``[min, max]``. Arrival gaps are
exponential at ``rate_per_s`` (Poisson arrivals).
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics

import torch


@dataclasses.dataclass
class Request:
    index: int
    at: float           # seconds after the window opens
    prompt: list[int]
    max_new: int


def _quantiles(n: int) -> list[float]:
    return [(i + 0.5) / n for i in range(n)]


def lengths(dist: dict, n: int) -> list[int]:
    """n lengths at the distribution's fixed quantiles, in order."""
    kind = dist["dist"]
    if kind == "fixed":
        return [int(dist["value"])] * n
    lo, hi = dist["min"], dist["max"]
    if kind == "lognormal":
        z = statistics.NormalDist()
        vals = [math.exp(math.log(dist["median"]) + dist["sigma"]
                         * z.inv_cdf(u)) for u in _quantiles(n)]
    elif kind == "uniform":
        vals = [lo + u * (hi - lo) for u in _quantiles(n)]
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return [min(hi, max(lo, round(v))) for v in vals]


def gaps(rate: float, n: int) -> list[float]:
    """n exponential inter-arrival gaps at their fixed quantiles."""
    return [-math.log(1.0 - u) / rate for u in _quantiles(n)]


def count(params: dict, seconds: float) -> int:
    return max(1, round(params["rate_per_s"] * seconds))


def schedule(params: dict, seed: int, seconds: float, vocab: int,
             rate: float | None = None) -> list[Request]:
    """The requests due in a window of ``seconds``, in the order due.
    ``rate`` overrides the file's (a sweep's)."""
    rate = params["rate_per_s"] if rate is None else rate
    n = max(1, round(rate * seconds))
    rng = random.Random(int(seed))
    g = gaps(rate, n)
    p = lengths(params["prompt"], n)
    o = lengths(params["output"], n)
    for xs in (g, p, o):
        rng.shuffle(xs)
    gen = torch.Generator().manual_seed(rng.getrandbits(62))
    ids = torch.randint(vocab, (sum(p),), generator=gen).tolist()
    out, t, pos = [], 0.0, 0
    for i in range(n):
        out.append(Request(i, t, ids[pos:pos + p[i]], o[i]))
        pos += p[i]
        t += g[i]
    return out
