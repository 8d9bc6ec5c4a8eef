"""The serving driver: the port's replica, ``serve._EngineFrontend`` over
``engine.DecodeEngine``, on int8 weights, under the cell's HBM grant,
fed by an open loop of requests from the traffic file.

Set-up: the grant's environment, the weights drawn from the seed and
quantised by the port's ``quantize_int8``, the engine and its frontend,
then one request at each prompt bucket the traffic will use (the prefill
shapes and the decode quantum). The window: each request is sent when it
is due, by a thread that reads its stream from ``generate_stream``. Its
time to first token runs from when it was due to the first token the
stream yields; its time per output token is (last token's time - first
token's time) / (tokens - 1). Requests due in the window are waited for
up to a minute past its close. Then the replica is freed and the served
tokens of a sample are held against the reference."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import statistics
import threading
import time

import torch

from benchmark import arith, cells, check, traffic as gen, weights
from benchmark.drivers import port_config
from benchmark.trace import DeviceTrace, Spans

DRAIN_S = 60.0


@dataclasses.dataclass
class Served:
    index: int
    due: float
    prompt: list
    max_new: int
    tokens: list = dataclasses.field(default_factory=list)
    first: float | None = None
    last: float | None = None
    error: str | None = None
    done: bool = False

    @property
    def ok(self) -> bool:
        return self.done and self.error is None \
            and len(self.tokens) == self.max_new


def buckets(lengths: list, max_len: int) -> dict:
    """The prefill shape each prompt length takes (a power of two from 8,
    capped at the slot's length) -> the longest length that takes it."""
    out = {}
    for n in lengths:
        b = 8
        while b < n:
            b *= 2
        b = min(b, max_len)
        out[b] = max(out.get(b, 0), n)
    return out


def percentile(values: list, q: int) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


@contextlib.contextmanager
def replica(ctx, m: dict, lengths: list):
    """The replica of the cell, set up and warmed for prompts of
    ``lengths``: yields its started ``_EngineFrontend``; on exit stops it
    and frees its state, and lifts the grant again."""
    tr = ctx.cell["traffic"]
    cuda = ctx.device.startswith("cuda")
    if cuda:
        from tpushare_torch.contract import ENV_HBM_CHIP_TOTAL, ENV_HBM_LIMIT
        from tpushare_torch.workloads.hbm import apply_hbm_gating
        os.environ[ENV_HBM_LIMIT] = str(tr["grant_mib"])
        os.environ[ENV_HBM_CHIP_TOTAL] = str(tr["chip_total_mib"])
        apply_hbm_gating()
    from tpushare_torch.workloads.engine import DecodeEngine
    from tpushare_torch.workloads.hbm import apply_memory_fraction
    from tpushare_torch.workloads.model import quantize_int8
    from tpushare_torch.workloads.serve import _EngineFrontend

    dev = torch.device(ctx.device)
    if cuda:
        torch.cuda.set_device(dev)
    cfg = port_config(ctx.cell["config"], tr)
    with torch.inference_mode():
        params = weights.draw(m, ctx.seed, dev)
        if tr.get("quant") == "int8":
            params = quantize_int8(params)
    gc.collect()
    ctx.mark("weights drawn and quantised")
    if cuda:
        torch.cuda.empty_cache()
        apply_memory_fraction()
        torch.cuda.reset_peak_memory_stats(dev)
    eng_cfg = tr["engine"]
    engine = DecodeEngine(params, cfg, eng_cfg["slots"], eng_cfg["max_len"],
                          quantum=eng_cfg["quantum"])
    front = _EngineFrontend(engine)
    front.start()
    try:
        warm = buckets(lengths, eng_cfg["max_len"])
        wgen = torch.Generator().manual_seed(weights.stream_seed(ctx.seed,
                                                                 "warm"))
        front.generate_many(
            [torch.randint(m["V"], (n,), generator=wgen).tolist()
             for n in warm.values()], eng_cfg["quantum"] + 1)
        if cuda:
            torch.cuda.synchronize(dev)
        ctx.mark(f"{len(warm)} prefill shapes and a quantum warmed")
        yield front
    finally:
        front.stop()
        front.join(timeout=DRAIN_S)
        del front, engine, params
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(1.0, dev)


def summarize(served: list) -> dict:
    """The window's end-to-end numbers; a request that failed counts as
    missing every limit."""
    ttft = [r.first - r.due if r.ok else float("inf") for r in served]
    tpot = [(r.last - r.first) / (len(r.tokens) - 1)
            for r in served if r.ok and len(r.tokens) > 1]
    p95 = percentile(ttft, 95)
    return {"ttft_p95_ms": p95 * 1e3 if p95 != float("inf") else None,
            "tpot_p95_ms": percentile(tpot, 95) * 1e3 if tpot else None}


def run(ctx) -> dict:
    tr = ctx.cell["traffic"]
    m = cells.model_sizes(ctx.cell["config"])
    sched = gen.schedule(tr, ctx.seed, ctx.seconds, m["V"])
    rec: dict = {"model": m, "window": m["window"]}
    with replica(ctx, m, [len(r.prompt) for r in sched]) as front:
        spans = Spans()
        undo: list = []
        try:
            if ctx.trace:
                _instrument(front.engine, spans, rec, m, undo)
            trace = DeviceTrace(ctx.device) if ctx.trace else None
            served = _window(ctx, front, sched, spans, rec, trace)
            if ctx.device.startswith("cuda"):
                rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                    torch.device(ctx.device))
        finally:
            while undo:
                undo.pop()()
    t0 = time.perf_counter()
    picked = check.sample([r for r in served if r.ok],
                          tr["check"]["sample"], ctx.seed)
    numbers = check.serve_numbers(m, ctx.seed, tr, picked,
                                  torch.device(ctx.device))
    ctx.log(f"reference over {len(picked)} requests, "
            f"{sum(len(r.tokens) for r in picked)} served tokens: "
            f"{time.perf_counter() - t0:.1f} s")
    return {"attempted": len(served),
            "failed": sum(not r.ok for r in served),
            "end_to_end": summarize(served), "record": rec,
            "numbers": {"served_gap": numbers["served_gap"]},
            "served": served, "picked": picked}


def _window(ctx, front, sched, spans, rec, trace) -> list:
    """Send each request when due; return them once each has ended or a
    minute past the window's close."""
    served = [Served(r.index, 0.0, r.prompt, r.max_new) for r in sched]

    def consume(s: Served):
        try:
            for delta in front.generate_stream(s.prompt, s.max_new,
                                               timeout=DRAIN_S * 2):
                now = time.perf_counter()
                if delta:
                    if s.first is None:
                        s.first = now
                    s.last = now
                    s.tokens.extend(delta)
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            s.error = f"{type(e).__name__}: {e}"
        s.done = True

    stop = threading.Event()
    depth: list[int] = []
    sampler = threading.Thread(target=_sample_depth,
                               args=(front, stop, depth), daemon=True)
    t0 = time.perf_counter() + 0.01
    ctx.window_open(t0)
    if trace:
        trace.start()
        spans.on = True
        sampler.start()
    threads = []
    for s, r in zip(served, sched):
        s.due = t0 + r.at
        delay = s.due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=consume, args=(s,), daemon=True)
        th.start()
        threads.append(th)
    delay = t0 + ctx.seconds - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    if trace:
        spans.on = False
        stop.set()
        sampler.join()
        trace.close_window()
        rec["queue_depth"] = depth
    rec["window_s"] = time.perf_counter() - t0
    deadline = t0 + ctx.seconds + DRAIN_S
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    if trace:
        # stopped and read once every request has ended: both hold the
        # interpreter for many seconds, which the requests would wait out
        trace.stop()
        rec["trace"] = trace.summary(spans)
    return served


def _sample_depth(front, stop, out: list):
    while not stop.wait(0.05):
        out.append(front.queue_depth)


def _instrument(engine, spans: Spans, rec: dict, m: dict, undo: list):
    """Wrap the engine's calls for the traced run: spans around each,
    a synchronised time for each prefill and each decode quantum, the
    bytes each quantum's steps must move (from the slot table before it
    and the tokens it emitted), and each flash launch's bound."""
    import tpushare_torch.kernels.flash as kflash
    rec.update(prefill=[], quanta=[], flash=[])
    window = m["window"]
    submit, prefill, decode = (engine.submit, engine.prefill_slot,
                               engine.decode_quantum)
    run_quantum = engine.run_quantum

    def prefill_slot(slot, padded, plen, *a):
        t = time.perf_counter()
        with spans.span("engine.prefill_slot"):
            out = prefill(slot, padded, plen, *a)
            if padded.is_cuda:
                torch.cuda.synchronize()
        if spans.on:
            rec["prefill"].append(((time.perf_counter() - t) * 1e3, plen))
        return out

    def decode_quantum(k):
        pos0 = engine.slot_table()[0][1].tolist()
        t = time.perf_counter()
        with spans.span("engine.decode_quantum"):
            block = decode(k)
            emitted = block[:-1].cpu()
        ms = (time.perf_counter() - t) * 1e3
        if spans.on:
            pos, nbytes = list(pos0), 0
            for row in emitted.tolist():
                live = [min(p, window - 1) if window else p
                        for p, t_ in zip(pos, row) if t_ >= 0]
                nbytes += arith.decode_step_bytes(m, live)
                pos = [p + (t_ >= 0) for p, t_ in zip(pos, row)]
            rec["quanta"].append((ms, k, nbytes))
        return block

    fwd = kflash.flash_fwd

    def flash_fwd(q, k, v, causal, window=None, pipelined=False):
        if spans.on and q.is_cuda:
            B, H, S, D = q.shape
            rec["flash"].append(arith.flash_bound(
                B, H, k.shape[1], S, D, q.dtype, causal, window)["bound_ms"])
        return fwd(q, k, v, causal, window=window, pipelined=pipelined)

    kflash.flash_fwd = flash_fwd
    undo.append(lambda: setattr(kflash, "flash_fwd", fwd))
    engine.submit = spans.wrap(submit, "engine.submit")
    engine.prefill_slot = prefill_slot
    engine.decode_quantum = decode_quantum
    engine.run_quantum = spans.wrap(run_quantum, "engine.run_quantum")
