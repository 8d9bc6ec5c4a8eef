"""Co-located int8 serving replica on one CUDA card (BASELINE config #5).

Counterpart of ``tpushare/workloads/serve.py``: the same flags, the same
``POST /generate {"tokens": [[...]], "steps": N}`` surface with NDJSON
streaming, ``/healthz`` and ``/metrics``, plus ``--device`` (default
``cuda``; ``--device cpu`` runs the replica on the CPU). A CUDA request
on a machine without CUDA raises instead of falling back.

:func:`build_server` builds the replica without serving it, so a test or
a smoke script can run ``httpd.serve_forever`` in a thread;
:func:`main` is the command line.

MoE presets serve without ``--engine``, through ``greedy_decode_kv``;
``--engine`` with an MoE preset is a usage error, as in the reference
(capacity routing couples the slots of a batch).

``--tp N`` (default: the visible cards, as the reference lays ``tp``
over its devices; one on the CPU) serves one replica from N ranks, one
process each, which this process starts itself: rank 0 is this process
and owns HTTP. The weights shard Megatron-style over "tp" (MoE presets:
the experts over "ep", on the largest divisor of N that divides the
experts, the rest to "tp"), each rank drawing the tp=1 replica's weights
and keeping its shard, so the replica computes what the tp=1 one does.
Without ``--engine`` rank 0 serialises the requests and broadcasts each
(prompt tokens and steps) to the other ranks, and every rank runs
``greedy_decode_kv`` in lockstep. With ``--engine`` every rank holds a
``DecodeEngine`` over its shards (its KV pool holds its kv heads); rank
0 keeps the frontend, the queue and every host decision, and before each
of its engine's device calls (an admitted prompt's prefill, a decode
quantum) broadcasts the call and its inputs, the quantum's whole slot
table included, so the other ranks run the same call. The ranks' cards
follow :func:`compose_mesh_devices` over the granted box
(``TPUSHARE_PLACEMENT_BOX``); ranks that outnumber the cards share them
(the transport is then gloo, see
:func:`tpushare_torch.workloads.parallel.transport`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import multiprocessing
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpushare_torch import metrics
from tpushare_torch.workloads.engine import DecodeEngine
from tpushare_torch.workloads.migrate import _pod_name


def compose_mesh_devices(devices, box_label, axes_shape):
    """Order ``devices`` into a physical-adjacency-aligned device array
    of ``axes_shape`` (e.g. ``(1, tp)`` or ``(1, tp, ep)``): the port's
    copy of the reference's function, which serve uses to give each rank
    its card.

    ``devices`` are in the grant's order: ascending chip ids, row-major
    over the granted box the device plugin reports via
    ``TPUSHARE_PLACEMENT_BOX`` (``box_label``, "2x2" form). When the
    box's non-trivial dims match the non-trivial logical axes, the devices
    are reshaped over the box and the box axes transposed onto the
    logical axes, so each logical axis walks a physical line; one logical
    axis over a multi-axis box walks it boustrophedon. Any mismatch (no
    label, scatter grant, incongruent shapes) degrades to the plain
    row-major reshape. Returns nested lists of ``axes_shape``.
    """
    n = 1
    for d in axes_shape:
        n *= d
    devs = list(devices[:n])
    if len(devs) < n or not box_label:
        return devs if len(axes_shape) == 1 else _reshape(devs, axes_shape)
    try:
        box = tuple(int(p) for p in str(box_label).lower().split("x"))
    except ValueError:
        return _reshape(devs, axes_shape)
    vol = 1
    for d in box:
        vol *= d
    nt_box = [d for d in box if d > 1]
    nt_axes = [d for d in axes_shape if d > 1]
    if vol != n or any(d <= 0 for d in box):
        return _reshape(devs, axes_shape)
    strides = []
    acc = 1
    for d in reversed(nt_box):
        strides.append(acc)
        acc *= d
    strides = list(reversed(strides))
    if sorted(nt_box) != sorted(nt_axes):
        if len(nt_axes) == 1 and len(nt_box) > 1:
            # one logical axis over a multi-axis box: boustrophedon, so
            # consecutive ring members are always one hop apart
            ordered = []
            for c in itertools.product(*[range(d) for d in nt_box]):
                eff = []
                for ax, v in enumerate(c):
                    if ax and sum(eff) % 2:
                        v = nt_box[ax] - 1 - v
                    eff.append(v)
                ordered.append(devs[sum(v * s
                                        for v, s in zip(eff, strides))])
            return _reshape(ordered, axes_shape)
        return _reshape(devs, axes_shape)
    # congruent: index the flat (row-major over box) list by box coords,
    # read it out with the box axes permuted onto the logical axes order
    for perm in itertools.permutations(range(len(nt_box))):
        if [nt_box[p] for p in perm] == nt_axes:
            ordered = [
                devs[sum(c[i] * strides[perm[i]]
                         for i in range(len(perm)))]
                for c in itertools.product(*[range(d) for d in nt_axes])]
            return _reshape(ordered, axes_shape)
    return _reshape(devs, axes_shape)


def _reshape(flat, shape):
    """Row-major nested-list reshape."""
    if len(shape) == 1:
        return list(flat)
    sub = 1
    for d in shape[1:]:
        sub *= d
    return [_reshape(flat[i * sub:(i + 1) * sub], shape[1:])
            for i in range(shape[0])]


def _flatten(nested) -> list:
    if not isinstance(nested, list):
        return [nested]
    return [x for item in nested for x in _flatten(item)]


class _EngineFrontend:
    """Queue + single engine thread between HTTP handlers and a
    DecodeEngine. Every engine call happens on the engine thread (the
    handlers only enqueue and wait), so slot admission, prefill and
    quanta never race. Admission is work-conserving: every quantum
    boundary first fills free slots from the queue, then advances.

    Traced (:func:`tpushare_torch.metrics.span`), a request's
    ``frontend.queue_wait`` runs from its enqueue on the client's thread
    to the start of its admission on the engine thread, and carries the
    rid its ``engine.prefill`` has. ``admission_wait`` (a histogram)
    observes the same wait in seconds."""

    def __init__(self, engine, tokens_counter=None, admission_wait=None):
        self._engine = engine
        self._tokens = tokens_counter
        self._admission_wait = admission_wait
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # why the loop ended on its own (a tp replica that stopped): every
        # request then fails with it
        self._failure: str | None = None
        # live-migration pause: the mover parks the loop at a quantum
        # boundary so KV state is consistent while it reads it; requests
        # keep queuing while paused and drain on resume
        self._paused = threading.Event()
        self._quiesced = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-engine")

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    @property
    def engine(self):
        return self._engine

    @property
    def failure(self) -> str | None:
        """Why the engine serves no more (its tp replica stopped), or
        None."""
        return self._failure

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout: float | None = None):
        """Wait for the engine thread to finish its in-flight quantum and
        observe the stop flag, and under ``--tp`` to stop the ranks
        (bounded; the thread is a daemon)."""
        if self._thread.is_alive():
            self._thread.join(timeout)

    def pause(self, timeout: float = 5.0) -> bool:
        """Park the engine loop at the next quantum boundary; True once
        it is quiescent, False on timeout. Idempotent."""
        self._paused.set()
        if not self._thread.is_alive():
            return True
        return self._quiesced.wait(timeout)

    def resume(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def generate(self, prompt: list[int], max_new: int,
                 timeout: float = 300.0,
                 sampling: dict | None = None) -> list[int]:
        """Blocks until the request's generation completes. Raises
        ValueError for requests the engine cannot place."""
        return self.generate_many([prompt], max_new, timeout,
                                  sampling)[0]

    def generate_stream(self, prompt: list[int], max_new: int,
                        timeout: float = 300.0,
                        sampling: dict | None = None):
        """Yields lists of new tokens as decode quanta complete (the
        first is the prefill's token); raises ValueError on rejection.
        The per-yield timeout bounds an engine stall, not the whole
        generation."""
        stream_q: queue.Queue = queue.Queue()
        done = threading.Event()
        box: dict = {"stream": stream_q}
        self._submit((list(prompt), max_new, sampling or {}, done, box))
        while True:
            try:
                kind, payload = stream_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("stream stalled") from None
            if kind == "delta":
                yield payload
            elif kind == "error":
                raise ValueError(payload)
            else:  # "done"
                return

    def generate_many(self, prompts: list[list[int]], max_new: int,
                      timeout: float = 300.0,
                      sampling: dict | None = None) -> list[list[int]]:
        """Enqueue all prompts before waiting on any, so they decode
        co-resident."""
        pairs = [(threading.Event(), {}) for _ in prompts]
        for p, (done, box) in zip(prompts, pairs):
            self._submit((list(p), max_new, sampling or {}, done, box))
        out = []
        for done, box in pairs:
            if not done.wait(timeout):
                raise TimeoutError("generation timed out")
            if "error" in box:
                raise ValueError(box["error"])
            out.append(box["tokens"])
        return out

    def _submit(self, item) -> None:
        """Enqueue one request, failing fast when the engine is stopping
        (checked on both sides of the put: the loop drains the queue
        once on stop)."""
        done, box = item[3], item[4]
        if self._stop.is_set():
            self._fail(done, box, self._failure or "server shutting down")
            return
        wait = metrics.span("frontend.queue_wait").begin()
        if wait:
            box["wait"] = wait
        if self._admission_wait is not None:
            box["enqueued"] = time.perf_counter()
        self._q.put(item)
        if self._stop.is_set():
            self._fail(done, box, self._failure or "server shutting down")

    @staticmethod
    def _fail(done, box, error: str) -> None:
        box["error"] = error
        if "stream" in box:
            box["stream"].put(("error", error))
        done.set()

    def _loop(self):
        inflight: dict[int, tuple] = {}  # rid -> (done, box)
        while not self._stop.is_set():
            if self._paused.is_set():
                self._quiesced.set()
                self._stop.wait(0.005)
                continue
            self._quiesced.clear()
            while self._engine.free_slots:
                try:
                    item = self._q.get(block=not (inflight or
                                                  self._engine.resident),
                                       timeout=0.5)
                except queue.Empty:
                    break
                prompt, max_new, sampling, done, box = item
                wait = box.get("wait", metrics.OFF)
                wait.end()
                if self._admission_wait is not None:
                    self._admission_wait.observe(
                        time.perf_counter() - box["enqueued"])
                try:
                    rid = self._engine.submit(prompt, max_new, **sampling)
                except ReplicaStopped as e:
                    self._fail(done, box, str(e))
                    self._end(e)
                    break
                except Exception as e:  # noqa: BLE001 — the engine
                    # thread must survive a bad request
                    self._fail(done, box, f"{type(e).__name__}: {e}")
                    continue
                if wait:
                    wait.rid = rid
                if "stream" in box:
                    box["stream"].put(
                        ("delta", self._engine.peek_tokens(rid) or []))
                inflight[rid] = (done, box)
            if not inflight or self._stop.is_set():
                continue
            try:
                finished = self._engine.run_quantum()
            except Exception as e:  # noqa: BLE001 — fail the residents
                # loudly and keep serving, unless the replica stopped
                print(f"decode engine quantum failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
                for done, box in inflight.values():
                    self._fail(done, box, f"engine failure: {e}")
                inflight.clear()
                if isinstance(e, ReplicaStopped):
                    self._end(e)
                continue
            for rid, delta in self._engine.last_quantum_tokens.items():
                done_box = inflight.get(rid)
                if done_box is not None and "stream" in done_box[1]:
                    done_box[1]["stream"].put(("delta", delta))
            for rid, tokens in finished.items():
                done, box = inflight.pop(rid)
                box["tokens"] = tokens
                if self._tokens is not None:
                    self._tokens.inc(len(tokens))
                if "stream" in box:
                    box["stream"].put(("done", tokens))
                done.set()
        # stop observed: wake every still-blocked client
        while True:
            try:
                _p, _m, _s, done, box = self._q.get_nowait()
            except queue.Empty:
                break
            self._fail(done, box, self._failure or "server shutting down")
        for done, box in inflight.values():
            self._fail(done, box, self._failure or
                       "server shutting down (request interrupted)")
        if isinstance(self._engine, _TPEngine):
            # after the loop's last device call
            self._engine.replica.stop()

    def _end(self, e: ReplicaStopped) -> None:
        """The replica under the engine stopped: end the loop, failing
        every request queued now or later with ``e``."""
        self._failure = str(e)
        self._stop.set()


# -- tensor-parallel replica --------------------------------------------------
# rank 0 broadcasts a header [op, a, b, c] on the model's device, then the
# op's inputs; the other ranks follow in _rank_loop:
#   _DECODE, _PREFILL   [op, B, S, steps], then the [B, S] prompt
#   _ENGINE_PREFILL     [op, slot, bucket, plen], then the padded prompt
#                       and the request key [bucket + 1], then its
#                       temperature and top-p [2]
#   _ENGINE_DECODE      [op, k, slots, 0], then the slot table: [6, slots]
#                       longs and [2, slots] floats (DecodeEngine.slot_table)
_STOP, _DECODE, _STATS, _RESET, _PREFILL = 0, 1, 2, 3, 4
_ENGINE_PREFILL, _ENGINE_DECODE = 5, 6


def tp_layout(cfg, tp: int) -> tuple[tuple, tuple]:
    """The replica's mesh over ``tp`` ranks: ``(1, tp)`` over ("dp",
    "tp"); for MoE presets ``(1, tp / ep, ep)`` over ("dp", "tp", "ep")
    with ep the largest divisor of ``tp`` that divides the experts (the
    reference's rule)."""
    from tpushare_torch.workloads import parallel
    if cfg.moe_experts > 0:
        ep = max(c for c in range(1, min(tp, cfg.moe_experts) + 1)
                 if tp % c == 0 and cfg.moe_experts % c == 0)
        return (1, tp // ep, ep), parallel.MOE_AXES
    return (1, tp), parallel.AXES


def _rank_stats(device) -> list[float]:
    """[K1 launches, K4 launches, kv_decode launches, peak and current
    bytes allocated]."""
    from tpushare_torch.kernels import flash, kv_decode
    mem = (torch.cuda.max_memory_allocated(device),
           torch.cuda.memory_allocated(device)) \
        if device.type == "cuda" else (0, 0)
    return [flash.LAUNCHES, flash.LAUNCHES_PIPELINED, kv_decode.LAUNCHES,
            *mem]


def _reset_stats(device) -> None:
    from tpushare_torch.kernels import flash, kv_decode
    flash.LAUNCHES = flash.LAUNCHES_PIPELINED = kv_decode.LAUNCHES = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _collect_stats(device) -> list[dict]:
    """Every rank's :func:`_rank_stats`, in rank order (collective)."""
    import torch.distributed as dist
    keys = ("flash_fwd", "flash_fwd_pipelined", "kv_decode",
            "max_memory_allocated", "memory_allocated")
    buf = torch.zeros((dist.get_world_size(), len(keys)),
                      dtype=torch.float64, device=device)
    buf[dist.get_rank()] = torch.tensor(_rank_stats(device),
                                        dtype=torch.float64)
    dist.all_reduce(buf)
    return [{k: int(v) for k, v in zip(keys, row)} for row in buf.tolist()]


def _agree(block: torch.Tensor) -> None:
    """Hold this rank's decode quantum ``block`` (tokens and active
    flags) against rank 0's, on every rank (collective): each rank fed
    its own tokens back into its KV shard during the quantum, so a rank
    that drew another token would go on from a cache that no longer
    matches the others' without any error. Raises on every rank if any
    differs."""
    import torch.distributed as dist
    ref = block.clone()
    dist.broadcast(ref, src=0)
    bad = (ref != block).any().long().reshape(1)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    if bad.item():
        raise RuntimeError("tp ranks drew different tokens in a decode "
                           "quantum: their KV shards no longer agree")


class ReplicaStopped(RuntimeError):
    """The tensor-parallel replica serves no more: it was stopped, or a
    call failed and left its ranks out of step, which ended them."""


class TPReplica:
    """Rank 0's side of a tensor-parallel replica: one call at a time
    (:meth:`op`), each broadcast to the other ranks, which run the same
    decode in lockstep, or with ``--engine`` the same engine call
    (:class:`_TPEngine`). A call that fails ends the ranks: every later
    call raises :class:`ReplicaStopped` with the first failure.
    ``stop`` ends the ranks and leaves the process group."""

    def __init__(self, decode, device, procs):
        self._decode = decode
        self.device = device
        self._procs = procs
        self._lock = threading.Lock()
        # why the replica serves no more, or None while it serves
        self.failure: str | None = None

    @contextlib.contextmanager
    def op(self, op, a=0, b=0, c=0):
        """Hold the replica for one call: broadcast its header ``[op, a,
        b, c]``; the body then broadcasts the call's inputs and runs rank
        0's share. The other ranks have begun the call by then, so a
        failure anywhere leaves them out of step: it ends them, and
        raises :class:`ReplicaStopped`."""
        import torch.distributed as dist
        with self._lock:
            if self.failure is not None:
                raise ReplicaStopped(f"tp replica stopped: {self.failure}")
            try:
                dist.broadcast(torch.tensor([op, a, b, c], dtype=torch.long,
                                            device=self.device), src=0)
                yield
            except Exception as e:
                self._end(f"{type(e).__name__}: {e}", timeout=10)
                raise ReplicaStopped(
                    f"tp replica stopped: {self.failure}") from e

    def _end(self, reason: str, timeout: float) -> None:
        """Record ``reason``, wait for the ranks to end (kill those that
        have not within ``timeout`` s) and leave the process group."""
        import torch.distributed as dist
        self.failure = reason
        for p in self._procs:
            p.join(timeout=timeout)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if dist.is_initialized():
            dist.destroy_process_group()

    def decode(self, tokens: torch.Tensor, steps: int) -> torch.Tensor:
        import torch.distributed as dist
        B, S = tokens.shape
        with self.op(_DECODE, B, S, steps):
            tokens = tokens.to(self.device).contiguous()
            dist.broadcast(tokens, src=0)
            return self._decode(tokens, steps)

    def prefill_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """The fp32 logits [B, vocab] of the first generated token: the
        replica's prefill of ``tokens`` [B, S], on every rank."""
        import torch.distributed as dist
        B, S = tokens.shape
        with self.op(_PREFILL, B, S):
            tokens = tokens.to(self.device).contiguous()
            dist.broadcast(tokens, src=0)
            return self._decode.prefill(tokens)

    def stats(self) -> list[dict]:
        """Per rank, in rank order: K1, K4 and kv_decode launches, peak
        and current bytes allocated on its card (0 on the CPU)."""
        with self.op(_STATS):
            return _collect_stats(self.device)

    def reset_stats(self) -> None:
        """Launch counts to 0 and the peak memory statistics reset, on
        every rank."""
        with self.op(_RESET):
            _reset_stats(self.device)

    def stop(self) -> None:
        """End the ranks (a no-op once the replica has stopped)."""
        with contextlib.suppress(ReplicaStopped), self.op(_STOP):
            self._end("the server stopped it", timeout=60)

    def join(self, timeout: float | None = None) -> None:
        """The ranks have ended once :meth:`stop` returns."""


class _TPEngine(DecodeEngine):
    """Rank 0's engine of a tensor-parallel replica: each device call, an
    admitted prompt's prefill or a decode quantum, is first broadcast
    with its inputs to the other ranks, whose engines run it on their
    shards (:func:`_rank_loop`); the host state (queue, admissions,
    request ids, budgets) stays here. A quantum's input is rank 0's slot
    table, and :func:`_agree` then holds every rank's tokens against
    rank 0's."""

    def __init__(self, replica: TPReplica, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.replica = replica

    def prefill_slot(self, slot, padded, plen, rkey, temp, topp):
        import torch.distributed as dist
        with self.replica.op(_ENGINE_PREFILL, slot, padded.shape[0], plen):
            dist.broadcast(torch.cat([padded, rkey]), src=0)
            dist.broadcast(torch.cat([temp, topp]), src=0)
            return super().prefill_slot(slot, padded, plen, rkey, temp,
                                        topp)

    def decode_quantum(self, k: int) -> torch.Tensor:
        import torch.distributed as dist
        longs, floats = self.slot_table()
        with self.replica.op(_ENGINE_DECODE, k, longs.shape[1]):
            dist.broadcast(longs, src=0)
            dist.broadcast(floats, src=0)
            block = super().decode_quantum(k)
            _agree(block)
            return block


def _rank_loop(decode, device, engine=None) -> None:
    import torch.distributed as dist
    while True:
        hdr = torch.empty(4, dtype=torch.long, device=device)
        dist.broadcast(hdr, src=0)
        op, B, S, steps = hdr.tolist()
        if op == _STOP:
            return
        if op == _ENGINE_PREFILL:
            slot, bucket, plen = B, S, steps
            longs = torch.empty(bucket + 1, dtype=torch.long, device=device)
            floats = torch.empty(2, device=device)
            dist.broadcast(longs, src=0)
            dist.broadcast(floats, src=0)
            engine.prefill_slot(slot, longs[:bucket], plen, longs[bucket:],
                                floats[:1], floats[1:])
        elif op == _ENGINE_DECODE:
            k, slots = B, S
            longs = torch.empty((6, slots), dtype=torch.long, device=device)
            floats = torch.empty((2, slots), device=device)
            dist.broadcast(longs, src=0)
            dist.broadcast(floats, src=0)
            engine.load_slot_table(longs, floats)
            _agree(engine.decode_quantum(k))
        elif op in (_DECODE, _PREFILL):
            tokens = torch.empty((B, S), dtype=torch.long, device=device)
            dist.broadcast(tokens, src=0)
            if op == _DECODE:
                decode(tokens, steps)
            else:
                decode.prefill(tokens)
        elif op == _STATS:
            _collect_stats(device)
        elif op == _RESET:
            _reset_stats(device)


def _tp_rank_main(argv, rank, world, addr, cards) -> None:
    """A rank other than 0 of a ``--tp`` replica: build its shards, then
    follow rank 0's broadcasts until it stops."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    args = _parser().parse_args(argv)
    from tpushare_torch.workloads.hbm import apply_hbm_gating
    apply_hbm_gating()
    try:
        decode, device, cfg, params = _tp_model(args, rank, world, addr,
                                                cards)
        engine = _engine(args, params, cfg) if args.engine else None
        _rank_loop(decode, device, engine)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tp_model(args, rank, world, addr, cards):
    """Join the replica's process group as ``rank`` on its card, and draw
    its shards of the weights: ``(decode, device, cfg, params)``."""
    from tpushare_torch.workloads import parallel, resolve_device
    from tpushare_torch.workloads.hbm import apply_memory_fraction
    from tpushare_torch.workloads.model import (
        forward_cached, greedy_decode, greedy_decode_kv, init_kv_cache,
        init_params, local_heads)
    device_type = resolve_device(args.device).type
    device = torch.device("cpu")
    if device_type == "cuda":
        device = torch.device("cuda", cards[rank % len(cards)])
    backend = parallel.init_rank(rank, world, addr, device_type,
                                 device=device, local_world=world)
    if device_type == "cuda":
        apply_memory_fraction()
    cfg = _serve_cfg(args)
    shape, names = tp_layout(cfg, world)
    mesh = parallel.make_mesh(device_type, shape, names)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = init_params(cfg, gen, mesh=mesh,
                             int8=args.quant == "int8")
    if rank == 0:
        print(f"tp replica: {world} ranks, mesh {dict(zip(names, shape))},"
              f" transport {backend}", flush=True)

    def decode(tokens, steps):
        with torch.inference_mode():
            if args.no_kv_cache:
                return greedy_decode(params, tokens, steps, cfg)
            return greedy_decode_kv(params, tokens, steps, cfg,
                                    rolling=args.rolling_kv)

    def prefill(tokens):
        """The KV-cached prefill greedy_decode_kv starts with: the logits
        of the first generated token."""
        with torch.inference_mode():
            B, S = tokens.shape
            cache = init_kv_cache(cfg, B, S + 1, device=device,
                                  kv_heads=local_heads(
                                      parallel.localize(params)[0], cfg,
                                      mesh)[1])
            logits, _ = forward_cached(params, tokens, cache, 0, cfg,
                                       prefill_from_zero=True)
            return logits[:, -1]

    decode.prefill = prefill
    return decode, device, cfg, params


def _engine(args, params, cfg, replica=None):
    """The replica's ``DecodeEngine`` from the command line's flags (on a
    tp rank: over its shards; on rank 0 of ``replica``, a
    :class:`_TPEngine`)."""
    kw = dict(quantum=args.engine_quantum,
              eos_id=None if args.eos_id < 0 else args.eos_id,
              temperature=args.temperature, top_k=args.top_k,
              top_p=args.top_p, seed=args.sample_seed,
              per_request_sampling=args.per_request_sampling,
              rolling=args.rolling_kv)
    args_ = (params, cfg, args.engine_slots, args.engine_max_len)
    if replica is not None:
        return _TPEngine(replica, *args_, **kw)
    return DecodeEngine(*args_, **kw)


def _serve_cfg(args):
    from tpushare_torch.workloads.model import PRESETS
    return dataclasses.replace(
        PRESETS[args.preset], attn=args.attn,
        kv_cache_dtype=args.kv_cache_dtype,
        attn_window=args.attn_window or None).validate()


def _start_tp(argv, args, world):
    """Start ranks 1..world-1 and join as rank 0: ``(TPReplica, cfg,
    params)``."""
    from tpushare_torch.contract import ENV_PLACEMENT_BOX
    from tpushare_torch.workloads import parallel, resolve_device
    device_type = resolve_device(args.device).type
    cfg = _serve_cfg(args)
    cards = [0]
    if device_type == "cuda":
        shape, _ = tp_layout(cfg, world)
        n = torch.cuda.device_count()
        if n >= world:
            cards = _flatten(compose_mesh_devices(
                list(range(n)), os.environ.get(ENV_PLACEMENT_BOX), shape))
        if parallel.transport(device_type, world, world) == "gloo":
            # build the kernels once, here, before the ranks want them
            from tpushare_torch.kernels import build
            build.build()
    addr = f"tcp://localhost:{parallel.free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tp_rank_main, daemon=True,
                         args=(argv, r, world, addr, cards))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        decode, device, cfg, params = _tp_model(args, 0, world, addr, cards)
    except BaseException:
        for p in procs:
            p.kill()
            p.join(timeout=10)
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        raise
    return TPReplica(decode, device, procs), cfg, params


# -- live-migration seam ------------------------------------------------------
# Process-local registry: workload name -> serve frontend, so a co-resident
# migrator can park a replica's loop at a quantum boundary (the scheduler
# side's Migrator takes frontend_for as its frontend_for). Under --tp the
# other ranks wait on the next header while rank 0's loop is parked.
_FRONTENDS: dict[str, _EngineFrontend] = {}
_FRONTENDS_LOCK = threading.Lock()


def register_frontend(name: str, frontend: _EngineFrontend) -> None:
    with _FRONTENDS_LOCK:
        _FRONTENDS[name] = frontend


def unregister_frontend(name: str) -> None:
    with _FRONTENDS_LOCK:
        _FRONTENDS.pop(name, None)


def frontend_for(pod) -> _EngineFrontend | None:
    """The frontend registered for a pod (its dict, whose
    ``metadata.name`` names it, or the name itself), or None: a pod with
    no serve loop just checkpoints."""
    with _FRONTENDS_LOCK:
        return _FRONTENDS.get(_pod_name(pod))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpushare-torch-serve")
    ap.add_argument("--preset", default="llama-tiny")
    ap.add_argument("--quant", choices=["none", "int8"], default="int8")
    ap.add_argument("--attn", choices=["einsum", "flash"], default="einsum",
                    help="flash = the hand-written CUDA flash-attention "
                         "kernel (prefill)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a CUDA request without "
                         "CUDA is an error")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--no-kv-cache", action="store_true",
                    help="use the cache-free reference decode path")
    ap.add_argument("--kv-cache-dtype", choices=["model", "int8"],
                    default="model")
    ap.add_argument("--attn-window", type=int, default=0,
                    help="sliding-window attention span (0 = full causal)")
    ap.add_argument("--rolling-kv", action="store_true",
                    help="ring-buffer KV cache sized by --attn-window")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks (0: the visible cards; "
                         "one on the CPU)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching over a fixed slot pool")
    ap.add_argument("--engine-slots", type=int, default=8)
    ap.add_argument("--engine-max-len", type=int, default=512)
    ap.add_argument("--engine-quantum", type=int, default=8)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--per-request-sampling", action="store_true")
    return ap


def build_server(argv: list[str] | None = None):
    """Parse ``argv``, build the model, the engine frontend (with
    ``--engine``, started) and the HTTP server. Returns
    ``(httpd, frontend)``; ``frontend`` is the engine frontend with
    ``--engine`` (under ``--tp`` above 1 its ``replica`` is the
    :class:`TPReplica`, whose ranks it stops when it stops), else the
    :class:`TPReplica` with ``--tp`` above 1 (its ranks started), else
    None.
    The caller runs ``httpd.serve_forever()`` and, at the end, stops
    the frontend and closes the server."""
    ap = _parser()
    args = ap.parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)

    from tpushare_torch.workloads.hbm import (
        apply_hbm_gating, apply_memory_fraction)
    apply_hbm_gating()  # before CUDA initialises

    from tpushare_torch.workloads import resolve_device
    from tpushare_torch.workloads.model import (
        PRESETS, greedy_decode, greedy_decode_kv, init_params)

    if args.attn_window < 0:
        ap.error(f"--attn-window {args.attn_window} must be >= 0")
    if args.rolling_kv and not args.attn_window:
        ap.error("--rolling-kv requires --attn-window")
    if args.rolling_kv and args.no_kv_cache:
        ap.error("--rolling-kv conflicts with --no-kv-cache")
    if args.tp < 0:
        ap.error(f"--tp {args.tp} must be >= 0")
    if args.preset not in PRESETS:
        ap.error(f"--preset {args.preset!r}: one of {sorted(PRESETS)}")
    if args.engine and PRESETS[args.preset].moe_experts:
        ap.error("--engine excludes MoE presets (capacity routing couples "
                 "slots)")
    device = resolve_device(args.device)
    tp = args.tp or (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
    if args.engine and args.no_kv_cache:
        ap.error("--engine requires a KV-cached path "
                 "(conflicts with --no-kv-cache)")
    if (args.engine and args.rolling_kv
            and args.engine_max_len < 2 * args.attn_window):
        ap.error(f"--engine --rolling-kv needs --engine-max-len >= "
                 f"2*attn-window ({2 * args.attn_window}): the ring "
                 "must retain chunked-prefill keys")
    tp_replica = None
    if tp > 1:
        tp_replica, cfg, params = _start_tp(argv, args, tp)
        device = tp_replica.device
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            apply_memory_fraction()
        cfg = _serve_cfg(args)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        with torch.inference_mode():
            params = init_params(cfg, gen, int8=args.quant == "int8")

    if args.no_kv_cache and args.kv_cache_dtype == "int8":
        print("note: --kv-cache-dtype int8 has no effect with "
              "--no-kv-cache (the reference decode path allocates no KV "
              "cache)", flush=True)
    if args.attn == "flash" and not args.no_kv_cache:
        which = ("prefill only (ring chunks use einsum)"
                 if args.rolling_kv else "prefill (time-to-first-token)")
        print(f"note: --attn flash accelerates the {which}; decode "
              "steps use the einsum core on any KV-cached path",
              flush=True)

    def decode(tokens: torch.Tensor, steps: int) -> torch.Tensor:
        if tp_replica is not None:
            return tp_replica.decode(tokens, steps)
        with torch.inference_mode():
            if args.no_kv_cache:
                return greedy_decode(params, tokens, steps, cfg)
            return greedy_decode_kv(params, tokens, steps, cfg,
                                    rolling=args.rolling_kv)

    from tpushare_torch.metrics import LATENCY_BUCKETS, Registry
    registry = Registry()
    m_requests = registry.counter(
        "tpushare_serve_requests_total",
        "generate requests received (incl. ones answered 400)")
    m_errors = registry.counter(
        "tpushare_serve_request_errors_total",
        "generate requests answered with an error")
    m_tokens = registry.counter(
        "tpushare_serve_tokens_generated_total",
        "tokens generated (excludes echoed prompt tokens)")
    m_latency = registry.histogram(
        "tpushare_serve_generate_seconds",
        "wall time per generate request",
        tuple(b * 100 for b in LATENCY_BUCKETS))

    engine_front = None
    if args.engine:
        engine_front = _EngineFrontend(
            _engine(args, params, cfg, replica=tp_replica),
            tokens_counter=m_tokens,
            admission_wait=registry.histogram(
                "tpushare_serve_engine_admission_wait_seconds",
                "wait from a request's enqueue to the start of its "
                "admission into a decode-engine slot",
                tuple(b * 100 for b in LATENCY_BUCKETS)))
        engine_front.start()
        register_frontend(os.environ.get("POD_NAME") or args.preset,
                          engine_front)
        registry.gauge_func(
            "tpushare_serve_engine_slots",
            "decode-engine slot pool occupancy",
            lambda: [('{state="free"}',
                      float(engine_front.engine.free_slots)),
                     ('{state="resident"}',
                      float(engine_front.engine.resident))])
        registry.gauge_func(
            "tpushare_serve_engine_queue_depth",
            "requests waiting for a free slot",
            lambda: [("", float(engine_front.queue_depth))])

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            m_requests.inc()
            t_req = time.perf_counter()
            try:
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                steps = int(body.get("steps", 8))
                if steps < 1:
                    raise ValueError(f"steps {steps} must be >= 1")
                if body.get("stream") and engine_front is None:
                    raise ValueError("stream requires --engine")
                sampling = {k: float(body[k])
                            for k in ("temperature", "top_p")
                            if k in body}
                if "eos_id" in body:
                    sampling["eos_id"] = int(body["eos_id"])
                if sampling and engine_front is None:
                    raise ValueError(
                        "temperature/top_p/eos_id need --engine")
                if engine_front is not None and body.get("stream"):
                    prompts = body["tokens"]
                    if not (prompts and isinstance(prompts[0], int)):
                        raise ValueError(
                            "stream mode takes ONE flat prompt")
                    self._stream(list(prompts), steps, t_req, sampling)
                    return
                if engine_front is not None:
                    prompts = body["tokens"]
                    if prompts and isinstance(prompts[0], int):
                        prompts = [prompts]  # single sequence accepted
                    gen_rows = engine_front.generate_many(
                        [list(p) for p in prompts], steps,
                        sampling=sampling)
                    rows = [list(p) + g for p, g in zip(prompts, gen_rows)]
                    resp = json.dumps({"tokens": rows}).encode()
                else:
                    tokens = torch.tensor(body["tokens"], dtype=torch.long)
                    if tokens.dim() == 1:
                        tokens = tokens[None]
                    if tokens.numel() and not (
                            0 <= int(tokens.min())
                            and int(tokens.max()) < cfg.vocab):
                        raise ValueError(
                            f"token outside [0, {cfg.vocab})")
                    out = decode(tokens.to(device), steps)
                    m_tokens.inc(out.shape[0] * steps)
                    resp = json.dumps({"tokens": out.tolist()}).encode()
                m_latency.observe(time.perf_counter() - t_req)
            except Exception as e:  # noqa: BLE001 — serving surface
                m_errors.inc()
                msg = json.dumps({"error": str(e)}).encode()
                try:
                    self.send_response(400)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                except OSError:
                    pass  # client already gone
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)
            except OSError:
                pass  # a client that hung up is not a serving error

        def _stream(self, prompt, steps, t_req, sampling=None):
            """NDJSON streaming: one {"delta": [...]} line per decode
            quantum, closed by {"done": true, "tokens": [prompt +
            generation]}; the body ends at connection close. The status
            line waits for the first event, so a submit-time rejection
            is answered 400 like the non-streaming path."""
            events = iter(engine_front.generate_stream(
                prompt, steps, sampling=sampling))
            first = next(events, None)  # ValueError/TimeoutError -> 400
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()
            generated: list[int] = []
            try:
                deltas = [] if first is None else [first]
                for delta in (d for src in (deltas, events) for d in src):
                    generated.extend(delta)
                    self.wfile.write(
                        json.dumps({"delta": delta}).encode() + b"\n")
                    self.wfile.flush()
                m_latency.observe(time.perf_counter() - t_req)
                self.wfile.write(json.dumps(
                    {"done": True,
                     "tokens": list(prompt) + generated}).encode() + b"\n")
            except (ValueError, TimeoutError) as e:
                m_errors.inc()
                self.wfile.write(
                    json.dumps({"error": str(e)}).encode() + b"\n")
            except OSError:
                pass  # client hung up mid-stream

        def do_GET(self):
            if self.path == "/healthz":
                failure = (engine_front.failure if engine_front
                           else tp_replica and tp_replica.failure)
                body = (f"tp replica stopped: {failure}" if failure
                        else "ok").encode()
                self.send_response(503 if failure else 200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/metrics":
                body = registry.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

    try:
        httpd = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    except OSError:
        if engine_front is not None:
            engine_front.stop()
        if tp_replica is not None:
            tp_replica.stop()
        raise
    front = (f", engine slots={args.engine_slots} "
             f"quantum={args.engine_quantum}" if engine_front else "")
    if tp_replica is not None:
        front += f", tp={tp}"
    print(f"tpushare-torch-serve ready on :{httpd.server_address[1]} "
          f"(preset={args.preset}, quant={args.quant}, device={device}"
          f"{front})", flush=True)
    return httpd, engine_front or tp_replica


def main(argv: list[str] | None = None) -> int:
    httpd, engine_front = build_server(argv)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if engine_front is not None:
            # stop at a quantum boundary so waiting clients get a clean
            # error instead of a reset connection
            engine_front.stop()
            engine_front.join(timeout=10.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
