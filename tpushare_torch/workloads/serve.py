"""Co-located int8 serving replica on one CUDA card (BASELINE config #5).

Counterpart of ``tpushare/workloads/serve.py``: the same flags, the same
``POST /generate {"tokens": [[...]], "steps": N}`` surface with NDJSON
streaming, ``/healthz`` and ``/metrics``, plus ``--device`` (default
``cuda``; ``--device cpu`` runs the replica on the CPU). A CUDA request
on a machine without CUDA raises instead of falling back.

:func:`build_server` builds the replica without serving it, so a test or
a smoke script can run ``httpd.serve_forever`` in a thread;
:func:`main` is the command line.

Not ported yet: tensor parallelism (``--tp`` above 1, ROADMAP.md Queue 1
item 12) and MoE presets (item 13); both raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch


class _EngineFrontend:
    """Queue + single engine thread between HTTP handlers and a
    DecodeEngine. Every engine call happens on the engine thread (the
    handlers only enqueue and wait), so slot admission, prefill and
    quanta never race. Admission is work-conserving: every quantum
    boundary first fills free slots from the queue, then advances."""

    def __init__(self, engine, tokens_counter=None):
        self._engine = engine
        self._tokens = tokens_counter
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
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

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout: float | None = None):
        """Wait for the engine thread to finish its in-flight quantum and
        observe the stop flag (bounded; the thread is a daemon)."""
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
            self._fail(done, box, "server shutting down")
            return
        self._q.put(item)
        if self._stop.is_set():
            self._fail(done, box, "server shutting down")

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
                try:
                    rid = self._engine.submit(prompt, max_new, **sampling)
                except Exception as e:  # noqa: BLE001 — the engine
                    # thread must survive a bad request
                    self._fail(done, box, f"{type(e).__name__}: {e}")
                    continue
                if "stream" in box:
                    box["stream"].put(
                        ("delta", self._engine.peek_tokens(rid) or []))
                inflight[rid] = (done, box)
            if not inflight:
                continue
            try:
                finished = self._engine.run_quantum()
            except Exception as e:  # noqa: BLE001 — fail the residents
                # loudly and keep serving
                print(f"decode engine quantum failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
                for done, box in inflight.values():
                    self._fail(done, box, f"engine failure: {e}")
                inflight.clear()
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
            self._fail(done, box, "server shutting down")
        for done, box in inflight.values():
            self._fail(done, box,
                       "server shutting down (request interrupted)")


# -- live-migration seam -------------------------------------------------------
# Process-local registry: workload name -> serve frontend, so a co-resident
# migrator can park a replica's loop at a quantum boundary. The port's own;
# wiring it to the scheduler side's migrator is later work.
_FRONTENDS: dict[str, _EngineFrontend] = {}
_FRONTENDS_LOCK = threading.Lock()


def register_frontend(name: str, frontend: _EngineFrontend) -> None:
    with _FRONTENDS_LOCK:
        _FRONTENDS[name] = frontend


def frontend_for(name: str) -> _EngineFrontend | None:
    """The frontend registered under ``name`` (the pod name), or None."""
    with _FRONTENDS_LOCK:
        return _FRONTENDS.get(name)


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
                    help="tensor-parallel size (0 or 1: one card)")
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
    ``(httpd, frontend)``; ``frontend`` is None without ``--engine``.
    The caller runs ``httpd.serve_forever()`` and, at the end, stops
    the frontend and closes the server."""
    ap = _parser()
    args = ap.parse_args(argv)

    from tpushare_torch.workloads.hbm import (
        apply_hbm_gating, apply_memory_fraction)
    apply_hbm_gating()  # before CUDA initialises

    from tpushare_torch.workloads import resolve_device
    from tpushare_torch.workloads.model import (
        PRESETS, greedy_decode, greedy_decode_kv, init_params,
        quantize_int8)

    if args.attn_window < 0:
        ap.error(f"--attn-window {args.attn_window} must be >= 0")
    if args.rolling_kv and not args.attn_window:
        ap.error("--rolling-kv requires --attn-window")
    if args.rolling_kv and args.no_kv_cache:
        ap.error("--rolling-kv conflicts with --no-kv-cache")
    if args.tp > 1:
        raise NotImplementedError(
            "--tp > 1: tensor parallelism is not ported yet (ROADMAP.md "
            "Queue 1 item 12)")
    if args.preset not in PRESETS:
        ap.error(f"--preset {args.preset!r}: one of {sorted(PRESETS)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        apply_memory_fraction()
    cfg = dataclasses.replace(
        PRESETS[args.preset], attn=args.attn,
        kv_cache_dtype=args.kv_cache_dtype,
        attn_window=args.attn_window or None).validate()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = init_params(cfg, gen)
        if args.quant == "int8":
            params = quantize_int8(params)

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
        if args.no_kv_cache:
            ap.error("--engine requires a KV-cached path "
                     "(conflicts with --no-kv-cache)")
        if args.rolling_kv and args.engine_max_len < 2 * args.attn_window:
            ap.error(f"--engine --rolling-kv needs --engine-max-len >= "
                     f"2*attn-window ({2 * args.attn_window}): the ring "
                     "must retain chunked-prefill keys")
        from tpushare_torch.workloads.engine import DecodeEngine
        eos = None if args.eos_id < 0 else args.eos_id
        engine_front = _EngineFrontend(
            DecodeEngine(params, cfg, args.engine_slots,
                         args.engine_max_len,
                         quantum=args.engine_quantum, eos_id=eos,
                         temperature=args.temperature,
                         top_k=args.top_k, top_p=args.top_p,
                         seed=args.sample_seed,
                         per_request_sampling=args.per_request_sampling,
                         rolling=args.rolling_kv),
            tokens_counter=m_tokens)
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
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")
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
        raise
    front = (f", engine slots={args.engine_slots} "
             f"quantum={args.engine_quantum}" if engine_front else "")
    print(f"tpushare-torch-serve ready on :{httpd.server_address[1]} "
          f"(preset={args.preset}, quant={args.quant}, device={device}"
          f"{front})", flush=True)
    return httpd, engine_front


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
