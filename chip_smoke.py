#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py                     # every phase, as a check
    python3 chip_smoke.py --out results.json  # also write every number

Phases, each printing its own lines; any failure exits non-zero:

1. card     -- name, power limit, torch and CUDA versions; TF32 off.
2. build    -- the hand-written kernels, built from ``tpushare_torch/csrc``
               (one ``nvcc`` per source, all started together).
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the shapes the serving path gives it, with times.
4. serve    -- the int8 serving replica (``llama-8b``, int8 weights, int8
               KV cache, ``--attn flash``, continuous batching) answering
               HTTP requests; the kernel's launch count must show every
               prefill went through it.
5. entry    -- the llama-mini forward of ``tpushare_torch.entry`` with the
               flash kernel against the einsum path.

The second-to-last line is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
``tpushare_torch`` package beside this script, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12     # outside the tensor cores
PEAK_BYTES = 3.35e12

# kernel vs plain: both accumulate in fp32; they differ in summation
# order and, in bf16, in which p values round one way or the other, so
# bf16 allows a few output ulps (2**-7 at 1.0) and fp32 a few 1e-6
TOL = {"bfloat16": {"out": 2e-2, "lse": 1e-3},
       "float32": {"out": 1e-4, "lse": 1e-4}}
# flash vs einsum llama-mini logits (bf16, 4 layers): the einsum path
# rounds scores to bf16 before the softmax, the kernel keeps them fp32,
# so the logits (|logit| up to about 6) may differ by a few bf16 ulps
# of 2**-5: allow 4
ENTRY_TOL = 0.125
# served greedy tokens against an uncached einsum forward over the same
# sequence: the served token's reference logit must be within this of
# the reference maximum (the int8 KV cache and the different GEMM
# shapes move logits by a few 1e-2; a broken path misses by the logit
# spread, about 4)
SERVE_MARGIN = 0.5

SERVE_ARGV = ["--preset", "llama-8b", "--quant", "int8",
              "--kv-cache-dtype", "int8", "--attn", "flash", "--engine",
              "--engine-slots", "8", "--engine-max-len", "512",
              "--device", "cuda", "--port", "0"]


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    def __init__(self):
        self.results: dict = {}

    # -- 1. card ---------------------------------------------------------------
    def card(self):
        import torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        self.smi = smi.stdout.strip().splitlines()[0]
        log(self.smi)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.kind = torch.cuda.get_device_name(0)
        log(f"card: {self.kind}, {torch.cuda.device_count()} visible; "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
            "TF32 off for matmul and cuDNN")
        self.results["card"] = {"nvidia_smi": self.smi, "kind": self.kind,
                                "torch": torch.__version__,
                                "cuda": torch.version.cuda}

    # -- 2. build --------------------------------------------------------------
    def build(self):
        from tpushare_torch.kernels import build
        t0 = time.perf_counter()
        built = build.build(verbose=True)
        wall = time.perf_counter() - t0
        for name, info in built.items():
            ptxas = [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"build {name}: {info['seconds']:.1f} s -> "
                f"{Path(info['path']).relative_to(ROOT)}")
            for ln in ptxas:
                log(f"  ptxas {ln}")
        log(f"build: all kernels in {wall:.1f} s")
        self.results["build_s"] = wall

    # -- 3. kernels ------------------------------------------------------------
    def kernels(self):
        import torch
        import torch.nn.functional as F
        from tpushare_torch.kernels import flash
        from tpushare_torch.workloads.attention import flash_attention_plain

        bf16, f32 = torch.bfloat16, torch.float32
        # (label, B, H, Hkv, S, D, dtype, causal, window)
        shapes = [("llama-8b prefill S=8", 1, 32, 8, 8, 128, bf16, True, None),
                  ("llama-8b prefill S=128", 1, 32, 8, 128, 128, bf16, True,
                   None),
                  ("llama-8b prefill S=512", 1, 32, 8, 512, 128, bf16, True,
                   None),
                  ("entry llama-mini", 2, 8, 4, 128, 64, bf16, True, None),
                  ("ragged S=200", 1, 32, 8, 200, 128, bf16, True, None),
                  ("non-causal", 1, 32, 8, 256, 128, bf16, False, None),
                  ("window 77", 1, 32, 8, 256, 128, bf16, True, 77),
                  ("fp32", 1, 8, 2, 256, 64, f32, True, None),
                  ("D=16 (llama-tiny)", 2, 4, 2, 96, 16, bf16, True, None)]
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = []
        for label, B, H, Hkv, S, D, dt, causal, window in shapes:
            q = torch.randn(B, H, S, D, generator=gen, device=dev).to(dt)
            k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dt)
            out, lse = flash.flash_fwd(q, k, v, causal, window)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_plain(q, k, v, causal, window)
            err_o = (out.float() - ref_out.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            tol = TOL[str(dt).split(".")[-1]]
            if not (err_o <= tol["out"] and err_l <= tol["lse"]):
                raise AssertionError(
                    f"{label}: kernel vs plain max|dO| {err_o:.3g} (tol "
                    f"{tol['out']}), max|dLSE| {err_l:.3g} (tol "
                    f"{tol['lse']})")

            def kernel():
                return flash.flash_fwd(q, k, v, causal, window)

            ms = time_ms(kernel, 50)
            host_ms = call_ms(kernel)
            plain_ms = time_ms(
                lambda: flash_attention_plain(q, k, v, causal, window), 5)
            mask = None
            if window is not None:
                pos = torch.arange(S, device=dev)
                mask = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] >= pos[:, None] - (window - 1)))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True), 50)
            bound = flash_bound(B, H, Hkv, S, D, dt, causal, window)
            row = {"shape": label, "B": B, "H": H, "Hkv": Hkv, "S": S,
                   "D": D, "dtype": str(dt), "causal": causal,
                   "window": window, "max_abs_err_out": err_o,
                   "max_abs_err_lse": err_l, "ms": ms, "call_ms": host_ms,
                   "plain_ms": plain_ms,
                   "library_ms": lib_ms, **bound}
            rows.append(row)
            log(f"kernel flash_fwd [{label}] B={B} H={H} Hkv={Hkv} S={S} "
                f"D={D} {str(dt)[6:]} causal={causal} window={window}: "
                f"max|dO| {err_o:.3g} max|dLSE| {err_l:.3g}; "
                f"{ms:.4f} ms ({host_ms:.4f} ms a call from Python), "
                f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"({bound['flops']:.4g} FLOP, {bound['bytes']:.4g} B)")
        self.results["kernel_shapes"] = rows

    # -- 4. serving replica ------------------------------------------------------
    def serve(self):
        import torch
        from tpushare_torch.kernels import flash
        from tpushare_torch.workloads import serve

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        httpd, front = serve.build_server(SERVE_ARGV)
        torch.cuda.synchronize()
        self.build_peak = torch.cuda.max_memory_allocated()
        log(f"serve: llama-8b int8 replica built in "
            f"{time.perf_counter() - t0:.1f} s (peak allocated "
            f"{self.build_peak / 2**30:.2f} GiB while quantising)")
        torch.cuda.reset_peak_memory_stats()
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            self._drive(url, front, flash)
        finally:
            httpd.shutdown()
            httpd.server_close()
            front.stop()
            front.join(timeout=30)
            thread.join(timeout=30)

    def _drive(self, url, front, flash):
        import torch
        cfg = front.engine.cfg
        rng = torch.Generator().manual_seed(7)

        def prompt(n):
            return torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()

        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert r.read() == b"ok"
        ragged = [prompt(n) for n in (5, 37, 200)]
        stream_p = prompt(100)
        client_p = [prompt(300), prompt(20)]
        solo = prompt(64)
        mates = [prompt(n) for n in (9, 130, 450)]
        steps = 16
        answers: dict = {}

        # -- the main path, with the launch count read around it only --
        flash.LAUNCHES = 0
        t_main = time.perf_counter()
        t0 = time.perf_counter()
        rows = post(url, {"tokens": ragged, "steps": steps})
        batch_s = time.perf_counter() - t0
        check_rows(ragged, rows, steps, cfg.vocab)
        answers["batch"] = (ragged, rows)

        ttft, stream_s, stream_rows = post_stream(url, stream_p, 32)
        check_rows([stream_p], stream_rows, 32, cfg.vocab)
        answers["stream"] = ([stream_p], stream_rows)

        results: dict = {}

        def client(i):
            results[i] = post(url, {"tokens": client_p[i], "steps": steps})

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        if len(results) != 2:
            raise AssertionError("a concurrent client got no answer")
        for i in range(2):
            check_rows([client_p[i]], results[i], steps, cfg.vocab)
        answers["clients"] = (client_p, [results[0][0], results[1][0]])

        alone = post(url, {"tokens": [solo], "steps": 32})
        t0 = time.perf_counter()
        together = post(url, {"tokens": [solo] + mates, "steps": 32})
        together_s = time.perf_counter() - t0
        check_rows([solo] + mates, together, 32, cfg.vocab)
        answers["together"] = ([solo] + mates, together)
        main_s = time.perf_counter() - t_main
        launches = flash.LAUNCHES
        prefills = len(ragged) + 1 + 2 + 1 + 1 + len(mates)
        # -- end of the main path --

        if alone[0] != together[0]:
            raise AssertionError("co-tenant invariance: the solo request's "
                                 "tokens changed beside co-tenants")
        expect = cfg.n_layers * prefills
        if launches != expect:
            raise AssertionError(f"flash_fwd launches {launches} != "
                                 f"{cfg.n_layers} layers x {prefills} "
                                 f"prefills = {expect}")
        self.launches = launches
        decode_rate = 31 / (stream_s - ttft)
        four_rate = 4 * 32 / together_s
        log(f"serve: {prefills} requests, flash_fwd launches {launches} "
            f"= {cfg.n_layers} x {prefills} prefills; co-tenant invariance "
            "bitwise")
        log(f"serve: one stream (prompt 100, 32 tokens): time to first "
            f"token {ttft * 1e3:.1f} ms, then {decode_rate:.1f} decode "
            f"tokens/s; 4 co-resident requests (32 tokens each): "
            f"{four_rate:.1f} tokens/s over {together_s:.3f} s, their "
            f"prefills included; ragged batch of 3: {batch_s:.3f} s")
        margin = self._check_tokens(front, answers)
        mem = torch.cuda.max_memory_allocated()
        log(f"serve: served tokens within {margin:.3f} of the uncached "
            f"einsum forward's top logit (limit {SERVE_MARGIN}); "
            f"max_memory_allocated {mem / 2**30:.2f} GiB; main path "
            f"{main_s:.1f} s")
        metrics = urllib.request.urlopen(url + "/metrics", timeout=30).read()
        if b"tpushare_serve_tokens_generated_total" not in metrics:
            raise AssertionError("/metrics lacks the token counter")
        self.results["serve"] = {
            "requests": prefills, "launches": launches,
            "ttft_ms": ttft * 1e3, "stream_s": stream_s,
            "stream_decode_tokens_per_s": decode_rate,
            "four_requests_tokens_per_s": four_rate, "batch_s": batch_s,
            "max_memory_allocated": mem, "build_peak": self.build_peak,
            "token_margin": margin,
            "main_path_s": main_s}

    def _check_tokens(self, front, answers) -> float:
        """Each served greedy token against an uncached einsum forward
        over the served sequence: returns the worst gap between the
        reference logit of the served token and the reference maximum."""
        import dataclasses

        import torch
        from tpushare_torch.workloads.model import forward
        eng = front.engine
        cfg = dataclasses.replace(eng.cfg, attn="einsum")
        worst = 0.0
        with torch.inference_mode():
            for prompts, rows in answers.values():
                for p, row in zip(prompts, rows):
                    seq = torch.tensor([row], device="cuda")
                    logits = forward(eng.params, seq[:, :-1], cfg)[0]
                    if not torch.isfinite(logits).all():
                        raise AssertionError("non-finite reference logits")
                    gen = seq[0, len(p):]
                    ref = logits[len(p) - 1:]
                    gap = ref.max(dim=-1).values - ref.gather(
                        1, gen[:, None])[:, 0]
                    worst = max(worst, gap.max().item())
        if worst > SERVE_MARGIN:
            raise AssertionError(f"served token {worst:.3f} below the "
                                 f"reference top logit (limit "
                                 f"{SERVE_MARGIN})")
        return worst

    # -- 5. entry ----------------------------------------------------------------
    def entry(self):
        import torch
        from tpushare_torch.entry import entry
        with torch.inference_mode():
            fn, args = entry(device="cuda", attn="flash")
            flash_logits = fn(*args)
            fn, args = entry(device="cuda", attn="einsum")
            ein_logits = fn(*args)
        if flash_logits.shape != (2, 128, 2048):
            raise AssertionError(f"entry logits {tuple(flash_logits.shape)}")
        if not torch.isfinite(flash_logits).all():
            raise AssertionError("entry: non-finite logits")
        diff = (flash_logits - ein_logits).abs().max().item()
        scale = ein_logits.abs().max().item()
        log(f"entry: llama-mini B=2 S=128 logits flash vs einsum max|d| "
            f"{diff:.4g} (tol {ENTRY_TOL}; max|logit| {scale:.3g})")
        if diff > ENTRY_TOL:
            raise AssertionError(f"entry: flash vs einsum {diff} > "
                                 f"{ENTRY_TOL}")
        self.results["entry"] = {"max_abs_diff": diff, "max_abs": scale}

    def kernel_line(self) -> dict:
        """The ``{"kernels": [...]}`` record: times at the largest serving
        prefill bucket, the error as the worst over the bf16 path shapes."""
        rows = self.results["kernel_shapes"]
        head = next(r for r in rows if r["shape"] == "llama-8b prefill S=512")
        path = [r for r in rows if r["dtype"] == "torch.bfloat16"]
        return {"name": "flash_fwd", "route": "cuda",
                "source": "tpushare_torch/csrc/flash_fwd.cu",
                "replaces": "tpushare/workloads/attention.py:279",
                "launches": self.launches,
                "max_abs_err": max(r["max_abs_err_out"] for r in path),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"]}


def flash_bound(B, H, Hkv, S, D, dtype, causal, window) -> dict:
    """The least time for one flash forward: the larger of its bytes
    (q, k, v read once, out and lse written once) over the memory rate
    and its FLOPs (2 products over the visible (query, key) pairs only)
    over the peak rate of its type."""
    import torch
    rows = torch.arange(S)
    lo = torch.zeros(S, dtype=torch.long)
    hi = torch.full((S,), S - 1) if not causal else rows
    if window is not None:
        lo = (rows - (window - 1)).clamp_min(0)
    pairs = int((hi - lo + 1).sum())
    flops = 4 * B * H * D * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * H * S * D + 2 * B * Hkv * S * D) + 4 * B * H * S
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def time_ms(fn, calls: int, reps: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between two CUDA events; the median
    replay over ``calls``. The graph takes the host's launch cost out of
    the time, and the inputs stay in L2 between calls, as they are when
    a prefill layer hands its fresh q/k/v to the kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def call_ms(fn, reps: int = 30) -> float:
    """Median time of one call from Python, host launch cost included:
    CUDA events around each call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def post(url: str, body: dict) -> list:
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())["tokens"]


def post_stream(url: str, prompt: list, steps: int):
    """NDJSON stream; returns (seconds to the first delta, seconds to the
    last delta, [tokens])."""
    req = urllib.request.Request(
        url + "/generate",
        data=json.dumps({"tokens": prompt, "steps": steps,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft, last, deltas, final = None, None, [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            event = json.loads(line)
            if "error" in event:
                raise AssertionError(f"stream error: {event['error']}")
            if "delta" in event:
                last = time.perf_counter() - t0
                ttft = last if ttft is None else ttft
                deltas.extend(event["delta"])
            if event.get("done"):
                final = event["tokens"]
    if final is None or final != prompt + deltas:
        raise AssertionError("stream: deltas do not add up to the result")
    return ttft, last, [final]


def check_rows(prompts, rows, steps, vocab):
    if len(rows) != len(prompts):
        raise AssertionError(f"{len(rows)} rows for {len(prompts)} prompts")
    for p, row in zip(prompts, rows):
        if row[:len(p)] != p or len(row) != len(p) + steps:
            raise AssertionError(f"row of {len(row)} for a prompt of "
                                 f"{len(p)} + {steps} steps")
        if not all(isinstance(t, int) and 0 <= t < vocab for t in row):
            raise AssertionError("token outside the vocabulary")


PHASES = ("card", "build", "kernels", "serve", "entry")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a partial run prints no final result)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not (ROOT / "tpushare_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no tpushare_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2

    smoke = Smoke()
    ok = True
    for name in ("card", *[p for p in PHASES[1:] if p in phases]):
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception:  # noqa: BLE001 -- report every phase's failure
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
            ok = False
            break
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(smoke.results, indent=1))
    if not ok:
        return 1
    if tuple(phases) != PHASES:
        log("chip_smoke: partial run, no result line")
        return 0
    log(json.dumps({"kernels": [smoke.kernel_line()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
