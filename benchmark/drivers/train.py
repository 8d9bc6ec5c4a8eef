"""The training driver: the port's train step as the player calls it
(``model.make_train_step`` over ``model.train_params``, the fused
``AdamW``), on rows of fresh tokens from the seed.

Set-up builds the one step object from the drawn weights and runs the
cell's checked steps through the window's own call and feed: the first
step's gradients (worked out from the optimizer's first moments) and,
after the last checked step, the parameters' change are read then, and
that reading is not counted as set-up. The window runs steps back to
back for ``--seconds``; every step counts, the last one to its end. Then
the program's state is freed and the reference follows the checked
steps from the same weights and rows."""

from __future__ import annotations

import gc
import time

import torch

from benchmark import arith, cells, check, weights
from benchmark.drivers import port_config
from benchmark.trace import DeviceTrace, Spans, sync


def run(ctx) -> dict:
    tr, conf = ctx.cell["traffic"], ctx.cell["config"]
    m = cells.model_sizes(conf)
    cuda = ctx.device.startswith("cuda")
    from tpushare_torch.workloads import model as pm

    dev = torch.device(ctx.device)
    if cuda:
        torch.cuda.set_device(dev)
    cfg = port_config(conf, tr)
    B, S = tr["batch"], tr["seq"]
    raw = weights.draw(m, ctx.seed, dev)
    ctx.mark("weights drawn")
    tx, train_step = pm.make_train_step(cfg, learning_rate=tr["learning_rate"])
    params = pm.train_params(raw)
    opt = tx.init(params)
    feed = weights.token_rows(ctx.seed, m["V"], B, S, dev)
    state = {"params": params, "opt": opt}

    def step() -> float:
        state["params"], state["opt"], loss = train_step(
            state["params"], state["opt"], next(feed))
        return float(loss)

    program = {"losses": []}
    b1 = opt.defaults["betas"][0]
    for t in range(1, tr["check"]["steps"] + 1):
        program["losses"].append(step())
        ctx.mark(f"step {t}")
        c0 = time.perf_counter()
        if t == 1:
            program["grads"], program["samples"] = {}, {}
            _, ids = check.once(next(weights.token_rows(
                ctx.seed, m["V"], B, S, dev))[:, :-1])
            for path, leaf in pm.named_leaves(state["params"]):
                g = _first_gradient(opt, leaf, b1)
                program["grads"][path] = float(g.norm())
                program["samples"][path] = g.reshape(-1)[check.sample_index(
                    g.numel(), ctx.seed, path, g.device)].cpu()
                if path == "embed":
                    program["rows"] = g[ids].cpu()
        if t == tr["check"]["steps"]:
            program["change"] = check.change_norms(m, ctx.seed, raw, dev)
        ctx.check_s += time.perf_counter() - c0

    rec: dict = {"model": m, "flops_per_step": arith.train_step_flops(
        m, B, S, m["window"])}
    spans = Spans()
    undo: list = []
    if ctx.trace:
        _instrument(state, spans, rec, undo)
    trace = DeviceTrace(ctx.device) if ctx.trace else None
    if cuda:
        torch.cuda.synchronize(dev)
    losses = []
    try:
        t0 = time.perf_counter()
        ctx.window_open(t0)
        if trace:
            trace.start()
            spans.on = True
        while time.perf_counter() - t0 < ctx.seconds:
            with spans.span("train.step"):
                losses.append(step())
        t1 = time.perf_counter()
        if trace:
            spans.on = False
            trace.close_window()
            trace.stop()
            rec["trace"] = trace.summary(spans)
    finally:
        while undo:
            undo.pop()()
    rec["window_s"] = t1 - t0
    rec["steps"] = len(losses)
    if "moe_events" in rec:
        rec["moe_ms"] = sum(a.elapsed_time(b) for a, b in rec.pop("moe_events"))
    if cuda:
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del state, params, opt, raw, train_step, tx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    c0 = time.perf_counter()
    reference = check.train_reference(m, ctx.seed, tr, dev)
    numbers = check.train_numbers(program, reference)
    ctx.log(f"reference over {tr['check']['steps']} steps: "
            f"{time.perf_counter() - c0:.1f} s; losses program "
            f"{program['losses']} reference {reference['losses']}; worst "
            f"gradient leaf {numbers['grad_at']}, worst change leaf "
            f"{numbers['change_at']}")
    bad = [x for x in program["losses"] + losses if x != x or abs(x) == float("inf")]
    return {
        "attempted": len(losses) + len(program["losses"]), "failed": len(bad),
        "end_to_end": {"train_tokens_per_s":
                       len(losses) * B * S / (t1 - t0) if losses else None},
        "record": rec,
        "numbers": {k: v for k, v in numbers.items()
                    if not k.endswith("_at")},
        "program": program, "reference": reference}


def _first_gradient(opt, leaf, b1: float) -> torch.Tensor:
    """``leaf``'s first gradient as AdamW got it, from its first moment
    after one step (m = (1 - b1) g); zeros where the step left none."""
    m = opt.state.get(leaf, {}).get("exp_avg")
    if m is None:
        return torch.zeros(leaf.shape, device=leaf.device)
    return m.float() / (1 - b1)


def _instrument(state, spans: Spans, rec: dict, undo: list):
    """Wrap the step's layers for the traced run: spans around the
    forward, the optimizer and the MoE FFN; a synchronised time of each
    optimizer update; CUDA events around each MoE FFN forward; each
    flash kernel launch's bound."""
    import tpushare_torch.kernels.flash as kflash
    import tpushare_torch.kernels.flash_bwd as kbwd
    from tpushare_torch.workloads import model as pm
    rec.update(optimizer_ms=[], flash=[], moe_events=[])
    opt = state["opt"]
    opt_step = opt.step

    def step(*a, **kw):
        sync()
        t = time.perf_counter()
        with spans.span("adamw.step"):
            out = opt_step(*a, **kw)
            sync()
        if spans.on:
            rec["optimizer_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    moe_ffn = pm.moe_ffn

    def timed_moe(*a, **kw):
        if not spans.on or not a[1].is_cuda:
            return moe_ffn(*a, **kw)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with spans.span("moe.ffn"):
            e0.record()
            out = moe_ffn(*a, **kw)
            e1.record()
        rec["moe_events"].append((e0, e1))
        return out

    fwd, dq, dkdv = kflash.flash_fwd, kbwd.flash_bwd_dq, kbwd.flash_bwd_dkdv

    def bound(kind, q, k, causal, window):
        if spans.on:
            B, H, S, D = q.shape
            args = (B, H, k.shape[1], S, D, q.dtype, causal, window)
            b = (arith.flash_bound(*args) if kind == "fwd"
                 else arith.flash_bwd_bound(kind, *args))
            rec["flash"].append(b["bound_ms"])

    def flash_fwd(q, k, v, causal, window=None, pipelined=False):
        bound("fwd", q, k, causal, window)
        return fwd(q, k, v, causal, window=window, pipelined=pipelined)

    def flash_bwd_dq(qs, k, v, do, lse, delta, causal, window=None):
        bound("dq", qs, k, causal, window)
        return dq(qs, k, v, do, lse, delta, causal, window)

    def flash_bwd_dkdv(qs, k, v, do, lse, delta, causal, window=None):
        bound("dkdv", qs, k, causal, window)
        return dkdv(qs, k, v, do, lse, delta, causal, window)

    loss_fn = pm.loss_fn
    opt.step = step
    pm.moe_ffn = timed_moe
    pm.loss_fn = spans.wrap(loss_fn, "train.forward")
    kflash.flash_fwd = flash_fwd
    kbwd.flash_bwd_dq = flash_bwd_dq
    kbwd.flash_bwd_dkdv = flash_bwd_dkdv

    def restore():
        opt.__dict__.pop("step", None)
        pm.moe_ffn, pm.loss_fn = moe_ffn, loss_fn
        kflash.flash_fwd = fwd
        kbwd.flash_bwd_dq, kbwd.flash_bwd_dkdv = dq, dkdv

    undo.append(restore)
