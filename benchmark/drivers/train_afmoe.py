"""The training driver of the AFMoE (Trinity) cells: the port's train step
as the player calls it (``model.make_train_step`` over
``model.train_params``, the fused ``AdamW``, the selection bias's update
after it) on a :func:`~tpushare_torch.workloads.model.afmoe_config`
model, on rows of fresh tokens from the seed.

As :mod:`benchmark.drivers.train`: set-up runs the cell's checked steps
through the window's own call and feed, reading the first gradients and
the parameters' change then (not counted as set-up); the window runs
steps back to back; then the program's state is freed and the plain
reference (:mod:`benchmark.reference.afmoe`) follows the checked steps
from the same weights and rows. The traced run's instruments are the
train driver's."""

from __future__ import annotations

import gc
import time

import torch

from benchmark import arith_afmoe, check, weights, weights_afmoe
from benchmark.drivers.train import _first_gradient, _instrument
from benchmark.reference import afmoe as ref
from benchmark.trace import DeviceTrace, Spans


def port_config(m: dict, tr: dict):
    """The port's ``ModelConfig`` for the sizes and the traffic's
    settings."""
    from tpushare_torch.workloads.model import afmoe_config
    return afmoe_config(
        vocab=m["V"], d_model=m["d"], layer_types=m["types"],
        n_heads=m["H"], n_kv_heads=m["Hkv"], head_dim=m["hd"],
        d_ff=m["fd"], dense_layers=m["Ld"], n_experts=m["E"],
        top_k=m["k"], moe_d_ff=m["f"], shared_d_ff=m["fs"],
        window=m["window"], route_scale=m["route_scale"],
        bias_rate=m["bias_rate"], held=(0, m["held"]),
        rope_theta=float(m["theta"]), eps=m["eps"],
        dtype=getattr(torch, m["dtype"]),
        attn=tr.get("attn", "einsum")).validate()


def run(ctx) -> dict:
    tr, conf = ctx.cell["traffic"], ctx.cell["config"]
    m = weights_afmoe.sizes(conf)
    cuda = ctx.device.startswith("cuda")
    from tpushare_torch.workloads import model as pm

    dev = torch.device(ctx.device)
    if cuda:
        torch.cuda.set_device(dev)
    cfg = port_config(m, tr)
    B, S = tr["batch"], tr["seq"]
    raw = weights_afmoe.draw(m, ctx.seed, dev)
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
                if path.rsplit(".", 1)[-1] in weights_afmoe.BUFFERS:
                    continue
                g = _first_gradient(opt, leaf, b1)
                program["grads"][path] = float(g.norm())
                program["samples"][path] = g.reshape(-1)[check.sample_index(
                    g.numel(), ctx.seed, path, g.device)].cpu()
                if path == "embed":
                    program["rows"] = g[ids].cpu()
        if t == tr["check"]["steps"]:
            program["change"] = weights_afmoe.change_norms(m, ctx.seed, raw,
                                                           dev)
        ctx.check_s += time.perf_counter() - c0

    rec: dict = {"model": m,
                 "flops_per_step": arith_afmoe.train_step_flops(m, B, S)}
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
    reference = train_reference(m, ctx.seed, tr, dev)
    numbers = check.train_numbers(program, reference)
    ctx.log(f"reference over {tr['check']['steps']} steps: "
            f"{time.perf_counter() - c0:.1f} s; losses program "
            f"{program['losses']} reference {reference['losses']}; worst "
            f"gradient leaf {numbers['grad_at']}, worst change leaf "
            f"{numbers['change_at']}")
    bad = [x for x in program["losses"] + losses
           if x != x or abs(x) == float("inf")]
    return {
        "attempted": len(losses) + len(program["losses"]), "failed": len(bad),
        "end_to_end": {"train_tokens_per_s":
                       len(losses) * B * S / (t1 - t0) if losses else None},
        "record": rec,
        "numbers": {k: v for k, v in numbers.items()
                    if not k.endswith("_at")},
        "program": program, "reference": reference}


def train_reference(m: dict, seed: int, traffic: dict, device,
                    prec: ref.Precision = ref.FP32,
                    loss_share: float = 1.0) -> dict:
    """The reference's readings over the cell's checked steps, as
    :func:`benchmark.check.train_reference` gives them for the other
    training cells: losses, first gradients' norms and samples, the
    embedding's rows at once-occurring tokens, the routing margins
    (where the model has MoE layers) and the change's norms."""
    w = weights_afmoe.draw(m, seed, device)
    feed = weights.token_rows(seed, m["V"], traffic["batch"],
                              traffic["seq"], device)
    batches = [next(feed) for _ in range(traffic["check"]["steps"])]
    grads, samples, out = {}, {}, {}
    pos, ids = check.once(batches[0][:, :-1])

    def on_grad(t, key, grad):
        if t == 1:
            grads[key] = float(grad.norm())
            samples[key] = grad.reshape(-1)[check.sample_index(
                grad.numel(), seed, key, grad.device)].cpu()
            if key == "embed":
                out["rows"] = grad[ids].cpu()

    def on_route(margins):
        out["margins"] = margins[pos].cpu()

    opt = ref.AdamW(lr=traffic["learning_rate"])
    losses = ref.train(w, m, batches, opt, prec, on_grad=on_grad,
                       on_route=on_route, loss_share=loss_share)
    del opt
    return {"losses": losses, "grads": grads, "samples": samples,
            "change": weights_afmoe.change_norms(m, seed, w, device), **out}
