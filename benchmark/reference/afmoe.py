"""The plain reference of the AFMoE cells: Arcee's Trinity decoder,
written from the published description (``config.json``, and for what
it does not say transformers' ``modeling_afmoe.py`` and torchtitan's MoE
router, as the configuration file's ``assumed`` lists), in plain
PyTorch, in float32 with TF32 off.

A layer i, tokens x [T, d]:

    h = RMSNorm(x; g_in)
    q = RMSNorm_hd(h Wq; g_q), k = RMSNorm_hd(h Wk; g_k), v = h Wv
    q, k = RoPE(q, k) on a sliding layer, unchanged on a full one
    o = softmax(q k^T / sqrt(hd) + mask_i) v   causal, and on a sliding
        layer each query sees its last ``window`` keys
    x = x + RMSNorm((o * sigmoid(h Wgate)) Wo; g_post_attn)
    u = RMSNorm(x; g_pre_mlp)
    m = SwiGLU(u) on the leading dense layers; otherwise the shared
        expert's SwiGLU plus, over the token's top-k of s + b among all
        E experts (s = sigmoid(u Wr), b the selection bias), the held
        experts' route_scale * s_e / sum(top-k s) * SwiGLU_e(u)
    x = x + RMSNorm(m; g_post_mlp)

around an embedding times sqrt(d), a final RMSNorm and an untied head,
with next-token cross-entropy (no load-balancing loss), AdamW, and
after each step the selection bias moved by ``bias_rate`` times the
centred sign of each expert's load below the mean. It computes the
same share of each MoE layer as one card does: the shared expert and
the held experts' terms. It routes by its own scores plus its own bias,
with nothing taken from the program.

It works a layer at a time as :mod:`benchmark.reference.model` does, and
its attention a block of queries at a time under checkpointing, so that
the backward of a layer at 4 rows of 8192 positions fits beside what is
left on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..weights_afmoe import BUFFERS, layer_of
from .model import FP32, AdamW, Precision, _ops, mm, rmsnorm, rope, \
    strict_fp32


def _block(q, k, v, q0: int, lo: int, window: int | None, fp8: bool):
    T, Hkv, G, hd = q.shape
    r = _ops(Precision(fp8=fp8))
    qi = torch.arange(q0, q0 + T, device=q.device)[:, None]
    kj = torch.arange(lo, lo + k.shape[0], device=q.device)[None]
    mask = kj <= qi
    if window is not None:
        mask = mask & (qi - kj < window)
    s = torch.einsum("tgrd,sgd->grts", r(q), r(k)) * hd ** -0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("grts,sgd->tgrd", r(p), r(v))


def attention(q, k, v, window: int | None, prec: Precision,
              block: int = 1024):
    """Causal (and windowed) grouped-query attention of one sequence:
    q [T, H, hd], k and v [T, Hkv, hd] -> [T, H * hd], a block of
    queries at a time over the keys it can see, each block recomputed
    in the backward instead of kept."""
    T, H, hd = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(T, Hkv, H // Hkv, hd)
    outs = []
    for q0 in range(0, T, block):
        q1 = min(T, q0 + block)
        lo = 0 if window is None else max(0, q0 - window + 1)
        args = (qg[q0:q1], k[lo:q1], v[lo:q1], q0, lo, window, prec.fp8)
        if torch.is_grad_enabled():
            outs.append(torch.utils.checkpoint.checkpoint(
                _block, *args, use_reentrant=False))
        else:
            outs.append(_block(*args))
    return torch.cat(outs).reshape(T, H * hd)


def swiglu(x, w1, w3, w2, prec: Precision):
    return mm(F.silu(mm(x, w1, prec)) * mm(x, w3, prec), w2, prec)


def moe(u, lw, m: dict, prec: Precision, route: list | None = None):
    """The MoE layer's share over tokens ``u`` [T, d]: (y, load), load
    the pairs routed to each of all E experts. ``route`` gets each
    token's margin of s + b between its k-th and (k+1)-th choice."""
    k = m["k"]
    s = torch.sigmoid(u @ lw["wg"])
    top = torch.topk(s.detach() + lw["router_bias"], k + 1, dim=-1)
    idx = top.indices[:, :k]
    if route is not None:
        route.append(top.values[:, k - 1] - top.values[:, k])
    kept = s.gather(-1, idx)
    gates = m["route_scale"] * kept / kept.sum(dim=-1, keepdim=True)
    y = swiglu(u, lw["shared_w1"], lw["shared_w3"], lw["shared_w2"], prec)
    for e in range(m["held"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(u[tok], lw["w1"][e], lw["w3"][e], lw["w2"][e], prec)
        y = y.index_add(0, tok, out * gates[tok, slot, None])
    return y, torch.bincount(idx.reshape(-1), minlength=m["E"])


def attention_rows(x, lw, i: int, m: dict, prec: Precision):
    """Block ``i``'s attention and its residual add over rows ``x`` [B, T,
    d] at positions 0..T-1, a row at a time."""
    B, T, d = x.shape
    H, Hkv, hd, eps = m["H"], m["Hkv"], m["hd"], m["eps"]
    sliding = m["types"][i] == "sliding_attention"
    pos = torch.arange(T, device=x.device)
    rows = []
    for b in range(B):
        h = rmsnorm(x[b], lw["attn_norm"], eps)
        q = rmsnorm(mm(h, lw["wq"], prec).reshape(T, H, hd), lw["g_q"], eps)
        kk = rmsnorm(mm(h, lw["wk"], prec).reshape(T, Hkv, hd), lw["g_k"],
                     eps)
        vv = mm(h, lw["wv"], prec).reshape(T, Hkv, hd)
        if sliding:
            q, kk = rope(q, pos, m["theta"]), rope(kk, pos, m["theta"])
        o = attention(q, kk, vv, m["window"] if sliding else None, prec)
        o = o * torch.sigmoid(mm(h, lw["wgate"], prec))
        rows.append(x[b] + rmsnorm(mm(o, lw["wo"], prec),
                                   lw["post_attn_norm"], eps))
    return torch.stack(rows)


def layer(x, lw, i: int, m: dict, prec: Precision,
          route: list | None = None):
    """Block ``i`` over rows ``x`` [B, T, d] at positions 0..T-1 ->
    (x, load or None). The FFN sees all rows' tokens together."""
    B, T, d = x.shape
    eps = m["eps"]
    x = attention_rows(x, lw, i, m, prec)
    u = rmsnorm(x, lw["ffn_norm"], eps).reshape(B * T, d)
    load = None
    if i < m["Ld"]:
        y = swiglu(u, lw["dense_w1"], lw["dense_w3"], lw["dense_w2"], prec)
    else:
        y, load = moe(u, lw, m, prec, route)
    return x + rmsnorm(y, lw["post_ffn_norm"], eps).reshape(B, T, d), load


def layer_weights(weights: dict, i: int, m: dict,
                  grad: bool = False) -> dict:
    """Layer ``i``'s weights in float32 (with ``grad``, leaves that take
    a gradient) and its router bias as stored."""
    out = {}
    for name, w in weights["layers"].items():
        j = layer_of(m, name, i)
        if j is None or name == "router_load":
            continue
        if name == "router_bias":
            out[name] = w[j]
            continue
        v = w[j].to(torch.float32, copy=True)
        out[name] = v.requires_grad_() if grad else v
    return out


@torch.no_grad()
def logits(weights: dict, m: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token logits [B, T, V] of token rows [B, T]."""
    strict_fp32()
    x = weights["embed"][tokens].float() * m["embed_scale"]
    for i in range(m["L"]):
        x, _ = layer(x, layer_weights(weights, i, m), i, m, FP32)
    return mm(rmsnorm(x, weights["final_norm"].float(), m["eps"]),
              weights["lm_head"].float(), FP32)


def train(weights: dict, m: dict, batches, opt: AdamW,
          prec: Precision = FP32, on_grad=None, on_route=None,
          loss_share: float = 1.0) -> list[float]:
    """Steps of next-token training on ``batches`` ([B, S + 1] token
    rows), updating ``weights`` (the stacked tree, in its own types) in
    place: each step the layers forward without a graph, keeping each
    layer's input and each MoE layer's load, then the head's loss and
    gradient, then each layer again, last first, with a graph for its
    backward, a leaf updated as soon as its gradient is whole; then each
    MoE layer's selection bias from its load. ``on_grad(t, path, grad)``
    sees each leaf's float32 gradient of step t before its update;
    ``on_route(margins)`` the first step's smallest routing margin over
    the MoE layers at each token [B * S]. Returns the cross-entropy
    losses; ``loss_share`` below 1 takes it over that leading share of
    each row's positions only (a planted fault)."""
    strict_fp32()
    L, scale = m["L"], m["embed_scale"]
    losses = []
    seen = on_grad or (lambda *a: None)
    for t, tokens in enumerate(batches, start=1):
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        with torch.no_grad():
            xs = [weights["embed"][inp].float() * scale]
            loads = []
            route = [] if t == 1 else None
            for i in range(L):
                x, load = layer(xs[-1], layer_weights(weights, i, m), i, m,
                                prec, route)
                xs.append(x)
                if load is not None:
                    loads.append(load)
            if route and on_route:
                on_route(torch.stack(route).amin(dim=0))
        xl = xs[-1].requires_grad_()
        g = weights["final_norm"].to(torch.float32, copy=True)
        head = weights["lm_head"].to(torch.float32, copy=True)
        g.requires_grad_()
        head.requires_grad_()
        logits = mm(rmsnorm(xl, g, m["eps"]), head, prec)
        n = max(1, int(logits.shape[1] * loss_share))
        ce = F.cross_entropy(logits[:, :n].reshape(-1, logits.shape[-1]),
                             tgt[:, :n].reshape(-1))
        ce.backward()
        del logits
        losses.append(float(ce.detach()))
        for key, leaf in (("final_norm", g), ("lm_head", head)):
            seen(t, key, leaf.grad)
            opt.update(key, weights[key], leaf.grad, t)
        dx = xl.grad
        xs.pop()
        for i in reversed(range(L)):
            x_in = xs.pop().requires_grad_()
            lw = layer_weights(weights, i, m, grad=True)
            out, _ = layer(x_in, lw, i, m, prec)
            out.backward(dx)
            for name, leaf in lw.items():
                if name in BUFFERS:
                    continue
                key = f"layers.{i}.{name}"
                j = layer_of(m, name, i)
                # a layer whose held experts got no pair: their weights'
                # gradient is zero, as the program's stacked leaf has it
                grad = torch.zeros_like(leaf) if leaf.grad is None \
                    else leaf.grad
                seen(t, key, grad)
                opt.update(key, weights["layers"][name][j], grad, t)
            dx = x_in.grad
            del out, lw
        ge = torch.zeros(weights["embed"].shape, device=dx.device)
        ge.index_add_(0, inp.reshape(-1), dx.reshape(-1, dx.shape[-1]) * scale)
        seen(t, "embed", ge)
        opt.update("embed", weights["embed"], ge, t)
        del ge, dx
        for j, load in enumerate(loads):
            c = load.float()
            sgn = torch.sign(c.mean() - c)
            weights["layers"]["router_bias"][j] += m["bias_rate"] * (
                sgn - sgn.mean())
    return losses
