"""The plain reference of the benchmark's models: a Mistral-style decoder
(Mixtral's when the sizes name experts), written from the published
description in plain PyTorch, in float32 with TF32 off.

What it follows (Mistral-7B-v0.1 and Mixtral-8x7B-v0.1 as published,
with the departures each configuration file lists): RMSNorm, rotary
embeddings on the two halves of each head, grouped-query attention,
causal with a sliding window where the configuration has one, a SwiGLU
feed-forward (silu(x W1) * (x W3)) W2, or top-k routing over the experts
with the kept gates renormalised and every routed token computed (no
capacity), an untied output head, next-token cross-entropy plus the
configured share of the load-balancing loss, and AdamW.

It reads only the weights and tokens the benchmark drew, never anything
the program made. It works a layer at a time (the serving check over
several sequences at once, training with each layer's forward computed
again for its backward), so that it fits on the card beside what is
left after the program's state is freed.

``Precision`` says how the products' operands are held: the stored
weights (``weight_bits`` None) or symmetric per-output-channel int8 or
int4 of them; keys and values as stored or as symmetric int8 per
(token, head); and ``fp8``, every product's operands rounded to
float8_e4m3 with a per-tensor scale (the lower-precision control of a
bf16 configuration).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def strict_fp32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class Precision:
    weight_bits: int | None = None
    kv_bits: int | None = None
    fp8: bool = False


FP32 = Precision()


def quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-output-channel quantisation of ``w`` [..., in, out]
    (scale = max|w| over the input dim / (2**(bits-1) - 1)), returned
    as the float32 values it stands for."""
    qmax = 2 ** (bits - 1) - 1
    w = w.float()
    scale = (w.abs().amax(dim=-2, keepdim=True) / qmax).clamp_min(1e-8)
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def kv_quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric quantisation per (token, head) over the head's values."""
    qmax = 2 ** (bits - 1) - 1
    scale = (x.abs().amax(dim=-1, keepdim=True) / qmax).clamp_min(1e-8)
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3 under a per-tensor scale, with the
    gradient passed straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x.detach())


def _ops(prec: Precision):
    return _fp8 if prec.fp8 else (lambda x: x)


def mm(a, b, prec: Precision):
    r = _ops(prec)
    return r(a) @ r(b)


def rmsnorm(x, g, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def rope(x, pos, theta: float):
    """x [T, heads, hd], pos [T]: rotate each head's two halves."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int | None, prec: Precision,
              block: int = 1024):
    """Causal (and windowed) grouped-query attention of one sequence:
    q [T, H, hd], k and v [T, Hkv, hd] -> [T, H * hd], a block of
    queries at a time over the keys they can see."""
    T, H, hd = q.shape
    Hkv = k.shape[1]
    r = _ops(prec)
    qg = q.reshape(T, Hkv, H // Hkv, hd)
    outs = []
    for q0 in range(0, T, block):
        q1 = min(T, q0 + block)
        lo = 0 if window is None else max(0, q0 - window + 1)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(lo, q1, device=q.device)[None]
        mask = kj <= qi
        if window is not None:
            mask = mask & (qi - kj < window)
        s = torch.einsum("tgrd,sgd->grts", r(qg[q0:q1]), r(k[lo:q1]))
        s = (s * hd ** -0.5).masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("grts,sgd->tgrd", r(p), r(v[lo:q1])))
    return torch.cat(outs).reshape(T, H * hd)


def moe(h, lw, m: dict, prec: Precision, route: list | None = None):
    """Top-k routing over every expert, gates renormalised over the kept
    k, each expert on the tokens routed to it; returns (y, aux), aux
    the Switch load-balancing loss E * sum_e f_e P_e with f_e the share
    of tokens whose first choice is e (no gradient) and P_e the mean
    router probability. ``route`` gets each token's margin: its k-th
    router logit less its (k+1)-th, by which its experts were chosen."""
    E, k = m["E"], m["k"]
    logits = h @ lw["wg"]
    if route is not None:
        top = torch.topk(logits.detach(), k + 1, dim=-1).values
        route.append(top[:, k - 1] - top[:, k])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    gates = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        out = mm(F.silu(mm(xe, lw["w1"][e], prec)) * mm(xe, lw["w3"][e], prec),
                 lw["w2"][e], prec)
        y = y.index_add(0, tok, out * gates[tok, slot, None])
    f_e = F.one_hot(top_i[:, 0], E).float().mean(dim=0).detach()
    return y, E * (f_e * probs.mean(dim=0)).sum()


def layer(x, lw, m: dict, prec: Precision, route: list | None = None):
    """One block over rows ``x`` [B, T, d] at positions 0..T-1 ->
    (x, aux). The FFN (and the router's statistics) sees all rows'
    tokens together; ``route`` as :func:`moe` has it."""
    B, T, d = x.shape
    H, Hkv, hd = m["H"], m["Hkv"], m["hd"]
    pos = torch.arange(T, device=x.device)
    rows = []
    for b in range(B):
        h = rmsnorm(x[b], lw["attn_norm"], m["eps"])
        q = rope(mm(h, lw["wq"], prec).reshape(T, H, hd), pos, m["theta"])
        kk = rope(mm(h, lw["wk"], prec).reshape(T, Hkv, hd), pos, m["theta"])
        vv = mm(h, lw["wv"], prec).reshape(T, Hkv, hd)
        if prec.kv_bits:
            kk, vv = kv_quantize(kk, prec.kv_bits), kv_quantize(vv, prec.kv_bits)
        rows.append(x[b] + mm(attention(q, kk, vv, m["window"], prec),
                              lw["wo"], prec))
    x = torch.stack(rows)
    h = rmsnorm(x, lw["ffn_norm"], m["eps"]).reshape(B * T, d)
    if m["E"]:
        y, aux = moe(h, lw, m, prec, route)
    else:
        y = mm(F.silu(mm(h, lw["w1"], prec)) * mm(h, lw["w3"], prec),
               lw["w2"], prec)
        aux = torch.zeros((), device=x.device)
    return x + y.reshape(B, T, d), aux


PRODUCTS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def layer_weights(weights: dict, i: int, prec: Precision,
                  grad: bool = False) -> dict:
    """Layer ``i``'s weights in float32, the products' quantised as
    ``prec`` says; with ``grad``, leaves that take a gradient."""
    out = {}
    for name, w in weights["layers"].items():
        v = w[i].to(torch.float32, copy=True)
        if prec.weight_bits and name in PRODUCTS:
            v = quantize(v, prec.weight_bits)
        out[name] = v.requires_grad_() if grad else v
    return out


def _head_weight(weights: dict, prec: Precision):
    w = weights["lm_head"].float()
    return quantize(w, prec.weight_bits) if prec.weight_bits else w


@torch.no_grad()
def served_logits(weights: dict, m: dict, seqs: list, prec: Precision,
                  device) -> list:
    """Logits [n, V] at each served position of each sequence. ``seqs``
    holds ``(prompt, served)`` token lists; the sequence fed is the
    prompt and the served tokens but the last, and the logits returned
    are those that chose each served token."""
    strict_fp32()
    embed = weights["embed"]
    xs, firsts = [], []
    for prompt, served in seqs:
        toks = torch.tensor(list(prompt) + list(served[:-1]),
                            dtype=torch.long, device=device)
        xs.append(embed[toks].float()[None])
        firsts.append(len(prompt) - 1)
    for i in range(m["L"]):
        lw = layer_weights(weights, i, prec)
        xs = [layer(x, lw, m, prec)[0] for x in xs]
    head = _head_weight(weights, prec)
    g = weights["final_norm"].float()
    return [mm(rmsnorm(x[0, f:], g, m["eps"]), head, prec)
            for x, f in zip(xs, firsts)]


# -- training -------------------------------------------------------------------

@dataclasses.dataclass
class AdamW:
    """AdamW with decoupled weight decay (decay, then the moment update,
    then the bias-corrected step; eps outside the square root), computed
    in float32 per leaf; parameters and moments are stored back in the
    leaf's own type, as the configuration keeps them."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    wd: float = 1e-4

    def __post_init__(self):
        self.state: dict = {}

    def update(self, key: str, p: torch.Tensor, g: torch.Tensor, t: int):
        st = self.state.get(key)
        if st is None:
            st = self.state[key] = (torch.zeros_like(p), torch.zeros_like(p))
        m0, v0 = st
        pf = p.float() * (1.0 - self.lr * self.wd)
        m1 = self.b1 * m0.float() + (1 - self.b1) * g
        v1 = self.b2 * v0.float() + (1 - self.b2) * g * g
        denom = v1.sqrt() / math.sqrt(1 - self.b2 ** t) + self.eps
        pf = pf - self.lr / (1 - self.b1 ** t) * m1 / denom
        p.copy_(pf.to(p.dtype))
        m0.copy_(m1.to(m0.dtype))
        v0.copy_(v1.to(v0.dtype))


def train(weights: dict, m: dict, batches, opt: AdamW,
          prec: Precision = FP32, on_grad=None, on_route=None,
          loss_share: float = 1.0) -> list[float]:
    """Steps of next-token training on ``batches`` ([B, S + 1] token
    rows), updating ``weights`` (the stacked tree, in its own types) in
    place. Each step runs the layers forward without a graph, keeping
    each layer's input, then the head's loss and gradient, then each
    layer again, last first, with a graph for its backward, updating a
    leaf as soon as its gradient is whole. ``on_grad(t, path, grad)``
    sees each leaf's float32 gradient of step t before its update;
    ``on_route(margins)`` sees, for the first step's tokens in order
    [B * S], the smallest routing margin over the expert layers (as
    :func:`moe` gives it), where the model has experts. Returns the
    losses (cross-entropy plus the configured share of the layers' mean
    load-balancing loss). ``loss_share`` below 1 takes the cross-entropy
    over that leading share of each row's positions only: a planted
    fault, the mean over part of the batch."""
    strict_fp32()
    L, coef = m["L"], m["aux"]
    losses = []
    for t, tokens in enumerate(batches, start=1):
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        with torch.no_grad():
            xs = [weights["embed"][inp].float()]
            auxs = []
            route = [] if t == 1 and m["E"] else None
            for i in range(L):
                x, aux = layer(xs[-1], layer_weights(weights, i, prec), m,
                               prec, route)
                xs.append(x)
                auxs.append(float(aux))
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
        losses.append(float(ce.detach()) + coef * sum(auxs) / L)
        seen = on_grad or (lambda *a: None)
        for key, leaf in (("final_norm", g), ("lm_head", head)):
            seen(t, key, leaf.grad)
            opt.update(key, weights[key], leaf.grad, t)
        dx = xl.grad
        xs.pop()
        for i in reversed(range(L)):
            x_in = xs.pop().requires_grad_()
            lw = layer_weights(weights, i, prec, grad=True)
            out, aux = layer(x_in, lw, m, prec)
            outs, grads = [out], [dx]
            if aux.requires_grad:
                outs.append(aux)
                grads.append(torch.tensor(coef / L, device=dx.device))
            torch.autograd.backward(outs, grads)
            for name, leaf in lw.items():
                key = f"layers.{i}.{name}"
                seen(t, key, leaf.grad)
                opt.update(key, weights["layers"][name][i], leaf.grad, t)
            dx = x_in.grad
            del out, lw
        ge = torch.zeros(weights["embed"].shape, device=dx.device)
        ge.index_add_(0, inp.reshape(-1), dx.reshape(-1, dx.shape[-1]))
        seen(t, "embed", ge)
        opt.update("embed", weights["embed"], ge, t)
        del ge, dx
    return losses
