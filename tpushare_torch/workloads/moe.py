"""Mixture-of-experts FFN, GShard/Switch style: the port of
``tpushare/workloads/moe.py`` on one device.

Top-k routing with a static per-expert capacity C: tokens over capacity
are dropped (their FFN output is zero; the caller's residual carries
them). Dispatch and combine are ``[T, E, C]`` tensors contracted with
``torch.einsum``, and each expert's SwiGLU is a batched product over the
expert axis, as in the reference. The router runs in fp32 (its weight
``wg`` stays fp32 in a bf16 model; softmax and the slot bookkeeping are
fp32); the experts compute in the activations' dtype.

The routing contract is the reference's:

- each k picks the first maximum of the remaining probabilities, then
  removes that expert; the gates are renormalised over the kept experts;
- slots are taken by k first, then in token order;
- the Switch aux loss ``E * sum_e f_e * P_e`` reads the k=0 masks (no
  gradient) and the mean router probabilities (the gradient's path).

:func:`moe_ffn_reference` computes every expert on every token with no
capacity: the behavioural spec, equal to :func:`moe_ffn` when nothing
drops.

Dropless (``capacity_factor`` None, the AFMoE family's routing): the
router scores every expert (softmax as above, or ``score="sigmoid"``:
each expert's sigmoid, chosen by the top-k of score plus a selection
bias that takes no gradient, the kept scores renormalised and scaled by
``route_scale``); the (token, k) pairs whose expert this layer holds are
stably sorted by expert, gathered once, run through grouped SwiGLU
products over the held experts (``torch._grouped_mm`` on a card in bf16,
a loop over the experts elsewhere), written to their own (token, k) row
of a ``[T, k, d]`` buffer and summed over k: deterministic, with no
float atomics. A layer may hold a range of the experts it routes over
(``held``, one card's share under expert parallelism), and a shared
expert that every token takes. The per-expert counts over all experts
accumulate in the layer's ``router_load`` buffer, from which
:func:`update_router_bias` moves the selection bias after each step.

Expert parallelism (:func:`moe_param_specs`): the experts shard over the
"ep" mesh axis and the router is replicated. Each rank routes every
token with the replicated router, computes the dispatch and combine
slots of its own experts only, and the partial outputs are all-reduced
over "ep". The tokens are sharded over "dp" only; on a "dp" axis the
capacity, the slot order and the aux loss are the global batch's, as in
the reference, whose ``moe_ffn`` sees the whole batch. The all-to-all
token shuffle is not ported (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from tpushare_torch import metrics
from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.parallel import P


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int            # per-expert hidden width
    n_experts: int
    top_k: int = 2
    # None: dropless (every routed pair computed)
    capacity_factor: float | None = 1.25
    dtype: torch.dtype = torch.bfloat16
    # "softmax" (gates renormalised over the kept k) or "sigmoid" (chosen
    # by score + selection bias, renormalised, times route_scale)
    score: str = "softmax"
    route_scale: float = 1.0
    # width of the shared expert every token takes; 0 = none
    shared_d_ff: int = 0
    # [lo, hi): the experts this layer holds; None = all n_experts
    held: tuple[int, int] | None = None

    @property
    def held_range(self) -> tuple[int, int]:
        return self.held or (0, self.n_experts)

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token slots for a batch of ``n_tokens``: the
        reference's float operations in its order, so C agrees at every
        T."""
        cap = math.ceil(self.top_k * n_tokens / self.n_experts
                        * self.capacity_factor)
        return max(cap, 1)


def moe_param_specs(cfg: MoEConfig | None = None) -> dict:
    """The spec tree of one layer's MoE weights: the experts shard over
    the "ep" mesh axis; the router, and where ``cfg`` has them a shared
    expert and the sigmoid router's buffers, are replicated."""
    specs = {
        "wg": P(None, None),
        "w1": P("ep", None, None),
        "w3": P("ep", None, None),
        "w2": P("ep", None, None),
    }
    if cfg is not None and cfg.shared_d_ff:
        specs.update({"shared_w1": P(None, None), "shared_w3": P(None, None),
                      "shared_w2": P(None, None)})
    if cfg is not None and cfg.score == "sigmoid":
        specs.update({"router_bias": P(None), "router_load": P(None)})
    return specs


def init_moe_params(cfg: MoEConfig, generator: torch.Generator | None,
                    lead: tuple = (), mesh=None, device=None,
                    specs: dict | None = None) -> dict:
    """Router and stacked expert weights (expert axis after ``lead``, the
    leading axes of a stack such as ``(n_layers,)``), drawn from
    ``generator`` on its device in the order wg, w1, w3, w2: N(0, 1/fan_in)
    in fp32, the experts cast to ``cfg.dtype``, the router left fp32.
    With a ``mesh``, each rank keeps its shard under ``specs`` (default
    :func:`moe_param_specs`, with ``lead``'s axes unsharded) as DTensors;
    ``generator`` None allocates on ``device`` without drawing."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lo, hi = cfg.held_range
    if specs is None and mesh is not None:
        specs = {n: P(*([None] * len(lead)), *s)
                 for n, s in moe_param_specs(cfg).items()}

    def wrap(name, own):
        return own if mesh is None else parallel.as_dtensor(
            own, specs[name], mesh)

    def normal(name, *shape, fan_in, dtype):
        spec = specs[name] if mesh is not None else None
        own, _ = parallel.draw((*lead, *shape), generator, fan_in ** -0.5,
                               dtype, spec, mesh, device=device)
        return wrap(name, own)

    out = {"wg": normal("wg", d, E, fan_in=d, dtype=torch.float32),
           "w1": normal("w1", hi - lo, d, f, fan_in=d, dtype=cfg.dtype),
           "w3": normal("w3", hi - lo, d, f, fan_in=d, dtype=cfg.dtype),
           "w2": normal("w2", hi - lo, f, d, fan_in=f, dtype=cfg.dtype)}
    if cfg.shared_d_ff:
        fs = cfg.shared_d_ff
        out.update({"shared_w1": normal("shared_w1", d, fs, fan_in=d,
                                        dtype=cfg.dtype),
                    "shared_w3": normal("shared_w3", d, fs, fan_in=d,
                                        dtype=cfg.dtype),
                    "shared_w2": normal("shared_w2", fs, d, fan_in=fs,
                                        dtype=cfg.dtype)})
    if cfg.score == "sigmoid":
        dev = device if generator is None else generator.device
        for name in ("router_bias", "router_load"):
            out[name] = wrap(name, torch.zeros((*lead, E), device=dev))
    return out


def _topk_gates(probs: torch.Tensor, top_k: int):
    """probs [T, E] -> (masks, gates): ``top_k`` fp32 one-hots [T, E] and
    gates [T], renormalised to sum to 1 over the kept experts."""
    E = probs.shape[-1]
    masks, gates = [], []
    p = probs
    for _ in range(top_k):
        onehot = F.one_hot(p.argmax(dim=-1), E).to(torch.float32)
        gates.append((probs * onehot).sum(dim=-1))
        masks.append(onehot)
        p = p * (1.0 - onehot)
    denom = sum(gates)
    return masks, [g / denom.clamp_min(1e-9) for g in gates]


def _route(logits: torch.Tensor, top_k: int, capacity: int,
           experts: tuple[int, int] | None = None, mesh=None):
    """fp32 top-k capacity routing: logits [T, E] -> (dispatch [T, E', C]
    of 0/1, combine [T, E', C] of gates, aux load-balance loss), where E'
    are the experts ``experts`` = [lo, hi) (all by default).

    On a mesh with a "dp" axis the T tokens are this rank's rows of the
    batch and ``capacity`` is the global batch's: slots are taken by k
    first, then in global token order (the lower "dp" ranks' tokens
    first), and the aux loss reads the global means, as the reference's
    one call over the whole batch does. The gates enter the partial
    combine through :func:`parallel.copy_to` over "ep", whose backward sums
    each rank's share of their gradient.

    Traced, span ``moe.route`` counts the capacity ``slots`` (E' x C),
    the token-expert ``pairs`` (T x k) and, summed on the device from
    the [k, E] counts, the pairs ``kept`` in a slot of E', the pairs
    ``held`` (routed to E') and ``max_load`` (:func:`_load_attrs`)."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    masks, gates = _topk_gates(probs, top_k)
    lo, hi = experts or (0, E)
    route = metrics.span("moe.route", slots=(hi - lo) * capacity,
                         pairs=T * top_k).begin()

    n_dp = parallel.axis_size(mesh, "dp")
    if n_dp == 1:
        f_e = masks[0].mean(dim=0)       # fraction routed to e at k=0
        p_e = probs.mean(dim=0)          # mean router probability of e
    else:
        f_e = parallel.gather_counts(masks[0].sum(dim=0), mesh, "dp").sum(
            dim=0) / (T * n_dp)
        p_e = parallel.all_reduce_sum(probs.sum(dim=0), mesh, "dp") / (
            T * n_dp)
    aux = E * (f_e * p_e).sum()

    f32, dev = torch.float32, logits.device
    # slots the lower "dp" ranks take before this rank's tokens, per k
    counts = parallel.gather_counts(torch.stack([m.sum(dim=0) for m in masks]),
                                    mesh, "dp")          # [n_dp, k, E]
    before = counts[:parallel.axis_rank(mesh, "dp")].sum(dim=0)   # [k, E]
    everyone = counts.sum(dim=0)                                    # [k, E]
    dispatch = torch.zeros((T, hi - lo, capacity), dtype=f32, device=dev)
    combine = torch.zeros((T, hi - lo, capacity), dtype=f32, device=dev)
    prior = torch.zeros((E,), dtype=f32, device=dev)   # slots taken
    for k, (mask, gate) in enumerate(zip(masks, gates)):
        pos = torch.cumsum(mask, dim=0) - mask + prior + before[k]  # [T, E]
        prior = prior + everyone[k]
        pos_tok = (pos * mask).sum(dim=-1).long()               # [T]
        keep = (pos_tok < capacity).float()
        # a dropped token's slot is out of range: clamp it into range
        # (one_hot raises on it) and let keep zero the row
        slot = F.one_hot(pos_tok.clamp(max=capacity - 1),
                         capacity).to(torch.float32)            # [T, C]
        d_k = (mask[:, lo:hi, None] * slot[:, None, :]
               * keep[:, None, None])
        dispatch = dispatch + d_k
        gate = parallel.copy_to(gate, mesh, "ep")
        combine = combine + gate[:, None, None] * d_k
    if route:
        # this rank's tokens take the slots [start, start + n) of (k, e)
        start = before + torch.cumsum(everyone, dim=0) - everyone
        end = start + counts[parallel.axis_rank(mesh, "dp")]
        kept = end.clamp(max=capacity) - start.clamp(max=capacity)
        route.add(kept=kept[:, lo:hi].sum(),
                  **_load_attrs(counts[parallel.axis_rank(mesh, "dp")].sum(
                      dim=0), lo, hi))
        route.end()
    return dispatch, combine, aux


def _load_attrs(load: torch.Tensor, lo: int, hi: int) -> dict:
    """Span attributes from the pairs routed to each of all E experts
    (``load`` [E]), as 0-d device tensors: the pairs ``held`` ([lo, hi))
    and ``max_load``, the largest count over the mean k T / E."""
    return {"held": load[lo:hi].sum(),
            "max_load": load.max().float() / (load.sum().float()
                                              / load.shape[0])}


def _choose(logits: torch.Tensor, cfg: MoEConfig,
            bias: torch.Tensor | None):
    """fp32 routing of router logits [T, E] over every expert: (idx [T, k]
    the chosen experts, w [T, k] their fp32 gates, aux). Softmax: each k
    the first maximum of what is left, gates renormalised over the k (as
    :func:`_topk_gates`), aux the Switch loss. Sigmoid: the top-k of
    score + ``bias`` (no gradient through the choice), gates the chosen
    scores renormalised and times ``route_scale``, aux 0."""
    if cfg.score == "sigmoid":
        scores = torch.sigmoid(logits)
        pick = scores.detach() if bias is None else scores.detach() + bias
        idx = torch.topk(pick, cfg.top_k, dim=-1).indices
        kept = scores.gather(-1, idx)
        w = cfg.route_scale * kept / kept.sum(dim=-1, keepdim=True)
        return idx, w, torch.zeros((), device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    masks, gates = _topk_gates(probs, cfg.top_k)
    idx = torch.stack([m.argmax(dim=-1) for m in masks], dim=-1)
    aux = logits.shape[-1] * (masks[0].mean(dim=0) * probs.mean(dim=0)).sum()
    return idx, torch.stack(gates, dim=-1), aux


def _expert_products(xs: torch.Tensor, params: dict, counts: torch.Tensor,
                     sizes: list) -> torch.Tensor:
    """SwiGLU of each held expert over its rows of ``xs`` (rows grouped
    by expert, ``sizes`` of them a group, ``counts`` the same on the
    device): grouped products on a card in bf16, else one expert at a
    time."""
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if xs.is_cuda and xs.dtype == torch.bfloat16:
        offs = torch.cumsum(counts, dim=0, dtype=torch.int32)
        h = (F.silu(torch._grouped_mm(xs, w1, offs=offs))
             * torch._grouped_mm(xs, w3, offs=offs))
        return torch._grouped_mm(h, w2, offs=offs)
    outs, start = [], 0
    for e, n in enumerate(sizes):
        xe = xs[start:start + n]
        outs.append((F.silu(xe @ w1[e]) * (xe @ w3[e])) @ w2[e])
        start += n
    return torch.cat(outs)


def _dropless(params: dict, xt: torch.Tensor, idx: torch.Tensor,
              w: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The held experts' part of the output for tokens ``xt`` [T, d]
    routed to ``idx`` [T, k] with gates ``w``: the (token, k) pairs whose
    expert lies in [lo, hi), stably sorted by expert (pair order within
    one), gathered, through :func:`_expert_products`, scaled by their
    gate in the activations' dtype, written to their own row of a [T, k,
    d] buffer and summed over k. Reads the per-expert counts on the host
    once (the groups' sizes). Traced, span ``moe.experts`` (device time)
    holds the grouped products and their sizes."""
    T, k = idx.shape
    n, d = hi - lo, xt.shape[-1]
    local = (idx - lo).reshape(-1)
    key = torch.where((local >= 0) & (local < n), local,
                      torch.full_like(local, n))
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n + 1)[:n]
    sizes = counts.tolist()
    pairs = order[:sum(sizes)]
    xs = xt[pairs // k]
    with metrics.span("moe.experts", device=xt.is_cuda, pairs=len(pairs),
                      experts=n, d=d, f=params["w1"].shape[-1]):
        out = _expert_products(xs, params, counts, sizes)
    vals = out * w.reshape(-1)[pairs].to(out.dtype)[:, None]
    buf = xt.new_zeros((T * k, d)).index_put((pairs,), vals)
    return buf.reshape(T, k, d).sum(dim=1)


def _shared(params: dict, xt: torch.Tensor) -> torch.Tensor:
    return (F.silu(xt @ params["shared_w1"])
            * (xt @ params["shared_w3"])) @ params["shared_w2"]


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh=None):
    """x [..., d_model] -> (y [..., d_model], aux loss scalar fp32).
    ``params`` holds (at least) "wg", "w1", "w3" and "w2", with a shared
    expert "shared_w1", "shared_w3", "shared_w2", and for the sigmoid
    router its "router_bias" and "router_load" buffers. The leading dims
    are flattened: capacity is per call over all T tokens (on a "dp"
    axis, over the global batch's). A dropped token's y is zero. The
    experts held are ``cfg.held`` (all by default); on a mesh with an
    "ep" axis this rank's shard of them, which must split them evenly.
    Without a capacity the routing is dropless (:func:`_dropless`), and
    in a forward that records gradients (a training step) the pairs
    routed to each of all E experts are added to "router_load" where the
    layer has one."""
    params, mesh = parallel.localize(params, mesh)
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    logits = xt.float() @ params["wg"]
    n_local = params["w1"].shape[0]
    lo, hi = cfg.held_range
    if n_local * parallel.axis_size(mesh, "ep") != hi - lo:
        raise ValueError(
            f"experts [{lo}, {hi}) do not split into the {n_local} a rank "
            f"holds over {parallel.axis_size(mesh, 'ep')} 'ep' ranks")
    e0 = lo + parallel.axis_rank(mesh, "ep") * n_local
    if cfg.capacity_factor is None:
        y, aux = _routed(params, xt, logits, cfg, (e0, e0 + n_local), mesh)
        return y.reshape(*lead, d), aux
    C = cfg.capacity(xt.shape[0] * parallel.axis_size(mesh, "dp"))
    dispatch, combine, aux = _route(logits, cfg.top_k, C,
                                    (e0, e0 + n_local), mesh)
    # the gates round to the activations' dtype before the products
    xe = parallel.copy_to(xt, mesh, "ep")
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xe)
    h = (F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["w1"]))
         * torch.einsum("ecd,edf->ecf", expert_in, params["w3"]))
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w2"])
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    y = parallel.reduce_from(y, mesh, "ep")
    return y.reshape(*lead, d), aux


def _routed(params: dict, xt: torch.Tensor, logits: torch.Tensor,
            cfg: MoEConfig, experts: tuple[int, int], mesh):
    """The dropless layer: route every token over all E, the held
    experts' part summed over "ep", plus the shared expert once. Traced,
    span ``moe.route`` counts the ``pairs`` (T x k), and ``held`` and
    ``max_load`` as :func:`_route` does."""
    T, E = logits.shape
    route = metrics.span("moe.route", pairs=T * cfg.top_k).begin()
    idx, w, aux = _choose(logits, cfg, params.get("router_bias"))
    lo, hi = experts
    count = "router_load" in params and torch.is_grad_enabled()
    if route or count:
        load = torch.bincount(idx.reshape(-1), minlength=E)
        if count:
            params["router_load"].add_(load)
        if route:
            route.add(**_load_attrs(load, lo, hi))
            route.end()
    w = parallel.copy_to(w, mesh, "ep")
    y = _dropless(params, parallel.copy_to(xt, mesh, "ep"), idx, w, lo, hi)
    y = parallel.reduce_from(y, mesh, "ep")
    if cfg.shared_d_ff:
        y = y + _shared(params, xt)
    return y, aux


@torch.no_grad()
def update_router_bias(bias: torch.Tensor, load: torch.Tensor,
                       rate: float, mesh=None) -> None:
    """After a step: move the selection bias [.., E] towards an even load,
    ``b += rate * (s - mean(s))`` with ``s = sign(mean(c) - c)`` and c
    the pairs routed to each expert over the step's tokens (summed over
    "dp"), then empty the counts."""
    c = parallel.all_reduce_sum(load, mesh, "dp")
    s = torch.sign(c.mean(dim=-1, keepdim=True) - c)
    bias.add_(rate * (s - s.mean(dim=-1, keepdim=True)))
    load.zero_()


def moe_ffn_reference(params: dict, x: torch.Tensor,
                      cfg: MoEConfig) -> torch.Tensor:
    """Every held expert on every token, output the gate-weighted sum
    over each token's top-k experts that are held (and the shared expert),
    no capacity: equal to :func:`moe_ffn` when nothing drops."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    lo, hi = cfg.held_range
    idx, gates, _ = _choose(xt.float() @ params["wg"], cfg,
                            params.get("router_bias"))
    h = (F.silu(torch.einsum("td,edf->etf", xt, params["w1"]))
         * torch.einsum("td,edf->etf", xt, params["w3"]))
    all_out = torch.einsum("etf,efd->etd", h, params["w2"])
    y = torch.zeros_like(xt)
    for j in range(cfg.top_k):
        mask = F.one_hot(idx[:, j], cfg.n_experts)[:, lo:hi]
        w = (mask * gates[:, j, None]).to(x.dtype)              # [T, E']
        y = y + torch.einsum("te,etd->td", w, all_out)
    if cfg.shared_d_ff:
        y = y + _shared(params, xt)
    return y.reshape(*lead, d)


def expert_load(params: dict, x: torch.Tensor,
                cfg: MoEConfig) -> torch.Tensor:
    """Tokens routed to each expert at k=0, int32 [E]."""
    xt = x.reshape(-1, x.shape[-1])
    idx = (xt.float() @ params["wg"]).argmax(dim=-1)
    return torch.bincount(idx, minlength=cfg.n_experts).to(torch.int32)
