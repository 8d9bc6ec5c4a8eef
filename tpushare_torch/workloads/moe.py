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
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token slots for a batch of ``n_tokens``: the
        reference's float operations in its order, so C agrees at every
        T."""
        cap = math.ceil(self.top_k * n_tokens / self.n_experts
                        * self.capacity_factor)
        return max(cap, 1)


def moe_param_specs() -> dict:
    """The spec tree of one layer's MoE weights: the experts shard over
    the "ep" mesh axis, the router is replicated."""
    return {
        "wg": P(None, None),
        "w1": P("ep", None, None),
        "w3": P("ep", None, None),
        "w2": P("ep", None, None),
    }


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
    if specs is None and mesh is not None:
        specs = {n: P(*([None] * len(lead)), *s)
                 for n, s in moe_param_specs().items()}

    def normal(name, *shape, fan_in, dtype):
        spec = specs[name] if mesh is not None else None
        own, _ = parallel.draw((*lead, *shape), generator, fan_in ** -0.5,
                               dtype, spec, mesh, device=device)
        return own if mesh is None else parallel.as_dtensor(own, spec, mesh)

    return {"wg": normal("wg", d, E, fan_in=d, dtype=torch.float32),
            "w1": normal("w1", E, d, f, fan_in=d, dtype=cfg.dtype),
            "w3": normal("w3", E, d, f, fan_in=d, dtype=cfg.dtype),
            "w2": normal("w2", E, f, d, fan_in=f, dtype=cfg.dtype)}


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
    the [k, E] counts, the pairs ``kept`` in a slot of E'."""
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
        route.add(kept=kept[:, lo:hi].sum())
        route.end()
    return dispatch, combine, aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh=None):
    """x [..., d_model] -> (y [..., d_model], aux loss scalar fp32).
    ``params`` holds (at least) "wg", "w1", "w3" and "w2". The leading
    dims are flattened: capacity is per call over all T tokens (on a
    "dp" axis, over the global batch's). A dropped token's y is zero.
    On a mesh with an "ep" axis the experts are this rank's shard."""
    params, mesh = parallel.localize(params, mesh)
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    C = cfg.capacity(xt.shape[0] * parallel.axis_size(mesh, "dp"))
    logits = xt.float() @ params["wg"]
    n_local = params["w1"].shape[0]
    e0 = parallel.axis_rank(mesh, "ep") * n_local
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


def moe_ffn_reference(params: dict, x: torch.Tensor,
                      cfg: MoEConfig) -> torch.Tensor:
    """Every expert on every token, output the gate-weighted sum over
    each token's top-k experts, no capacity: equal to :func:`moe_ffn`
    when nothing drops."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt.float() @ params["wg"], dim=-1)
    masks, gates = _topk_gates(probs, cfg.top_k)
    h = (F.silu(torch.einsum("td,edf->etf", xt, params["w1"]))
         * torch.einsum("td,edf->etf", xt, params["w3"]))
    all_out = torch.einsum("etf,efd->etd", h, params["w2"])
    y = torch.zeros_like(xt)
    for mask, gate in zip(masks, gates):
        w = (mask * gate[:, None]).to(x.dtype)                  # [T, E]
        y = y + torch.einsum("te,etd->td", w, all_out)
    return y.reshape(*lead, d)


def expert_load(params: dict, x: torch.Tensor,
                cfg: MoEConfig) -> torch.Tensor:
    """Tokens routed to each expert at k=0, int32 [E]."""
    xt = x.reshape(-1, x.shape[-1])
    idx = (xt.float() @ params["wg"]).argmax(dim=-1)
    return torch.bincount(idx, minlength=cfg.n_experts).to(torch.int32)
