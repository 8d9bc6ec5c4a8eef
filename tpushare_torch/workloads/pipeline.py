"""Pipeline parallelism, a GPipe schedule over a "pp" mesh axis: the port of
``tpushare/workloads/pipeline.py``.

The llama layer stack is split into ``pp`` contiguous stages, one a rank;
M microbatches stream through them in M + P - 1 ticks (stage i takes
microbatch t - i at tick t), and each tick's stage-to-stage handoff is a
:func:`~tpushare_torch.workloads.parallel.ppermute` hop. The stage body is
``model.decoder_layer`` over the rank's layers with no mesh inside, the
same body in the same order as ``model.forward_with_aux``, so dense logits
match the sequential model. The embedding and the head run on every rank,
outside the stages, as in the reference.

Schedule choices of the port (the reference computes every tick on
every stage, on don't-care data in the bubbles, which a compiled SPMD
program wants):

- A rank computes only its M real ticks; a bubble tick passes the
  handoff it received straight on. So a rank launches K1 M x L/P times
  a forward (and K2, K3 as often in the backward) with ``--attn flash``.
- Every rank runs every tick's handoff, forward and backward. A tick's
  handoff is one collective over the axis, and its backward is posted by
  autograd only if the rank's graph reaches it: stage 0 never uses what
  it receives and the last stage sends to no one. So each rank ties every
  handoff it leaves unused into its chain (:func:`parallel.tie`), and
  the chain of handoffs runs from the last tick to the first on every
  rank, one backward handoff after the other, the same order everywhere.
- The stage-summed output is the last stage's (the others add zeros):
  :func:`parallel.reduce_from`, a sum forward and the identity backward,
  since every rank computes the same loss from it. The embedding's
  gradient is real on stage 0 only and is summed over "pp" by
  :func:`parallel.copy_to` on the embedded tokens, whose backward comes
  last on every rank (the initial handoff state is tied to it).

The parameters may be the whole tree on every rank (each computes its own
stage's layers), or a stage's tree from :func:`stage_params`, which keeps
only this rank's layers. MoE caveat, as in the reference: routing works
per microbatch, so logits match only while routing is dropless, and the
aux loss is the mean over stages and microbatches of per-microbatch
values.
"""

from __future__ import annotations

import torch

from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.model import (
    ModelConfig, _matmul, _rmsnorm, decoder_layer)
from tpushare_torch.workloads.parallel import P


def stage_layer_specs(params: dict) -> dict:
    """The spec of each stacked ``params["layers"]`` tensor: the layer
    axis over "pp"."""
    return {name: P("pp", *([None] * ((w["int8"] if isinstance(w, dict)
                                       else w).dim() - 1)))
            for name, w in params["layers"].items()}


def _stage_range(cfg: ModelConfig, mesh, axis: str) -> tuple[int, int]:
    return parallel.shard_range(cfg.n_layers, mesh, axis)


def stage_params(params: dict, cfg: ModelConfig, mesh,
                 axis: str = "pp") -> dict:
    """A stage's tree: ``params`` with only this rank's contiguous layers
    under "layers" (copies, so the whole stacks can be freed), the
    embedding, final norm and head as they are."""
    lo, hi = _stage_range(cfg, mesh, axis)
    layers = params["layers"]
    if isinstance(layers, list):
        mine = layers[lo:hi]
    else:
        mine = {n: w[lo:hi].clone() for n, w in layers.items()}
    return {**params, "layers": mine}


def _stage_layers(params: dict, cfg: ModelConfig, mesh, axis: str) -> list:
    """This rank's layers as per-layer dicts, from the whole tree or a
    stage's tree."""
    layers = params["layers"]
    count = len(layers) if isinstance(layers, list) else \
        next(iter(layers.values())).shape[0]
    lo, hi = _stage_range(cfg, mesh, axis)
    if count == cfg.n_layers:
        ids = range(lo, hi)
    elif count == hi - lo:
        ids = range(count)
    else:
        raise ValueError(f"{count} layers: neither the model's "
                         f"{cfg.n_layers} nor a stage's {hi - lo}")
    if isinstance(layers, list):
        return [layers[i] for i in ids]
    return [{n: w[i] for n, w in layers.items()} for i in ids]


def _sum_embed_grad(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The embedded tokens, whose gradient is summed over ``axis`` in the
    backward: only stage 0 reads them, so the embedding's gradient is
    real on rank 0 and zero on the others until this sum."""
    return parallel.copy_to(x, mesh, axis)


def pipelined_forward_with_aux(params: dict, tokens: torch.Tensor,
                               cfg: ModelConfig, mesh,
                               microbatches: int | None = None,
                               axis: str = "pp"):
    """tokens [B, S] (the same on every rank) -> (logits [B, S, vocab]
    fp32, aux) through a GPipe pipeline over ``axis`` of ``mesh``, on
    every rank. ``cfg.n_layers`` must divide into the axis's stages and
    the batch into ``microbatches`` (default: one per stage)."""
    n_stages = parallel.axis_size(mesh, axis)
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages")
    if cfg.afmoe:
        raise ValueError("the pipeline runs uniform layers, not AFMoE's")
    B, S = tokens.shape
    M = microbatches or n_stages
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    params, _ = parallel.localize(params)
    layers = _stage_layers(params, cfg, mesh, axis)
    stage, last = parallel.axis_rank(mesh, axis), n_stages - 1

    x = _sum_embed_grad(params["embed"][tokens], mesh, axis)   # [B, S, d]
    xmb = x.reshape(M, mb, S, x.shape[-1])
    positions = torch.arange(S, device=tokens.device).expand(mb, S)
    # every handoff must carry a gradient on every rank whenever one is
    # recorded (which rank's input needs one is the sender's business)
    state = torch.zeros_like(xmb[0]).requires_grad_(torch.is_grad_enabled())
    state = parallel.tie(state, x)
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    outs, auxs = [], []
    for t in range(M + n_stages - 1):
        # stage i hands last tick's activation to stage i+1
        recv = parallel.ppermute(state, fwd_perm, mesh, axis)
        j = t - stage
        if not 0 <= j < M:
            state = recv               # a bubble: nothing real to compute
            continue
        y = parallel.tie(xmb[j], recv) if stage == 0 else recv
        layer_aux = []
        for lp in layers:
            y, aux = decoder_layer(y, lp, positions, cfg)
            layer_aux.append(aux)
        auxs.append(torch.stack(layer_aux).mean())
        if stage == last:
            outs.append(y)
        state = y
    if stage == last:
        y = torch.cat(outs)
    else:
        y = torch.zeros((B, S, x.shape[-1]), dtype=x.dtype, device=x.device)
    # only the last stage holds real outputs; every rank gets them
    y = parallel.reduce_from(parallel.tie(y, state), mesh, axis)
    aux = parallel.reduce_from(torch.stack(auxs).sum(), mesh, axis) \
        / (n_stages * M)
    x = _rmsnorm(y, params["final_norm"], cfg.rms_norm_eps)
    logits = _matmul(x, params["lm_head"]).float()
    return logits, aux


def pipelined_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                      mesh, microbatches: int | None = None) -> torch.Tensor:
    """Logits-only wrapper over :func:`pipelined_forward_with_aux`."""
    return pipelined_forward_with_aux(params, tokens, cfg, mesh,
                                      microbatches)[0]


def make_pipelined_train_step(cfg: ModelConfig, mesh,
                              microbatches: int | None = None,
                              learning_rate: float = 3e-4):
    """``(tx, train_step)`` of ``model.make_train_step`` with the forward
    (and so the GPipe backward) pipelined over "pp": ``train_step(params,
    opt_state, tokens)`` with the same tokens on every rank, over a
    ``model.train_params`` tree (the whole tree, or a stage's). A rank's
    AdamW steps the leaves that got a gradient: its stage's layers, and
    the embedding, final norm and head, which come out equal on every
    rank."""
    from tpushare_torch.workloads.model import make_train_step

    def fwd(params, tokens, cfg):
        return pipelined_forward_with_aux(params, tokens, cfg, mesh,
                                          microbatches)

    return make_train_step(cfg, learning_rate, forward_fn=fwd)
