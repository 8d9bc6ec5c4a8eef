"""Llama-style decoder-only transformer in PyTorch: the port's model.

Counterpart of ``tpushare/workloads/model.py`` (dense and MoE presets,
forward, training and the KV-cached serving path). Parameters are the
reference's layout as plain dicts of tensors: ``{"embed", "layers":
{name: [L, ...]}, "final_norm", "lm_head"}``, with int8 weights as
``{"int8": int8 tensor, "scale": fp32 tensor}``, so weights carry across
from the JAX package with
:func:`tpushare_torch.workloads.convert.params_from_numpy`.

Training reads the same weights through :func:`train_params`, which
gives one leaf tensor per layer and weight (a view into the stacked
tensor), so autograd never builds a gradient the size of a whole stack
for one layer's slice, and the optimizer's in-place updates land in the
stacked tree.

Numerics follow the reference where it fixes them: RMSNorm and RoPE trig
in fp32, attention scores out of the product in the activation dtype and
then cast to fp32, probabilities cast to the activation dtype before the
PV product, int8 weights cast to the activation dtype with the scale
applied after the product.

Device: everything runs where the parameters are; :func:`init_params`
makes them on its generator's device.

Sharded: :func:`param_specs`, :func:`quant_specs` and :func:`batch_spec`
are the reference's layout (Megatron over "tp", experts over "ep", the
batch over "dp") in the port's spec type, and ``init_params(cfg, gen,
mesh=...)`` draws the same weights as ``init_params(cfg, gen)`` and keeps
each rank's shard as a DTensor (:mod:`tpushare_torch.workloads.parallel`).
Every function here takes such a tree: it computes on the local shards,
reads the local head counts from the weights' shapes, and adds the
reference's collectives: one all-reduce after ``wo`` and one after
``w2`` (or the experts) per layer, the gradient's all-reduce before the
column-parallel products, and the gather of the vocab-sharded logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tpushare_torch import metrics
from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.attention import (
    flash_attention, sliding_window_mask)
from tpushare_torch.workloads.moe import (
    MoEConfig, init_moe_params, moe_ffn, moe_param_specs)
from tpushare_torch.workloads.parallel import P


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    dtype: Any = torch.bfloat16
    # "einsum" or "flash" (the CUDA kernel). KV-cached decode steps use
    # the einsum core either way; a prefill from position 0 with "flash"
    # runs the kernel over the prompt chunk
    attn: str = "einsum"
    attn_window: int | None = None
    # KV-cache storage: "model" keeps cfg.dtype, "int8" stores symmetric
    # int8 per (token, kv head) plus an fp32 scale
    kv_cache_dtype: str = "model"
    # mixture-of-experts FFN (tpushare_torch/workloads/moe.py): 0 = dense
    # SwiGLU; >0 replaces every layer's FFN with moe_experts experts of
    # width d_ff
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def moe(self) -> MoEConfig | None:
        """MoEConfig for the FFN, or None when dense."""
        if self.moe_experts <= 0:
            return None
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.moe_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         dtype=self.dtype)

    def validate(self) -> "ModelConfig":
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"d_model {self.d_model} / n_heads {self.n_heads} / "
                f"n_kv_heads {self.n_kv_heads} do not divide")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window {self.attn_window} must be >= 1")
        if self.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}")
        if self.attn not in ("einsum", "flash"):
            raise ValueError(f"attn {self.attn!r}")
        return self


PRESETS = {
    # ~Llama-3-8B geometry (the BASELINE config #5 serving model)
    "llama-8b": ModelConfig(),
    "llama-mini": ModelConfig(vocab=2048, d_model=512, n_layers=4,
                              n_heads=8, n_kv_heads=4, d_ff=1408),
    "llama-tiny": ModelConfig(vocab=256, d_model=64, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=128),
    "llama-moe-tiny": ModelConfig(vocab=256, d_model=64, n_layers=2,
                                  n_heads=4, n_kv_heads=2, d_ff=128,
                                  moe_experts=4),
}


# -- init ---------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                mesh=None, int8: bool = False, device=None) -> dict:
    """Stacked-layer parameters (leading axis = layer), drawn from
    ``generator`` on its device: N(0, 1/fan_in) in fp32, cast to
    cfg.dtype, norms at one. Draw order: embed, wq, wk, wv, wo, the FFN,
    lm_head. The dense FFN draws w1, w3, w2; an MoE FFN draws each
    ``[L, ...]`` stack of :func:`~tpushare_torch.workloads.moe.init_moe_params`
    in its order (wg, left fp32, then w1, w3, w2), giving the reference's
    ``[L, d, E]`` router and ``[L, E, d, f]`` / ``[L, E, f, d]`` experts.

    ``int8`` returns ``quantize_int8`` of those weights. With a ``mesh``
    every rank draws the same values, one weight stack at a time and a
    piece at a time, keeps its shard under :func:`param_specs` (with
    ``int8``, :func:`quant_specs`: each weight quantized whole, then
    sharded) and returns DTensors. ``generator`` None allocates the same
    tree on ``device`` without drawing: a target to load into."""
    cfg.validate()
    dev = generator.device if generator is not None else torch.device(
        device or "cpu")
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    specs = param_specs(cfg) if mesh is not None else None

    def spec(name, top=False):
        if specs is None:
            return None
        return specs[name] if top else specs["layers"][name]

    def w(name, *shape, fan_in, top=False):
        s = spec(name, top)
        quant = int8 and name in QUANT_KEYS + ("lm_head",)
        own, amax = parallel.draw(shape, generator, fan_in ** -0.5,
                                  cfg.dtype, s, mesh, amax=quant, device=dev)
        if quant:
            return _wrap(_q_with(own, amax), _qspec(s) if s else None, mesh)
        return _wrap(own, s, mesh)

    def ones(name, *shape, top=False):
        t = torch.ones(shape, dtype=cfg.dtype, device=dev)
        return _wrap(t, spec(name, top), mesh)

    embed = w("embed", v, d, fan_in=d, top=True)
    layers = {
        "attn_norm": ones("attn_norm", L, d),
        "wq": w("wq", L, d, nh * hd, fan_in=d),
        "wk": w("wk", L, d, nkv * hd, fan_in=d),
        "wv": w("wv", L, d, nkv * hd, fan_in=d),
        "wo": w("wo", L, nh * hd, d, fan_in=nh * hd),
        "ffn_norm": ones("ffn_norm", L, d),
    }
    if cfg.moe_experts > 0:
        layers.update(init_moe_params(
            cfg.moe, generator, lead=(L,), mesh=mesh, device=dev,
            specs=None if specs is None else specs["layers"]))
    else:
        layers.update({"w1": w("w1", L, d, f, fan_in=d),
                       "w3": w("w3", L, d, f, fan_in=d),
                       "w2": w("w2", L, f, d, fan_in=f)})
    return {"embed": embed, "layers": layers,
            "final_norm": ones("final_norm", d, top=True),
            "lm_head": w("lm_head", d, v, fan_in=d, top=True)}


def _wrap(value, spec, mesh):
    """A local shard (or an int8 dict of them) as DTensors under ``spec``
    on ``mesh``; unchanged without a mesh."""
    if mesh is None:
        return value
    if isinstance(value, dict):
        return {k: parallel.as_dtensor(value[k], spec[k], mesh)
                for k in value}
    if not value.is_contiguous():
        value = value.contiguous()
    return parallel.as_dtensor(value, spec, mesh)


# -- sharding -----------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree for :func:`init_params`'s tree: Megatron
    tensor parallelism over "tp" (heads and hidden on the output dim of
    the in-projections, the input dim of the out-projections: one
    all-reduce after wo and one after w2 per block), MoE experts over
    "ep" (moe_param_specs with the layer axis prepended), lm_head's vocab
    over "tp"."""
    layers = {
        "attn_norm": P(None, None),
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
        "ffn_norm": P(None, None),
    }
    if cfg.moe_experts > 0:
        layers.update({name: P(None, *spec)
                       for name, spec in moe_param_specs().items()})
    else:
        layers.update({
            "w1": P(None, None, "tp"),
            "w3": P(None, None, "tp"),
            "w2": P(None, "tp", None),
        })
    return {
        "embed": P(None, None),
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }


def batch_spec() -> P:
    return P("dp", None)


def quant_specs(specs: dict) -> dict:
    """The spec tree of quantized parameters: int8 shards like the weight,
    its per-output-channel scale like the weight's last dim (replicated
    where the weight is sharded on its input dim, whose reduction it is)."""
    out = {"embed": specs["embed"], "final_norm": specs["final_norm"],
           "lm_head": _qspec(specs["lm_head"]), "layers": {}}
    for name, spec in specs["layers"].items():
        quant = name in QUANT_KEYS and len(spec) == 3
        out["layers"][name] = _qspec(spec) if quant else spec
    return out


def _qspec(spec: P) -> dict:
    return {"int8": spec, "scale": P(*spec[:-2], None, spec[-1])}


# -- int8 weight quantization -------------------------------------------------

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def quantize_int8(params: dict) -> dict:
    """Per-output-channel symmetric int8 for the big matmul weights;
    norms and the embedding stay in their dtype, and so do the MoE
    expert stacks (4-D ``[L, E, ...]``, which the expert products take
    as they are) and the fp32 router ``wg``."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": _q(params["lm_head"]), "layers": {}}
    for name, w in params["layers"].items():
        quant = name in QUANT_KEYS and w.dim() == 3
        out["layers"][name] = _q(w) if quant else w
    return out


def _sym_int8(x: torch.Tensor, dim: int):
    """Symmetric int8 along ``dim``: (int8 values, fp32 scales with the
    reduced dim kept). Shared by the weights (per output channel,
    dim=-2) and the KV cache (per token and head, dim=-1)."""
    x32 = x.float()
    return _int8_with(x32, x32.abs().amax(dim=dim, keepdim=True))


def _int8_with(x32: torch.Tensor, amax: torch.Tensor):
    scale = (amax / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _q(w: torch.Tensor) -> dict:
    return _q_with(w, None)


def _q_with(w: torch.Tensor, amax: torch.Tensor | None) -> dict:
    """``_sym_int8`` of ``w`` over dim -2, layer by layer for a stack (the
    fp32 temporaries of one layer, not of all); ``amax``, when given, is
    the whole weight's maximum over dim -2, for a shard of it."""
    def one(x, a):
        if a is None:
            return _sym_int8(x, dim=-2)
        return _int8_with(x.float(), a)

    if w.dim() == 3:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((w.shape[0], 1, w.shape[2]), device=w.device)
        for i in range(w.shape[0]):
            q[i], scale[i] = one(w[i], None if amax is None else amax[i])
        return {"int8": q, "scale": scale}
    q, scale = one(w, amax)
    return {"int8": q, "scale": scale}


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Product with a plain weight, or with an int8 weight dequantized on
    the fly: (x @ int8.to(x.dtype)) * scale.to(x.dtype)."""
    if isinstance(w, dict):
        y = torch.matmul(x, w["int8"].to(x.dtype))
        return y * w["scale"].squeeze(-2).to(x.dtype)
    return torch.matmul(x, w)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters out of the stacked tree, or out of the
    per-layer list of a :func:`train_params` tree."""
    if isinstance(params["layers"], list):
        return params["layers"][i]
    return {n: ({"int8": w["int8"][i], "scale": w["scale"][i]}
                if isinstance(w, dict) else w[i])
            for n, w in params["layers"].items()}


# -- forward ------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * rms).to(x.dtype) * g


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions [B, S] (or [S]). Split-halves rotation
    with fp32 trig; the result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freqs = torch.pow(theta, exponent)
    angles = positions[..., None].float() * freqs
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _out_width(w) -> int:
    return (w["int8"] if isinstance(w, dict) else w).shape[-1]


def local_heads(params: dict, cfg: ModelConfig, mesh=None
                ) -> tuple[int, int]:
    """(query heads, kv heads) this rank computes (cfg's counts without
    tensor parallelism): see :func:`_head_plan`."""
    lay = params["layers"]
    lay = _layer(params, 0) if isinstance(lay, list) else \
        {n: lay[n] for n in ("wq", "wk")}
    plan = _head_plan(lay, cfg, mesh)
    return plan["q"][1] - plan["q"][0], plan["kv"][1] - plan["kv"][0]


def _head_plan(lp: dict, cfg: ModelConfig, mesh) -> dict:
    """Which heads this rank computes. Its wq shard holds the attention
    output columns [c0, c1) that its wo rows take; it computes the query
    heads "q" those columns lie in and the kv heads "kv" they read.
    "gather_q" / "gather_kv" say where its own shards do not hold exactly
    those heads ("tp" beyond n_heads or n_kv_heads splits a head's
    columns over ranks): it then gathers the weight's columns, and
    "cols" keeps its [c0, c1) of the heads' output for wo."""
    hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    r = parallel.axis_rank(mesh, "tp")
    w, wk = _out_width(lp["wq"]), _out_width(lp["wk"])
    c0, c1 = r * w, (r + 1) * w
    q = (c0 // hd, -(-c1 // hd))
    kv = (q[0] // G, (q[1] - 1) // G + 1)
    return {"q": q, "kv": kv, "cols": (c0 - q[0] * hd, c1 - q[0] * hd),
            "gather_q": c0 % hd != 0 or c1 % hd != 0,
            "gather_kv": (r * wk, (r + 1) * wk) != (kv[0] * hd, kv[1] * hd)}


def _gathered(w, mesh):
    if isinstance(w, dict):
        return {k: parallel.gather_last(v, mesh) for k, v in w.items()}
    return parallel.gather_last(w, mesh, sum_grads=True)


def _qkv(h: torch.Tensor, lp: dict, positions: torch.Tensor,
         cfg: ModelConfig, mesh=None):
    """Projections + RoPE shared by the cached and uncached layers, at
    the heads this rank computes (:func:`_head_plan`)."""
    B, T = h.shape[:2]
    hd = cfg.head_dim
    wq, wk, wv = lp["wq"], lp["wk"], lp["wv"]
    plan = None
    if parallel.axis_size(mesh, "tp") > 1:
        plan = _head_plan(lp, cfg, mesh)
        if plan["gather_q"]:
            wq = _gathered(wq, mesh)
        if plan["gather_kv"]:
            wk, wv = _gathered(wk, mesh), _gathered(wv, mesh)
    q = _matmul(h, wq).reshape(B, T, -1, hd)
    k = _matmul(h, wk).reshape(B, T, -1, hd)
    v = _matmul(h, wv).reshape(B, T, -1, hd)
    if plan is not None and plan["gather_q"]:
        q = q[:, :, plan["q"][0]:plan["q"][1]]
    if plan is not None and plan["gather_kv"]:
        k, v = (t[:, :, plan["kv"][0]:plan["kv"][1]] for t in (k, v))
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _attn_out(attn: torch.Tensor, lp: dict, cfg: ModelConfig, mesh):
    """The row-parallel wo over this rank's columns of the heads' output
    [B, T, heads * head_dim], all-reduced over "tp"."""
    if parallel.axis_size(mesh, "tp") > 1:
        plan = _head_plan(lp, cfg, mesh)
        if plan["gather_q"]:
            attn = attn[..., plan["cols"][0]:plan["cols"][1]]
    return parallel.reduce_from(_matmul(attn, lp["wo"]), mesh)


def _ffn_block(x: torch.Tensor, lp: dict, cfg: ModelConfig, mesh=None):
    """Residual + RMSNorm + FFN; returns ``(x, aux)``: the layer's MoE
    load-balance loss, or 0 for the dense SwiGLU. On a mesh, w1 and w3
    are column-parallel and w2 row-parallel over "tp"."""
    h = _rmsnorm(x, lp["ffn_norm"])
    if cfg.moe_experts > 0:
        y, aux = moe_ffn(lp, h, cfg.moe, mesh=mesh)
        return x + y, aux
    h = parallel.copy_to(h, mesh)
    gated = torch.nn.functional.silu(_matmul(h, lp["w1"])) \
        * _matmul(h, lp["w3"])
    return (x + parallel.reduce_from(_matmul(gated, lp["w2"]), mesh),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _flash_core(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Causal(+window) flash attention of [B, T, H, D] projections,
    GQA-native; returns [B, T, H*D]."""
    B, T = q.shape[:2]
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        window=cfg.attn_window)
    return o.transpose(1, 2).reshape(B, T, -1)


def decoder_layer(x: torch.Tensor, lp: dict, positions: torch.Tensor,
                  cfg: ModelConfig, mask: torch.Tensor | None = None,
                  mesh=None):
    """One transformer block: x [B, S, d] -> (x, aux). ``mask`` [S, S]
    overrides the causal mask on the einsum backend; the flash backend
    takes only the default causal mask and raises otherwise. ``lp`` holds
    plain tensors (a rank's shards on ``mesh``)."""
    B, S = x.shape[:2]
    hd = cfg.head_dim
    h = parallel.copy_to(_rmsnorm(x, lp["attn_norm"]), mesh)
    q, k, v = _qkv(h, lp, positions, cfg, mesh)
    if cfg.attn == "flash":
        if mask is not None:
            raise ValueError(
                "the flash backend supports only the default causal mask; "
                "use attn='einsum' for custom masks")
        attn = _flash_core(q, k, v, cfg)
    else:
        reps = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
        pos = torch.arange(S, device=x.device)
        if mask is None:
            mask = pos[None, :] <= pos[:, None]
        if cfg.attn_window is not None:
            mask = mask & sliding_window_mask(pos[:, None], pos[None, :],
                                              cfg.attn_window)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, -1)
    x = x + _attn_out(attn, lp, cfg, mesh)
    return _ffn_block(x, lp, cfg, mesh)


def _head(x: torch.Tensor, params: dict, mesh) -> torch.Tensor:
    """Final norm and lm_head: fp32 logits over the whole vocab (gathered
    from the "tp" ranks' vocab shards on a mesh)."""
    x = parallel.copy_to(_rmsnorm(x, params["final_norm"]), mesh)
    logits = _matmul(x, params["lm_head"]).float()
    return parallel.gather_last(logits, mesh)


def forward(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] fp32."""
    return forward_with_aux(params, tokens, cfg)[0]


def forward_with_aux(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens [B, S] -> (logits [B, S, vocab] fp32, aux: the mean of
    the layers' MoE load-balance losses; 0 for dense models). On a mesh
    the tokens are this rank's rows of the batch (its "dp" shard)."""
    params, mesh = parallel.localize(params)
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = decoder_layer(x, _layer(params, i), positions, cfg,
                               mesh=mesh)
        auxs.append(aux)
    return _head(x, params, mesh), torch.stack(auxs).mean()


# -- loss / train step --------------------------------------------------------

def train_params(params: dict) -> dict:
    """The trainable view of a stacked parameter tree, for either family
    (llama's, or ViT's from :mod:`tpushare_torch.workloads.vit`): the
    top-level tensors as leaves, in the tree's order, and "layers" as a
    list with one dict of leaves per layer. Every leaf is a detached view
    sharing the stacked tensors' storage and requires a gradient; the
    optimizer updates it in place, so the stacked tree (the one serving
    reads) sees every step. int8 weights do not train."""
    layers = params["layers"]
    if any(isinstance(w, dict)
           for w in (*params.values(), *layers.values()) if w is not layers):
        raise ValueError("int8 weights are not trainable; train the "
                         "model-dtype parameters and quantize after")

    def leaf(w):
        return w.detach().requires_grad_()

    def layer(w, i):
        """Layer i of a stack: a view; of a DTensor stack, a DTensor over
        the view of its local shard (the layer axis is never sharded)."""
        if not parallel.is_dtensor(w):
            return w[i]
        from torch.distributed.tensor import Shard
        pls = [Shard(p.dim - 1) if p.is_shard() else p for p in w.placements]
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(w.to_local()[i], w.device_mesh, pls,
                                  run_check=False)

    n_layers = next(iter(layers.values())).shape[0]
    per_layer = [{n: leaf(layer(w, i)) for n, w in layers.items()}
                 for i in range(n_layers)]
    return {k: per_layer if k == "layers" else leaf(w)
            for k, w in params.items()}


def named_leaves(params, prefix: str = ""):
    """(path, tensor) for every leaf of a trainable tree, depth first in
    insertion order (the optimizer's parameter order); paths join dict
    keys and list indices with dots, e.g. ``layers.3.wq``. The walk knows
    no family."""
    if isinstance(params, torch.Tensor):
        yield prefix, params
        return
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for key, value in items:
        yield from named_leaves(value, f"{prefix}.{key}" if prefix
                                else str(key))


def param_leaves(params) -> list:
    """The leaves of a trainable tree in :func:`named_leaves` order: for
    llama's embed, each layer's weights, final_norm, lm_head. One
    :class:`AdamW` serves both families."""
    return [w for _, w in named_leaves(params)]


def next_token_loss(logits: torch.Tensor, aux: torch.Tensor,
                    targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy of shifted logits against targets + weighted MoE aux
    (the reference's single definition of the training objective)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())
    return nll.mean() + cfg.moe_aux_weight * aux


def loss_fn(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            forward_fn=None) -> torch.Tensor:
    """Next-token cross-entropy over the shifted sequence (+ MoE aux).
    ``forward_fn(params, tokens, cfg) -> (logits, aux)`` defaults to
    :func:`forward_with_aux`."""
    logits, aux = (forward_fn or forward_with_aux)(params, tokens[:, :-1],
                                                   cfg)
    return next_token_loss(logits, aux, tokens[:, 1:], cfg)


class AdamW:
    """``optax.adamw(learning_rate)`` for the port: :meth:`init` plays
    ``tx.init`` and returns a ``torch.optim.AdamW`` over the leaves of a
    trainable tree (:func:`param_leaves`, either family) with optax's
    defaults: betas (0.9, 0.999),
    eps 1e-8 added outside the square root, decoupled weight decay 1e-4
    (torch's own default is 1e-2). The state takes the parameters' dtype,
    as optax's does. On CUDA it is the fused implementation, one pass over
    each tensor; on the CPU the single-tensor one. Neither allocates
    temporaries across all parameters at once, as the default
    multi-tensor path does."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: dict) -> torch.optim.AdamW:
        leaves = param_leaves(params)
        fused = leaves[0].device.type == "cuda"
        return torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4, fused=True if fused else None,
            foreach=None if fused else False)


def make_train_step(cfg: ModelConfig, learning_rate: float = 3e-4,
                    forward_fn=None):
    """Returns ``(tx, train_step)`` as the reference does:
    ``opt_state = tx.init(params)`` over a :func:`train_params` tree, then
    ``train_step(params, opt_state, tokens) -> (params, opt_state,
    loss)``. The step updates ``params`` and ``opt_state`` in place (and
    returns them, so callers port unchanged) and frees the gradients
    after the update, so they do not live through the next forward.

    Sharded (a tree of DTensors on a mesh): ``tokens`` are this rank's
    rows of the global batch (:func:`batch_spec`), the gradients are
    averaged over "dp" before the update (every leaf is replicated over
    "dp"), AdamW steps the local shards, and the loss returned is the
    global batch's mean, on every rank."""
    tx = AdamW(learning_rate)
    return tx, _sharded_step(
        lambda params, tokens: loss_fn(params, tokens, cfg,
                                       forward_fn=forward_fn))


def _sharded_step(loss_of):
    """The step shared by both families: ``loss_of(params, *batch)`` is
    this rank's loss over its rows of the batch. Traced, its spans
    ``train.bwd`` and ``train.update`` (the "dp" mean, the optimizer and
    ``zero_grad``) carry device times on a card."""
    def train_step(params, opt_state, *batch):
        loss = loss_of(params, *batch)
        cuda = loss.is_cuda
        with metrics.span("train.bwd", device=cuda):
            loss.backward()
        with metrics.span("train.update", device=cuda):
            mesh = parallel.mesh_of(params)
            parallel.dp_mean_grads(param_leaves(params), mesh)
            opt_state.step()
            opt_state.zero_grad(set_to_none=True)
        return params, opt_state, parallel.mean_over(loss.detach(), mesh)

    return train_step


# -- KV-cache forward (serving path) ------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  rolling: bool = False, device=None,
                  kv_heads: int | None = None) -> dict:
    """Zeroed per-layer K/V buffers ``[L, B, max_len, n_kv, head_dim]``;
    ``kv_heads`` is n_kv when given (a tp rank's share, see
    :func:`local_heads`), else ``cfg.n_kv_heads``.

    With ``cfg.kv_cache_dtype == "int8"`` the buffers hold int8 plus
    per-(token, kv head) fp32 scales "ks"/"vs" ``[L, B, max_len, n_kv,
    1]``. ``rolling=True`` (needs ``cfg.attn_window`` and ``max_len >=
    attn_window``) makes each buffer a ring over ``pos % max_len``; "pos"
    ``[max_len]`` records each slot's global position (-1 = never
    written) and the mask reads it.
    """
    shape = (cfg.n_layers, batch, max_len, kv_heads or cfg.n_kv_heads,
             cfg.head_dim)
    if rolling:
        if cfg.attn_window is None:
            raise ValueError("rolling cache requires cfg.attn_window")
        if max_len < cfg.attn_window:
            raise ValueError(
                f"rolling buffer {max_len} < window {cfg.attn_window}: "
                "overwritten slots would still be visible")
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.zeros(sshape, device=device),
                 "vs": torch.zeros(sshape, device=device)}
    else:
        cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if rolling:
        cache["pos"] = torch.full((max_len,), -1, dtype=torch.long,
                                  device=device)
    return cache


def _kv_quant(x: torch.Tensor):
    """[B, T, n_kv, hd] -> (int8 values, fp32 scales [B, T, n_kv, 1])."""
    return _sym_int8(x, dim=-1)


def forward_cached(params: dict, tokens: torch.Tensor, cache: dict,
                   pos_offset, cfg: ModelConfig,
                   prefill_from_zero: bool | None = None,
                   write_rows: torch.Tensor | None = None):
    """Incremental forward: attend the T new tokens against the KV cache.
    On a mesh (a DTensor tree) the cache holds this rank's kv heads
    (``init_kv_cache(..., kv_heads=local_heads(params, cfg)[1])``).

    tokens [B, T] occupy positions ``pos_offset .. pos_offset+T-1``.
    ``pos_offset`` is an int shared by every row, or a tensor [B] with
    each row's own offset (the engine's slots, which the reference maps
    with vmap). Their K/V are written into ``cache`` IN PLACE (the port
    updates the buffers instead of copying them), then attention runs
    over the whole buffer under a causal position mask. Returns
    ``(logits [B, T, vocab] fp32, cache)``.

    A cache with "pos" is a ring (:func:`init_kv_cache` ``rolling=True``):
    writes land at ``pos % M`` and the mask reads each slot's recorded
    global position. "pos" is ``[M]`` for rows in lockstep or ``[B, M]``
    for rows with their own offsets. Chunk contract: T <= M, and
    T <= M - (W-1) unless the chunk prefills from global position 0.

    ``prefill_from_zero``: a prefill from position 0 with
    ``cfg.attn == "flash"`` runs the flash kernel over the chunk itself
    instead of the T x M einsum; it then attends the pre-quantisation
    k/v (an int8 cache still stores int8). None infers it from an int
    ``pos_offset == 0``; a tensor offset never infers it.

    ``write_rows`` [B] bool: rows where False leave the cache (and ring
    positions) untouched; their logits are computed and meaningless.
    """
    params, mesh = parallel.localize(params)
    B, T = tokens.shape
    hd = cfg.head_dim
    nh, nkv = local_heads(params, cfg, mesh)
    reps = nh // nkv
    dev = tokens.device
    M = cache["k"].shape[2]
    rolling = "pos" in cache
    per_row = isinstance(pos_offset, torch.Tensor)
    if rolling:
        if T > M:
            raise ValueError(f"rolling cache: chunk {T} > buffer {M}")
        W = cfg.attn_window
        if (W is not None and T > M - (W - 1) and not per_row
                and int(pos_offset) != 0):
            raise ValueError(
                f"rolling cache: chunk T={T} > M-(W-1)={M - (W - 1)} "
                f"overwrites keys still inside an in-chunk query's window "
                f"mid-stream; chunk by <= {M - (W - 1)} (or prefill from "
                f"pos_offset=0 with T <= M)")
        if per_row != (cache["pos"].dim() == 2):
            raise ValueError("a [B, M] ring watermark needs per-row "
                             "offsets, an [M] one a shared offset")
    elif not per_row and not 0 <= int(pos_offset) <= M - T:
        raise ValueError(f"chunk at {int(pos_offset)}..{int(pos_offset) + T}"
                         f" outside the {M}-slot cache")

    x = params["embed"][tokens]
    steps = torch.arange(T, device=dev)
    if per_row:
        q_pos = pos_offset.to(dev).long()[:, None] + steps    # [B, T]
        positions = q_pos
    else:
        q_pos = int(pos_offset) + steps                         # [T]
        positions = q_pos.expand(B, T)

    # where this step's K/V land: rows/cols index [B, T] pairs for
    # scatters; None means a contiguous slice write at pos_offset
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    if rolling:
        cols = (q_pos % M).expand(B, T)
        old_pos = cache["pos"]
        new_pos = old_pos.clone()
        if per_row:
            new_pos.scatter_(1, cols, q_pos)
            if write_rows is not None:
                new_pos = torch.where(write_rows[:, None], new_pos, old_pos)
        else:
            new_pos[cols[0]] = q_pos
        key_pos = new_pos if per_row else new_pos[None]         # [B|1, M]
        q_b = q_pos if per_row else q_pos[None]                 # [B|1, T]
        mask = (key_pos[:, None, :] >= 0) & \
            (key_pos[:, None, :] <= q_b[:, :, None])
        mask = mask & sliding_window_mask(q_b[:, :, None],
                                          key_pos[:, None, :],
                                          cfg.attn_window)
    else:
        new_pos = None
        cols = q_pos.expand(B, T) if (per_row or write_rows is not None) \
            else None
        key_pos = torch.arange(M, device=dev)
        q_b = q_pos if per_row else q_pos[None]
        mask = key_pos[None, None, :] <= q_b[:, :, None]        # [B|1, T, M]
        if cfg.attn_window is not None:
            mask = mask & sliding_window_mask(q_b[:, :, None],
                                              key_pos[None, None, :],
                                              cfg.attn_window)

    def write(buf, new):
        new = new.to(buf.dtype)
        if cols is None:
            off = int(pos_offset)
            buf[:, off:off + T] = new
            return
        if write_rows is not None:
            keep = write_rows.view(B, *([1] * (new.dim() - 1)))
            new = torch.where(keep, new, buf[rows, cols])
        buf[rows, cols] = new

    if prefill_from_zero is None:
        prefill_from_zero = not per_row and int(pos_offset) == 0
    flash_prefill = (cfg.attn == "flash" and T > 1 and not rolling
                     and prefill_from_zero)
    int8_cache = cfg.kv_cache_dtype == "int8"
    # [B|1, 1, 1, T, M] against scores [B, g, r, T, M]
    score_mask = mask[:, None, None]

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = parallel.copy_to(_rmsnorm(x, lp["attn_norm"]), mesh)
        q, k, v = _qkv(h, lp, positions, cfg, mesh)
        ck, cv = cache["k"][i], cache["v"][i]
        if int8_cache:
            kq8, ks = _kv_quant(k)
            vq8, vs = _kv_quant(v)
            write(ck, kq8)
            write(cv, vq8)
            write(cache["ks"][i], ks)
            write(cache["vs"][i], vs)
        else:
            write(ck, k)
            write(cv, v)
        if flash_prefill:
            attn_flat = _flash_core(q, k, v, cfg)
        else:
            if int8_cache:
                # the per-key scales factor out of both contractions and
                # apply to the [.., M] scores and probabilities instead
                kd, vd = ck.to(x.dtype), cv.to(x.dtype)
                ks_t = cache["ks"][i][..., 0].transpose(1, 2)   # [B,nkv,M]
                vs_t = cache["vs"][i][..., 0].transpose(1, 2)
            else:
                kd, vd = ck, cv
            # grouped-query attention against the buffer without
            # expanding the cache: g = kv head, r = queries per group
            qg = q.reshape(B, T, nkv, reps, hd)
            scores = torch.einsum("btgrd,bmgd->bgrtm", qg, kd).float()
            if int8_cache:
                scores = scores * ks_t[:, :, None, None, :]
            scores = scores * (hd ** -0.5)
            scores = scores.masked_fill(~score_mask, float("-inf"))
            probs = torch.softmax(scores, dim=-1)
            if int8_cache:
                probs = probs * vs_t[:, :, None, None, :]
            probs = probs.to(x.dtype)
            attn = torch.einsum("bgrtm,bmgd->btgrd", probs, vd)
            attn_flat = attn.reshape(B, T, nh * hd)
        x = x + _attn_out(attn_flat, lp, cfg, mesh)
        # aux only matters in training
        x, _aux = _ffn_block(x, lp, cfg, mesh)
    if rolling:
        cache["pos"].copy_(new_pos)
    return _head(x, params, mesh), cache


def greedy_decode_kv(params: dict, prompt: torch.Tensor, steps: int,
                     cfg: ModelConfig, rolling: bool = False) -> torch.Tensor:
    """KV-cached greedy decoding: one prefill over the prompt, then one
    single-token :func:`forward_cached` per generated token. Returns
    ``[B, S + steps]``. ``rolling=True`` (needs ``cfg.attn_window``)
    serves from a ring of ``2 x attn_window`` slots (capped at the
    sequence length, never below the window), prefilling the whole prompt
    in window-sized chunks."""
    B, S = prompt.shape
    dev = prompt.device
    local, mesh = parallel.localize(params)
    kv_heads = local_heads(local, cfg, mesh)[1]
    total = S + steps
    buf = torch.zeros((B, total), dtype=torch.long, device=dev)
    buf[:, :S] = prompt
    if steps <= 0:
        return buf
    if rolling:
        if cfg.attn_window is None:
            raise ValueError("rolling decode requires cfg.attn_window")
        W = cfg.attn_window
        cache = init_kv_cache(cfg, B, max(min(2 * W, total), W),
                              rolling=True, device=dev, kv_heads=kv_heads)
        for off in range(0, S, W):
            logits, cache = forward_cached(
                params, prompt[:, off:off + W], cache, off, cfg)
    else:
        cache = init_kv_cache(cfg, B, total, device=dev, kv_heads=kv_heads)
        logits, cache = forward_cached(params, prompt, cache, 0, cfg,
                                       prefill_from_zero=True)
    tok = logits[:, -1].argmax(dim=-1)
    buf[:, S] = tok
    for i in range(1, steps):
        logits, cache = forward_cached(params, tok[:, None], cache,
                                       S + i - 1, cfg)
        tok = logits[:, -1].argmax(dim=-1)
        buf[:, S + i] = tok
    return buf


def greedy_decode(params: dict, prompt: torch.Tensor, steps: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Greedy decoding WITHOUT a KV cache: the fixed-shape buffer is
    extended by ``steps`` positions and refilled one token per
    iteration, recomputing the prefix each step (the behavioural spec
    for :func:`greedy_decode_kv`)."""
    B, S = prompt.shape
    buf = torch.zeros((B, S + steps), dtype=torch.long, device=prompt.device)
    buf[:, :S] = prompt
    for i in range(steps):
        logits = forward(params, buf, cfg)
        buf[:, S + i] = logits[:, S + i - 1].argmax(dim=-1)
    return buf
