"""Vision Transformer encoder in PyTorch: the port of
``tpushare/workloads/vit.py``, the repo's second workload family.

Same presets, parameter layout and numerics as the reference:
- the patch embedding is one matmul over :func:`patchify`'s
  ``[B, N, p*p*C]`` patches (a stride-p conv over non-overlapping patches
  is exactly that), in the reference's ``(gh, gw, p, p, C)`` order;
- the [CLS] token is concatenated first and the fp32 position embedding
  is added in fp32, then cast to the activation dtype;
- pre-LN blocks with fp32 LayerNorm (eps 1e-6), non-causal multi-head
  attention (the GQA contract's H_kv == H case) through
  :func:`~tpushare_torch.workloads.attention.flash_attention` (K1, or K4
  under ``TPUSHARE_FLASH_FWD=pipelined``, on the card) or the einsum
  :func:`~tpushare_torch.workloads.attention.attention_reference`, and a
  tanh-approximated GELU MLP (``jax.nn.gelu``'s default; torch's default
  is the exact erf form);
- the head reads the [CLS] row and returns fp32 logits.

Parameters are plain dicts of tensors with the layers stacked on a
leading axis, as in the reference, so weights carry across with
:func:`tpushare_torch.workloads.convert.params_from_numpy`. Training
reads them through :func:`tpushare_torch.workloads.model.train_params`
(one leaf per layer and weight, views into the stacked tensors), as the
llama trainer does.

Sharded: :func:`vit_param_specs` is the reference's Megatron layout
over "tp" (images over "dp" at the call site); ``init_vit_params(cfg,
gen, mesh=...)`` draws the same weights and keeps each rank's shard as a
DTensor, and :func:`vit_forward` adds one all-reduce after wo and one
after w2 per block (:mod:`tpushare_torch.workloads.parallel`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpushare_torch.workloads import parallel
from tpushare_torch.workloads.attention import (
    attention_reference, flash_attention)
from tpushare_torch.workloads.model import AdamW, _layer, _sharded_step
from tpushare_torch.workloads.parallel import P


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image: int = 224
    patch: int = 16
    channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    classes: int = 1000
    dtype: Any = torch.bfloat16
    attn: str = "einsum"  # or "flash" (the CUDA kernels, causal=False)

    @property
    def n_patches(self) -> int:
        return (self.image // self.patch) ** 2

    @property
    def seq(self) -> int:
        return self.n_patches + 1  # + [CLS]

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def validate(self) -> "ViTConfig":
        if self.image % self.patch:
            raise ValueError(f"image {self.image} is not a multiple of "
                             f"patch {self.patch}")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} / n_heads "
                             f"{self.n_heads} do not divide")
        if self.attn not in ("einsum", "flash"):
            raise ValueError(f"attn {self.attn!r}")
        return self


PRESETS_VIT = {
    # ViT-B/16 geometry (the encoder fine-tune tenant of samples/7-vit.yaml)
    "vit-b16": ViTConfig(),
    # small config for tests and CPU runs
    "vit-tiny": ViTConfig(image=32, patch=8, d_model=64, n_layers=2,
                          n_heads=4, d_ff=128, classes=10),
}

def vit_param_specs(cfg: ViTConfig) -> dict:
    """The reference's Megatron tp layout (cf. ``model.param_specs``: one
    all-reduce after wo and one after w2 per block); the batch shards
    over "dp" at the call site."""
    return {
        "patch_embed": P(None, None),
        "cls_token": P(None, None, None),
        "pos_embed": P(None, None, None),
        "layers": {
            "ln1": P(None, None), "ln1_b": P(None, None),
            "wq": P(None, None, "tp"), "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"), "wo": P(None, "tp", None),
            "ln2": P(None, None), "ln2_b": P(None, None),
            "w1": P(None, None, "tp"), "w2": P(None, "tp", None),
        },
        "final_ln": P(None), "final_ln_b": P(None),
        "head": P(None, None),
    }


def init_vit_params(cfg: ViTConfig, generator: torch.Generator | None,
                    mesh=None, device=None) -> dict:
    """Stacked-layer parameters (leading axis = layer) drawn from
    ``generator`` on its device: weights N(0, 1/fan_in) in fp32 cast to
    cfg.dtype, the position embedding N(0, 0.02^2) in fp32, norms fp32
    (scale one, bias zero), the [CLS] token zero. Draw order: patch
    embedding, position embedding, wq, wk, wv, wo, w1, w2, head. With a
    ``mesh`` each rank keeps its shard under :func:`vit_param_specs` as
    DTensors; ``generator`` None allocates on ``device`` without
    drawing."""
    cfg.validate()
    dev = generator.device if generator is not None else torch.device(
        device or "cpu")
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    pdim = cfg.patch * cfg.patch * cfg.channels
    specs = vit_param_specs(cfg)

    def spec(path):
        return specs[path] if path in specs else specs["layers"][path]

    def wrap(path, t):
        if mesh is None:
            return t
        return parallel.as_dtensor(t, spec(path), mesh)

    def normal(path, *shape, mult, dtype):
        own, _ = parallel.draw(shape, generator, mult, dtype,
                               spec(path) if mesh is not None else None,
                               mesh, device=dev)
        return wrap(path, own)

    def w(path, *shape, fan_in):
        return normal(path, *shape, mult=fan_in ** -0.5, dtype=cfg.dtype)

    def full(path, fill, *shape, dtype=torch.float32):
        t = torch.full(shape, fill, dtype=dtype, device=dev)
        return wrap(path, t)

    patch_embed = w("patch_embed", pdim, d, fan_in=pdim)
    pos_embed = normal("pos_embed", 1, cfg.seq, d, mult=0.02,
                       dtype=torch.float32)
    wq, wk, wv, wo = (w(n, L, d, d, fan_in=d)
                      for n in ("wq", "wk", "wv", "wo"))
    w1 = w("w1", L, d, f, fan_in=d)
    w2 = w("w2", L, f, d, fan_in=f)
    return {
        "patch_embed": patch_embed,
        "cls_token": full("cls_token", 0.0, 1, 1, d, dtype=cfg.dtype),
        "pos_embed": pos_embed,
        "layers": {"ln1": full("ln1", 1.0, L, d),
                   "ln1_b": full("ln1_b", 0.0, L, d),
                   "wq": wq, "wk": wk, "wv": wv, "wo": wo,
                   "ln2": full("ln2", 1.0, L, d),
                   "ln2_b": full("ln2_b", 0.0, L, d),
                   "w1": w1, "w2": w2},
        "final_ln": full("final_ln", 1.0, d),
        "final_ln_b": full("final_ln_b", 0.0, d),
        "head": w("head", d, cfg.classes, fan_in=d),
    }


def _layernorm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (eps 1e-6, fp32 scale and
    bias), cast back to x's dtype. ``F.layer_norm`` keeps only its fp32
    input and two per-row statistics for the backward, where the
    reference's written-out form would keep two more fp32 activations a
    norm, which the ViT-B/16 trainer cannot spare under its 4 GiB grant."""
    xf = x.float()
    return F.layer_norm(xf, (xf.shape[-1],), g, b, eps=1e-6).to(x.dtype)


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, p*p*C]: the reshape a stride-p conv is."""
    B, H, W, C = images.shape
    p = cfg.patch
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, gh, gw, p, p, C]
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def vit_forward(params: dict, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] images -> [B, classes] fp32 logits. ``params`` is a
    stacked tree or its ``model.train_params`` view; on a mesh (a DTensor
    tree) the images are this rank's rows of the batch and each rank
    computes its heads and its share of the MLP."""
    params, mesh = parallel.localize(params)
    B = images.shape[0]
    hd, d = cfg.head_dim, cfg.d_model

    x = patchify(images.to(cfg.dtype), cfg) @ params["patch_embed"]
    cls = params["cls_token"].expand(B, 1, d)
    x = torch.cat([cls, x], dim=1)
    x = (x.float() + params["pos_embed"]).to(cfg.dtype)
    S = x.shape[1]

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = parallel.copy_to(_layernorm(x, lp["ln1"], lp["ln1_b"]), mesh)
        # [B, S, H, D] projections (this rank's heads), handed over as
        # [B, H, S, D] views
        q = (h @ lp["wq"]).reshape(B, S, -1, hd).transpose(1, 2)
        k = (h @ lp["wk"]).reshape(B, S, -1, hd).transpose(1, 2)
        v = (h @ lp["wv"]).reshape(B, S, -1, hd).transpose(1, 2)
        if cfg.attn == "flash":
            o = flash_attention(q, k, v, causal=False)
        else:
            o = attention_reference(q, k, v, causal=False)
        o = o.transpose(1, 2).reshape(B, S, -1)
        x = x + parallel.reduce_from(o @ lp["wo"], mesh)
        h = parallel.copy_to(_layernorm(x, lp["ln2"], lp["ln2_b"]), mesh)
        x = x + parallel.reduce_from(
            F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"], mesh)
    x = _layernorm(x, params["final_ln"], params["final_ln_b"])
    return (x[:, 0] @ params["head"]).float()  # [CLS] head


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def make_vit_train_step(cfg: ViTConfig, learning_rate: float = 1e-3):
    """``(tx, train_step)`` for classification, the contract of
    :func:`tpushare_torch.workloads.model.make_train_step`:
    ``opt_state = tx.init(params)`` over a ``model.train_params`` tree, then
    ``train_step(params, opt_state, images, labels) -> (params,
    opt_state, loss)``, updating in place and freeing the gradients
    after the update. ``tx`` is the port's ``optax.adamw`` (optax's
    defaults, learning rate 1e-3 as in the reference). Sharded, as
    ``model.make_train_step``: this rank's rows of the batch, gradients
    averaged over "dp", the global batch's loss returned."""
    tx = AdamW(learning_rate)
    return tx, _sharded_step(
        lambda params, images, labels: classification_loss(
            vit_forward(params, images, cfg), labels))
