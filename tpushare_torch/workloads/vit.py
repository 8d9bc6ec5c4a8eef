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

The sharded layout (``vit_param_specs``) waits for the port's sharded
slice (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpushare_torch.workloads.attention import (
    attention_reference, flash_attention)
from tpushare_torch.workloads.model import AdamW, _layer


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

def init_vit_params(cfg: ViTConfig, generator: torch.Generator) -> dict:
    """Stacked-layer parameters (leading axis = layer) drawn from
    ``generator`` on its device: weights N(0, 1/fan_in) in fp32 cast to
    cfg.dtype, the position embedding N(0, 0.02^2) in fp32, norms fp32
    (scale one, bias zero), the [CLS] token zero. Draw order: patch
    embedding, position embedding, wq, wk, wv, wo, w1, w2, head."""
    cfg.validate()
    dev = generator.device
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    pdim = cfg.patch * cfg.patch * cfg.channels

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32)

    def w(*shape, fan_in):
        return normal(*shape).mul_(fan_in ** -0.5).to(cfg.dtype)

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    patch_embed = w(pdim, d, fan_in=pdim)
    pos_embed = normal(1, cfg.seq, d).mul_(0.02)
    wq, wk, wv, wo = (w(L, d, d, fan_in=d) for _ in range(4))
    w1 = w(L, d, f, fan_in=d)
    w2 = w(L, f, d, fan_in=f)
    return {
        "patch_embed": patch_embed,
        "cls_token": torch.zeros((1, 1, d), dtype=cfg.dtype, device=dev),
        "pos_embed": pos_embed,
        "layers": {"ln1": f32(1.0, L, d), "ln1_b": f32(0.0, L, d),
                   "wq": wq, "wk": wk, "wv": wv, "wo": wo,
                   "ln2": f32(1.0, L, d), "ln2_b": f32(0.0, L, d),
                   "w1": w1, "w2": w2},
        "final_ln": f32(1.0, d),
        "final_ln_b": f32(0.0, d),
        "head": w(d, cfg.classes, fan_in=d),
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
    stacked tree or its ``model.train_params`` view."""
    B = images.shape[0]
    nh, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model

    x = patchify(images.to(cfg.dtype), cfg) @ params["patch_embed"]
    cls = params["cls_token"].expand(B, 1, d)
    x = torch.cat([cls, x], dim=1)
    x = (x.float() + params["pos_embed"]).to(cfg.dtype)
    S = x.shape[1]

    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _layernorm(x, lp["ln1"], lp["ln1_b"])
        # [B, S, H, D] projections, handed over as [B, H, S, D] views
        q = (h @ lp["wq"]).reshape(B, S, nh, hd).transpose(1, 2)
        k = (h @ lp["wk"]).reshape(B, S, nh, hd).transpose(1, 2)
        v = (h @ lp["wv"]).reshape(B, S, nh, hd).transpose(1, 2)
        if cfg.attn == "flash":
            o = flash_attention(q, k, v, causal=False)
        else:
            o = attention_reference(q, k, v, causal=False)
        o = o.transpose(1, 2).reshape(B, S, d)
        x = x + o @ lp["wo"]
        h = _layernorm(x, lp["ln2"], lp["ln2_b"])
        x = x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]
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
    defaults, learning rate 1e-3 as in the reference)."""
    tx = AdamW(learning_rate)

    def train_step(params, opt_state, images, labels):
        loss = classification_loss(vit_forward(params, images, cfg), labels)
        loss.backward()
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss.detach()

    return tx, train_step
