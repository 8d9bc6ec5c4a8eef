"""Llama-style decoder-only transformer in PyTorch: the port's model.

Counterpart of ``tpushare/workloads/model.py`` (dense presets, forward and
the KV-cached serving path; training comes with ROADMAP.md Queue 1
item 9). Parameters are the reference's layout as plain dicts of tensors:
``{"embed", "layers": {name: [L, ...]}, "final_norm", "lm_head"}``, with
int8 weights as ``{"int8": int8 tensor, "scale": fp32 tensor}``, so
weights carry across from the JAX package with
:func:`tpushare_torch.workloads.convert.params_from_numpy`.

Numerics follow the reference where it fixes them: RMSNorm and RoPE trig
in fp32, attention scores out of the product in the activation dtype and
then cast to fp32, probabilities cast to the activation dtype before the
PV product, int8 weights cast to the activation dtype with the scale
applied after the product.

Device: everything runs where the parameters are; :func:`init_params`
makes them on its generator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tpushare_torch.workloads.attention import (
    flash_attention, sliding_window_mask)


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
    # mixture-of-experts FFN: not ported yet (ROADMAP.md Queue 1 item 13)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

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


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE presets are not ported yet (ROADMAP.md Queue 1 item 13: "
            "expert parallel)")


# -- init ---------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Stacked-layer parameters (leading axis = layer), drawn from
    ``generator`` on its device: N(0, 1/fan_in) in fp32, cast to
    cfg.dtype, norms at one. Draw order: embed, attention, FFN,
    lm_head."""
    cfg.validate()
    _dense_only(cfg)
    dev = generator.device
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def w(*shape, fan_in):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(fan_in ** -0.5).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    embed = w(v, d, fan_in=d)
    layers = {
        "attn_norm": ones(L, d),
        "wq": w(L, d, nh * hd, fan_in=d),
        "wk": w(L, d, nkv * hd, fan_in=d),
        "wv": w(L, d, nkv * hd, fan_in=d),
        "wo": w(L, nh * hd, d, fan_in=nh * hd),
        "ffn_norm": ones(L, d),
        "w1": w(L, d, f, fan_in=d),
        "w3": w(L, d, f, fan_in=d),
        "w2": w(L, f, d, fan_in=f),
    }
    return {"embed": embed, "layers": layers, "final_norm": ones(d),
            "lm_head": w(d, v, fan_in=d)}


# -- int8 weight quantization -------------------------------------------------

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def quantize_int8(params: dict) -> dict:
    """Per-output-channel symmetric int8 for the big matmul weights;
    norms and the embedding stay in their dtype."""
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
    scale = (x32.abs().amax(dim=dim, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _q(w: torch.Tensor) -> dict:
    if w.dim() == 3:
        # layer by layer: the fp32 temporaries of one layer, not of all
        parts = [_sym_int8(w[i], dim=-2) for i in range(w.shape[0])]
        return {"int8": torch.stack([p[0] for p in parts]),
                "scale": torch.stack([p[1] for p in parts])}
    q, scale = _sym_int8(w, dim=-2)
    return {"int8": q, "scale": scale}


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Product with a plain weight, or with an int8 weight dequantized on
    the fly: (x @ int8.to(x.dtype)) * scale.to(x.dtype)."""
    if isinstance(w, dict):
        y = torch.matmul(x, w["int8"].to(x.dtype))
        return y * w["scale"].squeeze(-2).to(x.dtype)
    return torch.matmul(x, w)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters out of the stacked tree."""
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


def _qkv(h: torch.Tensor, lp: dict, positions: torch.Tensor,
         cfg: ModelConfig):
    """Projections + RoPE shared by the cached and uncached layers."""
    B, T = h.shape[:2]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = _matmul(h, lp["wq"]).reshape(B, T, nh, hd)
    k = _matmul(h, lp["wk"]).reshape(B, T, nkv, hd)
    v = _matmul(h, lp["wv"]).reshape(B, T, nkv, hd)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _ffn_block(x: torch.Tensor, lp: dict, cfg: ModelConfig):
    """Residual + RMSNorm + SwiGLU FFN; returns ``(x, aux)`` with the
    dense aux term 0."""
    h = _rmsnorm(x, lp["ffn_norm"])
    gated = torch.nn.functional.silu(_matmul(h, lp["w1"])) \
        * _matmul(h, lp["w3"])
    return (x + _matmul(gated, lp["w2"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _flash_core(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Causal(+window) flash attention of [B, T, H, D] projections,
    GQA-native; returns [B, T, H*D]."""
    B, T = q.shape[:2]
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        window=cfg.attn_window)
    return o.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.head_dim)


def decoder_layer(x: torch.Tensor, lp: dict, positions: torch.Tensor,
                  cfg: ModelConfig, mask: torch.Tensor | None = None):
    """One transformer block: x [B, S, d] -> (x, aux). ``mask`` [S, S]
    overrides the causal mask on the einsum backend; the flash backend
    takes only the default causal mask and raises otherwise."""
    B, S = x.shape[:2]
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = _rmsnorm(x, lp["attn_norm"])
    q, k, v = _qkv(h, lp, positions, cfg)
    if cfg.attn == "flash":
        if mask is not None:
            raise ValueError(
                "the flash backend supports only the default causal mask; "
                "use attn='einsum' for custom masks")
        attn = _flash_core(q, k, v, cfg)
    else:
        reps = nh // nkv
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
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            B, S, nh * hd)
    x = x + _matmul(attn, lp["wo"])
    return _ffn_block(x, lp, cfg)


def forward(params: dict, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] fp32."""
    return forward_with_aux(params, tokens, cfg)[0]


def forward_with_aux(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens [B, S] -> (logits [B, S, vocab] fp32, aux loss scalar; 0
    for dense models)."""
    _dense_only(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = decoder_layer(x, _layer(params, i), positions, cfg)
        auxs.append(aux)
    x = _rmsnorm(x, params["final_norm"])
    logits = _matmul(x, params["lm_head"]).float()
    return logits, torch.stack(auxs).mean()


# -- KV-cache forward (serving path) ------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  rolling: bool = False, device=None) -> dict:
    """Zeroed per-layer K/V buffers ``[L, B, max_len, n_kv, head_dim]``.

    With ``cfg.kv_cache_dtype == "int8"`` the buffers hold int8 plus
    per-(token, kv head) fp32 scales "ks"/"vs" ``[L, B, max_len, n_kv,
    1]``. ``rolling=True`` (needs ``cfg.attn_window`` and ``max_len >=
    attn_window``) makes each buffer a ring over ``pos % max_len``; "pos"
    ``[max_len]`` records each slot's global position (-1 = never
    written) and the mask reads it.
    """
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
    B, T = tokens.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
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
        h = _rmsnorm(x, lp["attn_norm"])
        q, k, v = _qkv(h, lp, positions, cfg)
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
        x = x + _matmul(attn_flat, lp["wo"])
        x, _aux = _ffn_block(x, lp, cfg)
    if rolling:
        cache["pos"].copy_(new_pos)
    x = _rmsnorm(x, params["final_norm"])
    logits = _matmul(x, params["lm_head"]).float()
    return logits, cache


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
                              rolling=True, device=dev)
        for off in range(0, S, W):
            logits, cache = forward_cached(
                params, prompt[:, off:off + W], cache, off, cfg)
    else:
        cache = init_kv_cache(cfg, B, total, device=dev)
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
